// K8 tile body: the AOB PCM byte de-swizzle and sign extension, as
// 16-byte output vectors built from a staged tile of chunks.
//
// A chunk holds two PCM frames of ``ch`` channels in the byte order of the
// reference's AOB_BYTE_SWAP tables (pcm.c:103-138).  The host inverts that
// scatter once into a gather table (dvda_tpu.codecs.pcm.pcm_gather_indices):
// ``table[s*3 + b]`` is the chunk byte that holds byte ``b`` (0 = LSB) of
// sample slot ``s`` (frame ``s / ch``, channel ``s % ch``), or -1 for a zero
// byte (the 16-bit path's absent third byte, the 20-bit path's unwritten
// positions).  16-bit slots take two bytes and sign-extend at bit 15; 20-
// and 24-bit slots take three and sign-extend at bit 23 (pcm.c:56-62,
// 171-193).
//
//   chunks  uint8 [n, csize]            csize = (bps / 8) * ch * 2
//   out     nbytes 0: int32 [n * slots] ([2n, ch] in frame order)
//           nbytes 2|3: uint8 [n * slots * nbytes], the little-endian WAV
//           payload of the slot values
//
// Every output byte is a chunk byte, zero, or the sign fill (0x00 or 0xFF)
// of its sample's top source byte: byte j < nsrc of a sample is
// table[s*3 + j] (or zero), byte j >= nsrc (the int32 form's high bytes,
// a 16-bit sample's third WAV byte) the fill of byte nsrc - 1.  Over P
// chunks, P = 16 / gcd(16, slots * ob), the output is a whole number V of
// 16-byte vectors, and vector v of the output draws on the P chunks of its
// period v / V alone, by the same byte sources for every period.  So a
// thread that always builds vectors at the same position v % V keeps its
// 16 sources in registers (pcm_vector_sources) and builds each vector with
// 16 byte loads from the staged tile (pcm_vector).  A tile of
// DVDA_PCM_TILE chunks (a multiple of 16) is a whole number of 16-byte
// vectors in and out, and of periods.
//
// Offsets are int64: a 74-minute 2.0/192k/24 track is past 2^31 bytes.
#pragma once

#include "dvda_hd.cuh"

//: most sample slots per chunk (2 frames x 6 channels)
#define DVDA_PCM_MAX_SLOTS 12
//: most bytes per chunk (24-bit, 6 channels)
#define DVDA_PCM_MAX_CSIZE 36
//: chunks per tile
#define DVDA_PCM_TILE 256
//: bytes a staged tile takes (a ragged tile's vectors read no further)
#define DVDA_PCM_TILE_BYTES (DVDA_PCM_TILE * DVDA_PCM_MAX_CSIZE)

struct DvdaPcmTable {
  int32_t idx[DVDA_PCM_MAX_SLOTS * 3];
};

// One configuration's vector geometry.
struct DvdaPcmGeom {
  int slots;      // sample slots a chunk
  int csize;      // bytes a chunk
  int ob;         // output bytes a sample: nbytes, or 4 for int32
  int nsrc;       // source bytes a sample: 2 (16-bit) or 3
  int period_in;  // chunk bytes a period (P * csize, at most 240)
  int period_v;   // output vectors a period (V)
};

DVDA_HD DvdaPcmGeom pcm_geom(int csize, int channels, int bits, int nbytes) {
  DvdaPcmGeom g;
  g.slots = 2 * channels;
  g.csize = csize;
  g.ob = nbytes ? nbytes : 4;
  g.nsrc = bits == 16 ? 2 : 3;
  const int x = g.slots * g.ob;
  const int low = x & -x;  // gcd(16, x): x is even, at most 48
  const int P = 16 / (low < 16 ? low : 16);
  g.period_in = P * csize;
  g.period_v = P * x / 16;
  return g;
}

// The byte sources of vector position pv (0 <= pv < period_v): byte
// 4w + b of the vector is input byte (off[w] >> 8b) & 0xFF of the period,
// taken as it is where byte b of keep[w] is 0xFF, as its sign fill where
// byte b of sign[w] is, and zero where neither is.
struct DvdaPcmVec {
  uint32_t off[4], keep[4], sign[4];
};

DVDA_HD DvdaPcmVec pcm_vector_sources(const DvdaPcmGeom& g,
                                      const DvdaPcmTable& table, int pv) {
  DvdaPcmVec v = {{0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
  for (int k = 0; k < 16; ++k) {  // unrolled: v stays in registers
    const int e = pv * 16 + k;
    const int i = e / g.ob, j = e - i * g.ob;
    const int c = i / g.slots, s = i - c * g.slots;
    const bool fill = j >= g.nsrc;
    const int t = table.idx[s * 3 + (fill ? g.nsrc - 1 : j)];
    if (t < 0) continue;  // a zero byte (or the fill of one)
    const int sh = 8 * (k & 3);
    v.off[k >> 2] |= (uint32_t)(c * g.csize + t) << sh;
    if (fill)
      v.sign[k >> 2] |= 0xFFu << sh;
    else
      v.keep[k >> 2] |= 0xFFu << sh;
  }
  return v;
}

// The 16 output bytes of a vector whose period's chunks start at ``in``:
// per word, 4 byte loads, the word they make, its bytes' sign fills (each
// byte's top bit times 0xFF), and the two masks.
DVDA_HD DvdaWords4 pcm_vector(const uint8_t* in, const DvdaPcmVec& v) {
  DvdaWords4 r;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t o = v.off[w];
    const uint32_t x = (uint32_t)in[o & 0xFFu] |
                       ((uint32_t)in[(o >> 8) & 0xFFu] << 8) |
                       ((uint32_t)in[(o >> 16) & 0xFFu] << 16) |
                       ((uint32_t)in[o >> 24] << 24);
    const uint32_t fill = ((x >> 7) & 0x01010101u) * 0xFFu;
    r.w[w] = (int32_t)((x & v.keep[w]) | (fill & v.sign[w]));
  }
  return r;
}

// Store a vector at byte ``o`` of the output, whose length is ``end``:
// 16 bytes at once, or the bytes before ``end`` of a ragged last vector.
DVDA_HD void pcm_store_vector(uint8_t* out, int64_t o, int64_t end,
                              const DvdaWords4& r) {
  if (o + 16 <= end) {
    dvda_store16(reinterpret_cast<int32_t*>(out + o), r);
    return;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)  // unrolled: r stays in registers
    if (o + k < end)
      out[o + k] = (uint8_t)((uint32_t)r.w[k >> 2] >> (8 * (k & 3)));
}
