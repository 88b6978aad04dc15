// The chunk descriptor, and K10's bodies: K5's lane inputs of a
// device-Huffman chunk (dvda_tpu native_engine.py:140-172).
//
// A chunk's substreams are slices of its three arenas (int32, int16,
// int8; dvda_tpu native_engine.py:116-126), each array at its arena's
// width, widened to int32 with sign extension where it is read
// (:128-129).  The wrapper (ops/chunk_lanes.py) builds a descriptor
// (ChunkLanesDesc) once per chunk spec: every array is an (offset,
// element width) pair in the arena of that width; width 0 means the spec
// does not hold it.  Shapes (the spec's):
//   res            [Bc, NB0, n_ch, S0]   standard mode
//   rc_fir, rc_iir, iir_init  [Bc, n_ch, 8] per chain or [Bc, NB0, n_ch, 8]
//   shift, quant, iir_reset   [Bc, n_ch]    per chain or [Bc, NB0, n_ch]
//   bitpos [Bc, NB0, nsub]; cb, lsbb, off [Bc, NB0, n_ch]; nbyp [Bc, NB0]
// K1a (chunk_filter.cuh) reads the residuals and the parameter rows
// through one descriptor per filter launch.  K10 writes a device-Huffman
// chunk's K5 inputs, per substream, in one int32 buffer (element
// offsets):
//   bitpos [Lc, nsub]; cb, lsbb, off, quant [Lc, n_ch]; nbyp [Lc]
//   (Lc = Bc*NB0 chain-major rows l = b*NB0 + nb; the per-chain quant
//   broadcast over the chain's blocks).
//
// The grid: per substream, blocks of kChunkLanesThreads *
// kChunkLanesPerThread output elements, one element a thread at a time,
// consecutive threads on consecutive outputs.  The plan
// (chunk_lanes_plan) counts them from the shapes.
#pragma once

#include "dvda_hd.cuh"

constexpr int kChunkLanesMaxSubs = 4;
constexpr int kChunkLanesThreads = 256;
constexpr int kChunkLanesPerThread = 4;  // output elements a thread

// An array of the arenas: its element offset, and the arena's element
// width (4, 2 or 1; 0: absent).
struct ChunkArray {
  int64_t off, width;
};

struct ChunkLanesSub {
  int64_t Bc, NB0, n_ch, S0, nsub, per_chain;
  ChunkArray res, rc_fir, rc_iir, iir_init, shift, quant, iir_reset, bitpos,
      cb, lsbb, off, nbyp;
  // K10's outputs
  int64_t o_bitpos, o_cb, o_lsbb, o_off, o_hquant, o_nbyp;
  // filled by chunk_lanes_plan: output elements, and the substream's
  // first block and block count in the grid
  int64_t elems, block0, blocks;
};

struct ChunkLanesDesc {
  int64_t n_subs;
  ChunkLanesSub sub[kChunkLanesMaxSubs];
};

struct ChunkArenas {
  const int32_t* __restrict__ a4;
  const int16_t* __restrict__ a2;
  const int8_t* __restrict__ a1;
};

// Element i of array x, sign-extended to int32.
DVDA_HD int32_t chunk_load(const ChunkArenas& A, const ChunkArray& x,
                           int64_t i) {
  const int64_t j = x.off + i;
  return x.width == 4 ? A.a4[j]
         : x.width == 2 ? (int32_t)A.a2[j]
                        : (int32_t)A.a1[j];
}

DVDA_HD int64_t chunk_cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Whether d is a device-Huffman chunk's descriptor K10 can take: 1 to
// kChunkLanesMaxSubs substreams, each with its bitpos.
DVDA_HD bool chunk_lanes_desc_ok(const ChunkLanesDesc& d) {
  if (d.n_subs < 1 || d.n_subs > kChunkLanesMaxSubs) return false;
  for (int i = 0; i < d.n_subs; ++i)
    if (!d.sub[i].bitpos.width) return false;
  return true;
}

// Elements of each substream, and its blocks in the grid; returns the
// grid's block count.
DVDA_HD int64_t chunk_lanes_plan(ChunkLanesDesc& d) {
  int64_t block = 0;
  for (int i = 0; i < d.n_subs; ++i) {
    ChunkLanesSub& s = d.sub[i];
    s.elems = s.Bc * s.NB0 * (s.nsub + 4 * s.n_ch + 1);
    s.block0 = block;
    s.blocks =
        chunk_cdiv(s.elems, (int64_t)kChunkLanesThreads * kChunkLanesPerThread);
    block += s.blocks;
  }
  return block;
}

// Output element e of substream s (0 <= e < s.elems), in order: bitpos
// (Lc x nsub), cb, lsbb, off, quant (Lc x n_ch each) and nbyp (Lc).  A
// substream's elements number below 2^31 (the wrapper checks), so the
// index arithmetic is 32-bit: a 64-bit division is a call on the card.
DVDA_HD void chunk_lanes_element(const ChunkLanesSub& s, const ChunkArenas& A,
                                 int32_t e, int32_t* __restrict__ out32) {
  const int NB0 = (int)s.NB0, n_ch = (int)s.n_ch;
  const int32_t Lc = (int32_t)s.Bc * NB0, nsub = (int32_t)s.nsub;
  if (e < Lc * nsub) {
    out32[s.o_bitpos + e] = chunk_load(A, s.bitpos, e);
    return;
  }
  e -= Lc * nsub;
  const int32_t tab = Lc * n_ch;
  if (e < 4 * tab) {
    const int32_t k = e < tab ? 0 : e < 2 * tab ? 1 : e < 3 * tab ? 2 : 3;
    const int32_t r = e - k * tab;
    switch (k) {
      case 0: out32[s.o_cb + r] = chunk_load(A, s.cb, r); return;
      case 1: out32[s.o_lsbb + r] = chunk_load(A, s.lsbb, r); return;
      case 2: out32[s.o_off + r] = chunk_load(A, s.off, r); return;
      default: {  // quant: per chain, broadcast over the chain's blocks
        const int32_t l = r / n_ch, j = r - l * n_ch;
        out32[s.o_hquant + r] =
            chunk_load(A, s.quant, s.per_chain ? l / NB0 * n_ch + j : r);
        return;
      }
    }
  }
  e -= 4 * tab;
  out32[s.o_nbyp + e] = chunk_load(A, s.nbyp, e);
}

// The substream of a block of the grid, and the block's first output
// element there.
DVDA_HD int chunk_lanes_locate(const ChunkLanesDesc& d, int64_t block,
                               int64_t* elem0) {
  int i = 0;
  while (i + 1 < d.n_subs && block >= d.sub[i + 1].block0) ++i;
  *elem0 = (block - d.sub[i].block0) * kChunkLanesThreads *
           kChunkLanesPerThread;
  return i;
}
