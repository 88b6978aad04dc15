// K234 bodies: the output half of the uniform chunk program -- LFSR noise,
// bypassed-LSB unpack, rematrix, output shift, WAVE permutation and
// little-endian byte pack, in one pass -- as the tiles the kernel runs.
//
// Inputs are the chunk's arena arrays as they arrive (no widening copies):
//   series      int32 [period, C_tot*Bc]  filter output, time-leading;
//               channel c of chain b at in-chain time t is
//               series[t, c*Bc + b]; channels >= C_tot are zero
//   frame_seed  int32 [Bc*fpc]  (uint32 bits) LFSR seed at the frame start
//   frame_nshift int8 [Bc*fpc]
//   byp         int8  [Bc*period]  bit m = bypassed LSB of matrix slot m
//   mat_coeff   int16 [Bc*fpc, 6, 8]    mat_noise int16 [Bc*fpc, 6, 2]
//   mat_out, mat_active, mat_quant  int8 [Bc*fpc, 6]
//   out_shift   int8  [Bc*fpc, 8]       wave_perm int8 [C_out]
// Frame arrays are chain-major (frame index b*fpc + f), as the arena
// builder lays them out; they are arena views, so only their element size
// is a known alignment.  The output row of (chain b, frame f, sample i) is
// b*period + f*L0 + i: WAV time order.  The output form (``form``) is 3
// or 2 for little-endian 24/16-bit samples ([T_pad, C_out*form] bytes), 4
// for int32 [T_pad, C_out], or kNarrow12 for the 12-bit tier of the narrow
// readback: channel pairs (c0, c1) in 3 bytes ([T_pad, C_out/2*3], even
// C_out).  The narrow 16-bit tier is form 2.  Every sample also reports
// which narrow tiers its values miss (output_stage_misfit).
//
// A tile (DvdaOutTile) is kOutTileChains chains x a strip of kOutStrip
// samples of one frame, run by kOutThreads threads: lane = chain (a warp's
// series loads are 128 contiguous bytes), warp w = samples w*kOutRun ..
// w*kOutRun + kOutRun - 1 of the strip.  Its phases, each a function of
// the thread index so that the CPU harness runs the same bodies thread by
// thread: output_stage_inputs (a thread's channels, loaded first),
// output_stage_table_loads / _stores and output_stage_byp_loads / _stores
// (the tile's frame tables and bypass bytes into shared memory, every
// load before the first store), the LFSR state at the strip's start
// (dvda_lfsr_at, a jump), then output_stage_samples (a thread's samples,
// their rows staged in shared memory) and output_stage_store (each
// chain's run of staged bytes as 16-byte vectors, bytes only at an
// unaligned end).
//
// Semantics are dvda_tpu.ops.rematrix.rematrix_frames_tl followed by
// apply_output_stage_tl and the byte pack of the JAX chunk program.  The
// LFSR state at in-frame offset i is M^i applied to the frame seed, M the
// GF(2)-linear step: a jump of M^(16q) from the table kDvdaLfsrJumps, then
// i mod 16 single steps (the JAX program expands it by jump doubling; all
// give the reference sequence).  Wrapping int32 adds and left shifts go
// through uint32.
#pragma once

#include "dvda_hd.cuh"

DVDA_HD constexpr uint32_t dvda_lfsr_step(uint32_t seed) {
  const uint32_t shifted = (seed >> 7) & 0xFFFFu;
  return (seed << 16) ^ shifted ^ (shifted << 5);
}

// The step is linear over GF(2), so M^n s is the XOR of M^n's columns at
// the set bits of s.  col[q][k] = M^(16q) e_k for q = 0..16.
struct DvdaLfsrJumps {
  uint32_t col[17][32];
};

constexpr DvdaLfsrJumps dvda_lfsr_jumps() {
  DvdaLfsrJumps j{};
  for (int k = 0; k < 32; ++k) {
    uint32_t x = 1u << k;
    for (int q = 0; q <= 16; ++q) {
      j.col[q][k] = x;
      for (int s = 0; s < 16; ++s) x = dvda_lfsr_step(x);
    }
  }
  return j;
}

#if defined(__CUDACC__)
static __constant__ DvdaLfsrJumps kDvdaLfsrJumps = dvda_lfsr_jumps();
#endif
static constexpr DvdaLfsrJumps kDvdaLfsrJumpsHost = dvda_lfsr_jumps();

// M^(16q) s, q in 0..16 (on the card every lane of a warp passes the same
// q: the constant cache broadcasts each column)
DVDA_HD uint32_t dvda_lfsr_jump16(uint32_t s, int q) {
#if defined(__CUDA_ARCH__)
  const uint32_t* col = kDvdaLfsrJumps.col[q];
#else
  const uint32_t* col = kDvdaLfsrJumpsHost.col[q];
#endif
  uint32_t x0 = 0, x1 = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    x0 ^= col[k] & (0u - ((s >> k) & 1u));
    x1 ^= col[k + 1] & (0u - ((s >> (k + 1)) & 1u));
  }
  return x0 ^ x1;
}

// The LFSR state i steps after ``seed``: jumps of 16 steps, then single
// steps.
DVDA_HD uint32_t dvda_lfsr_at(uint32_t seed, int64_t i) {
  int64_t q = i >> 4;
  for (; q > 16; q -= 16) seed = dvda_lfsr_jump16(seed, 16);
  if (q > 0) seed = dvda_lfsr_jump16(seed, (int)q);
  for (int r = 0; r < (int)(i & 15); ++r) seed = dvda_lfsr_step(seed);
  return seed;
}

// One frame's matrix rows, widened to int32 (mlp.c:1308-1358): up to 6
// matrices, each 8 channel coefficients and 2 noise coefficients, its
// output channel, quant shift and active flag.
struct DvdaFrameMats {
  int32_t co[6][8], cn[6][2];
  int mo[6], mq[6];
  bool act[6];
};

// The bypassed-LSB addend of matrix slot m.  K234 and K6b hold a sample's
// six bypassed LSBs as the bits of one mask; K9 (frame_remix.cuh) holds six
// full int32 addends, dvda_tpu's int32 ``bypassed [F, 6, L]``.
struct DvdaBypassBits {
  uint32_t bits;
  DVDA_HD uint32_t operator[](int m) const { return (bits >> m) & 1u; }
};
struct DvdaBypassWords {
  uint32_t v[6];
  DVDA_HD uint32_t operator[](int m) const { return v[m]; }
};

// mask() (mlp.c:246-253) with XLA's shift rule: a quant step of 32 or more
// (as unsigned) clears every bit, as (x >> q) << q does in XLA.
DVDA_HD int32_t dvda_mask_quant(int32_t x, int q) {
  return (uint32_t)q < 32u ? (int32_t)((uint32_t)(x >> q) << q) : 0;
}

// The rematrix chain on one sample's 8 channels, in place: matrix m's int64
// dot over the channels and the two noise values, ">> 14" cut to int32, the
// quant mask, "+" the bypass addend byp[m], written into channel mo[m] when
// active.  Shared by K234 (output_stage_sample), K6b (general_gather.cuh)
// and K9 (frame_remix.cuh).  (Skipping inactive slots with a branch made
// K6b half again slower on the card: tools/torch_timing_check.py k6b.)
template <class Bypass>
DVDA_HD void dvda_rematrix_sample(const DvdaFrameMats& mats, int n_mats,
                                  int32_t ch[8], int32_t n0, int32_t n1,
                                  const Bypass& byp) {
  for (int m = 0; m < n_mats; ++m) {
    int64_t acc = (int64_t)mats.cn[m][0] * n0 + (int64_t)mats.cn[m][1] * n1;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc += (int64_t)mats.co[m][c] * ch[c];
    const int32_t masked = dvda_mask_quant((int32_t)(acc >> 14), mats.mq[m]);
    const int32_t val = (int32_t)((uint32_t)masked + byp[m]);
    // select, not a dynamic index: keeps ch[] in registers
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (mats.act[m] && c == mats.mo[m]) ch[c] = val;
  }
}

// The output stage for WAVE slot k (mlp.c:514-533): channel p = wave_perm[k]
// shifted left by its output shift (XLA's rule: 0 for a shift of 32 or
// more), as uint32 bits.
DVDA_HD uint32_t dvda_output_pick(const int32_t ch[8], const int osh[8],
                                  int p) {
  int32_t src = 0;
  int sh = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c == p) {
      src = ch[c];
      sh = osh[c];
    }
  }
  return dvda_shl((uint32_t)src, (uint32_t)sh);
}

// One frame's tables for K234: the matrix rows, the output shifts and the
// noise shift.
struct DvdaOutFrame {
  DvdaFrameMats mats;
  int osh[8];
  int nshift;
};

// The narrow readback's 12-bit tier as an output form (the others are
// their byte counts: 2, 3, and 4 for int32).
constexpr int kNarrow12 = 12;

// Output bytes of one sample row in ``form``.
DVDA_HD int output_stage_row_bytes(int C_out, int form) {
  return form == kNarrow12 ? C_out / 2 * 3 : C_out * form;
}

// The narrow tiers a staged value misses: bit 0 when it lies outside
// 12-bit two's complement [-2048, 2048), bit 1 outside int16.
DVDA_HD uint32_t output_stage_misfit(int32_t v) {
  return (uint32_t)(v < -2048 || v >= 2048) |
         (uint32_t)(v < -32768 || v >= 32768) << 1;
}

// The narrow flag byte from the OR of every sample's misfit bits
// (dvda_tpu native_engine.py:346-363): at tier 12, fits12 + 2 * fits16;
// at tier 16, fits16.
DVDA_HD uint8_t output_stage_narrow_flag(uint32_t misfit, int tier) {
  const uint32_t fits12 = !(misfit & 1u), fits16 = !(misfit & 2u);
  return (uint8_t)(tier == kNarrow12 ? fits12 + 2 * fits16 : fits16);
}

// One sample of frame fr: noise from the LFSR state ``seed`` it starts
// at, the first n_mats matrix slots (fr's tables are read where they lie,
// so n_mats can be a runtime count without a stack copy), the output shift
// and the WAVE permutation; its row of C_out values in form kForm (a
// constant: the byte loop unrolls) at dst.  The permutation goes through
// ``slot``, 8 words of the thread's own: each channel shifted is stored
// there, and WAVE slot k loads slot[wave_perm[k]] (dvda_output_pick's
// value, with 8 stores and C_out loads in place of its 8-way selects).
// Returns the narrow tiers its values miss (output_stage_misfit, ORed) in
// the forms the narrow tiers use, 2 and kNarrow12; 0 in the others.
template <int kForm>
DVDA_HD uint32_t output_stage_sample(const DvdaOutFrame& fr, uint32_t seed,
                                     int n_mats, int32_t ch[8], uint32_t bits,
                                     const int8_t* wave_perm, int C_out,
                                     uint32_t* slot, uint8_t* dst) {
  // noise0 = int8(seed >> 15) << nshift, noise1 = int8(seed >> 7) << ...
  const int32_t n0 = (int32_t)((uint32_t)(int32_t)(int8_t)(uint8_t)(
                                   seed >> 15) << fr.nshift);
  const int32_t n1 = (int32_t)((uint32_t)(int32_t)(int8_t)(uint8_t)(
                                   seed >> 7) << fr.nshift);
  dvda_rematrix_sample(fr.mats, n_mats, ch, n0, n1, DvdaBypassBits{bits});
#pragma unroll
  for (int c = 0; c < 8; ++c)
    slot[c] = dvda_shl((uint32_t)ch[c], (uint32_t)fr.osh[c]);
  uint32_t misfit = 0;
  if constexpr (kForm == kNarrow12) {
    // pair j: c0 & 0xFF, (c0 >> 8 & 0xF) | (c1 & 0xF) << 4, c1 >> 4 & 0xFF
    for (int j = 0; j < C_out / 2; ++j) {
      const uint32_t c0 = slot[wave_perm[2 * j]];
      const uint32_t c1 = slot[wave_perm[2 * j + 1]];
      misfit |= output_stage_misfit((int32_t)c0) |
                output_stage_misfit((int32_t)c1);
      dst[3 * j] = (uint8_t)c0;
      dst[3 * j + 1] = (uint8_t)(((c0 >> 8) & 0xFu) | ((c1 & 0xFu) << 4));
      dst[3 * j + 2] = (uint8_t)(c1 >> 4);
    }
    return misfit;
  }
  for (int k = 0; k < C_out; ++k) {
    const uint32_t v = slot[wave_perm[k]];
    if constexpr (kForm == 2) misfit |= output_stage_misfit((int32_t)v);
#pragma unroll
    for (int j = 0; j < kForm; ++j)
      dst[k * kForm + j] = (uint8_t)(v >> (8 * j));
  }
  return misfit;
}

// ------------------------------------------------------------- the tile

constexpr int kOutThreads = 256;    // threads of a tile
constexpr int kOutTileChains = 32;  // chains of a tile: a warp's lanes
constexpr int kOutStrip = 16;       // samples of a tile, of one frame
constexpr int kOutRun = kOutStrip * kOutTileChains / kOutThreads;  // a thread's
constexpr int kOutMaxRow = 32;      // output bytes of a sample at most
// words of a chain's staged run, whose first byte sits at (its output
// offset & 15): 15 + kOutStrip * kOutMaxRow bytes at most.  Odd, so the 32
// lanes' byte stores and the store phase's word loads fall in 32 banks.
constexpr int kOutPitch = 133;
static_assert(4 * kOutPitch >= 15 + kOutStrip * kOutMaxRow, "pitch");

struct DvdaOutTile {
  int b0, nct;     // first chain, chains of the tile
  int f, i0, ns;   // frame, first in-frame sample, samples
  int L0, row;     // frame length, output bytes a sample
  int64_t period;  // samples a chain
};

DVDA_HD int output_stage_strips(int L0) {
  return (L0 + kOutStrip - 1) / kOutStrip;
}

// Tile (x, y) of the grid: x = frame * strips + strip, y = chain tile.
DVDA_HD DvdaOutTile output_stage_tile(int x, int y, int Bc, int fpc, int L0,
                                      int row) {
  DvdaOutTile t;
  const int strips = output_stage_strips(L0);
  t.f = x / strips;
  t.i0 = (x - t.f * strips) * kOutStrip;
  t.ns = L0 - t.i0 < kOutStrip ? L0 - t.i0 : kOutStrip;
  t.b0 = y * kOutTileChains;
  t.nct = Bc - t.b0 < kOutTileChains ? Bc - t.b0 : kOutTileChains;
  t.L0 = L0;
  t.row = row;
  t.period = (int64_t)fpc * L0;
  return t;
}

// The output byte of chain c's first sample in the tile.
DVDA_HD int64_t output_stage_run_start(const DvdaOutTile& t, int c) {
  return ((int64_t)(t.b0 + c) * t.period + (int64_t)t.f * t.L0 + t.i0) *
         t.row;
}

// Thread tid's kOutRun samples: lane c = tid % 32 is the chain, sample k =
// tid / 32 * kOutRun + r.  Their 8 channels (0 past C_tot or the tile).
struct DvdaOutInputs {
  int32_t ch[kOutRun][8];
};

DVDA_HD void output_stage_inputs(int tid, const DvdaOutTile& t,
                                 const int32_t* __restrict__ series, int Bc,
                                 int C_tot, DvdaOutInputs& in) {
  const int c = tid % kOutTileChains, k0 = tid / kOutTileChains * kOutRun;
#pragma unroll
  for (int r = 0; r < kOutRun; ++r) {
    const bool live = c < t.nct && k0 + r < t.ns;
    const int64_t at =
        ((int64_t)t.f * t.L0 + t.i0 + k0 + r) * C_tot * Bc + t.b0 + c;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch)
      in.ch[r][ch] = live && ch < C_tot ? series[at + (int64_t)ch * Bc] : 0;
  }
}

// The tile's frame tables: an array of kN elements a frame is the tile's
// nct * kN elements, and load pass p of thread tid takes element u = tid +
// p * kOutThreads (frame u / kN, element u % kN).  A thread loads every
// pass of every array (output_stage_table_loads), then stores them
// (output_stage_table_stores), widened to int32, into DvdaOutFrame s_fr[c].
template <int kN>
constexpr int kOutPasses = (kOutTileChains * kN + kOutThreads - 1) /
                           kOutThreads;

struct DvdaOutTableLoads {
  int32_t co[kOutPasses<48>], cn[kOutPasses<12>],
      mo[kOutPasses<6>], mq[kOutPasses<6>],
      act[kOutPasses<6>], osh[kOutPasses<8>],
      nsh[kOutPasses<1>];
};

template <int kN, class T>
DVDA_HD void output_stage_table_load(int tid, const DvdaOutTile& t, int fpc,
                                     const T* __restrict__ src,
                                     int32_t* v) {
#pragma unroll
  for (int p = 0; p < kOutPasses<kN>; ++p) {
    const int u = tid + p * kOutThreads, c = u / kN;
    v[p] = c < t.nct
               ? (int32_t)src[((int64_t)(t.b0 + c) * fpc + t.f) * kN +
                              (u - c * kN)]
               : 0;
  }
}

DVDA_HD void output_stage_table_loads(
    int tid, const DvdaOutTile& t, int fpc,
    const int8_t* __restrict__ frame_nshift,
    const int16_t* __restrict__ mat_coeff,
    const int16_t* __restrict__ mat_noise, const int8_t* __restrict__ mat_out,
    const int8_t* __restrict__ mat_active,
    const int8_t* __restrict__ mat_quant,
    const int8_t* __restrict__ out_shift, DvdaOutTableLoads& v) {
  output_stage_table_load<48>(tid, t, fpc, mat_coeff, v.co);
  output_stage_table_load<12>(tid, t, fpc, mat_noise, v.cn);
  output_stage_table_load<6>(tid, t, fpc, mat_out, v.mo);
  output_stage_table_load<6>(tid, t, fpc, mat_quant, v.mq);
  output_stage_table_load<6>(tid, t, fpc, mat_active, v.act);
  output_stage_table_load<8>(tid, t, fpc, out_shift, v.osh);
  output_stage_table_load<1>(tid, t, fpc, frame_nshift, v.nsh);
}

enum DvdaOutTable { kOutCo, kOutCn, kOutMo, kOutMq, kOutAct, kOutOsh,
                    kOutNsh };

template <int kArr>
DVDA_HD void output_stage_put(DvdaOutFrame& o, int e, int32_t v) {
  if constexpr (kArr == kOutCo) o.mats.co[e >> 3][e & 7] = v;
  if constexpr (kArr == kOutCn) o.mats.cn[e >> 1][e & 1] = v;
  if constexpr (kArr == kOutMo) o.mats.mo[e] = v;
  if constexpr (kArr == kOutMq) o.mats.mq[e] = v;
  if constexpr (kArr == kOutAct) o.mats.act[e] = v != 0;
  if constexpr (kArr == kOutOsh) o.osh[e] = v;
  if constexpr (kArr == kOutNsh) o.nshift = v;
}

template <int kN, int kArr>
DVDA_HD void output_stage_table_store(int tid, const DvdaOutTile& t,
                                      const int32_t* v, DvdaOutFrame* s_fr) {
#pragma unroll
  for (int p = 0; p < kOutPasses<kN>; ++p) {
    const int u = tid + p * kOutThreads, c = u / kN;
    if (c < t.nct) output_stage_put<kArr>(s_fr[c], u - c * kN, v[p]);
  }
}

DVDA_HD void output_stage_table_stores(int tid, const DvdaOutTile& t,
                                       const DvdaOutTableLoads& v,
                                       DvdaOutFrame* s_fr) {
  output_stage_table_store<48, kOutCo>(tid, t, v.co, s_fr);
  output_stage_table_store<12, kOutCn>(tid, t, v.cn, s_fr);
  output_stage_table_store<6, kOutMo>(tid, t, v.mo, s_fr);
  output_stage_table_store<6, kOutMq>(tid, t, v.mq, s_fr);
  output_stage_table_store<6, kOutAct>(tid, t, v.act, s_fr);
  output_stage_table_store<8, kOutOsh>(tid, t, v.osh, s_fr);
  output_stage_table_store<1, kOutNsh>(tid, t, v.nsh, s_fr);
}

// The tile's bypass bytes, s_byp[c * kOutStrip + k] for chain c's sample
// k: load pass p of thread tid takes byte u = tid + p * kOutThreads.
constexpr int kOutBypPasses = kOutTileChains * kOutStrip / kOutThreads;

DVDA_HD void output_stage_byp_loads(int tid, const DvdaOutTile& t,
                                    const int8_t* __restrict__ byp,
                                    uint8_t v[kOutBypPasses]) {
#pragma unroll
  for (int p = 0; p < kOutBypPasses; ++p) {
    const int u = tid + p * kOutThreads, c = u / kOutStrip,
              k = u % kOutStrip;
    v[p] = c < t.nct && k < t.ns
               ? (uint8_t)byp[(int64_t)(t.b0 + c) * t.period +
                              (int64_t)t.f * t.L0 + t.i0 + k]
               : 0;
  }
}

DVDA_HD void output_stage_byp_stores(int tid, const uint8_t v[kOutBypPasses],
                                     uint8_t* s_byp) {
#pragma unroll
  for (int p = 0; p < kOutBypPasses; ++p) s_byp[tid + p * kOutThreads] = v[p];
}

// Chain c's frame seed (c < nct); dvda_lfsr_at(it, t.i0) is the LFSR state
// at the strip's start.
DVDA_HD uint32_t output_stage_frame_seed(int c, const DvdaOutTile& t,
                                         int fpc,
                                         const int32_t* __restrict__ seeds) {
  return c < t.nct ? (uint32_t)seeds[(int64_t)(t.b0 + c) * fpc + t.f] : 0u;
}

// Thread tid's samples in form kForm (``slot``: its 8 words for
// output_stage_sample): the LFSR stepped from the strip's start, each
// sample's row staged at byte (run start & 15) + k * row of chain c's run
// in s_out (kOutPitch words a chain).  Returns the narrow tiers its values
// miss.
template <int kForm>
DVDA_HD uint32_t output_stage_samples(int tid, const DvdaOutTile& t,
                                      DvdaOutInputs& in,
                                      const DvdaOutFrame* s_fr,
                                      const uint32_t* s_seed,
                                      const uint8_t* s_byp,
                                      const int8_t* wave_perm, int n_mats,
                                      int C_out, uint32_t* slot,
                                      uint32_t* s_out) {
  const int c = tid % kOutTileChains, k0 = tid / kOutTileChains * kOutRun;
  if (c >= t.nct || k0 >= t.ns) return 0;
  uint32_t seed = s_seed[c];
  for (int j = 0; j < k0; ++j) seed = dvda_lfsr_step(seed);
  uint8_t* dst = reinterpret_cast<uint8_t*>(s_out + c * kOutPitch) +
                 (output_stage_run_start(t, c) & 15);
  uint32_t miss = 0;
#pragma unroll
  for (int r = 0; r < kOutRun; ++r) {
    const int k = k0 + r;
    if (k < t.ns)
      miss |= output_stage_sample<kForm>(s_fr[c], seed, n_mats, in.ch[r],
                                         s_byp[c * kOutStrip + k], wave_perm,
                                         C_out, slot, dst + k * t.row);
    seed = dvda_lfsr_step(seed);
  }
  return miss;
}

// 16-byte vectors a chain's run of the tile touches, at most.
DVDA_HD int output_stage_vectors(const DvdaOutTile& t) {
  return (15 + t.ns * t.row) / 16 + 1;
}

// Store item k (< nct * output_stage_vectors): chain c = k / nv's vector v
// = k % nv, at the 16-byte aligned output byte (run start & ~15) + 16 v,
// whole where the run covers it, else its bytes that lie in the run.
DVDA_HD void output_stage_store(int k, const DvdaOutTile& t,
                                const uint32_t* s_out,
                                uint8_t* __restrict__ out) {
  const int nv = output_stage_vectors(t), c = k / nv, v = k - c * nv;
  const int64_t gs = output_stage_run_start(t, c), ge = gs + t.ns * t.row;
  const int64_t a = (gs & ~(int64_t)15) + 16 * v;
  if (a >= ge) return;
  const uint32_t* src = s_out + c * kOutPitch + 4 * v;
  if (a >= gs && a + 16 <= ge) {
    dvda_store16(reinterpret_cast<int32_t*>(out + a),
                 DvdaWords4{{(int32_t)src[0], (int32_t)src[1],
                             (int32_t)src[2], (int32_t)src[3]}});
    return;
  }
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(src);
  for (int j = 0; j < 16; ++j)
    if (a + j >= gs && a + j < ge) out[a + j] = bytes[j];
}
