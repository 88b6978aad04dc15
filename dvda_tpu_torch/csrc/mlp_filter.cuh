// K1 lane body: the MLP AR reconstruction filter (mlp.c:1243-1306) for one
// lane, i.e. one (restart chain x channel) pair, run serially over NB
// blocks of S samples, one sample per call of mlp_filter_step.
//
// Layouts are those of dvda_tpu.ops.mlp_filter.mlp_filter_blocks_tl:
//   residuals / output  int32 [NB, S, B]  time-leading, lanes minor
//   rc_fir / rc_iir     int32 [B, NB, 8]  reversed taps (7 = most recent)
//   shift, quant        int32 [B, NB]
//   iir_reset           uint8 [B, NB]     nonzero: IIR state := iir_init
//   iir_init            int32 [B, NB, 8]
//   block_len           int32 [B, NB]     state frozen at samples >= len
//   fir/iir state       int32 [B, 8]      initial in, final out
//
// Arithmetic is C's: an exact int64 accumulate, (int32)(acc >> shift), then
// the residual add and the quant mask (x >> q) << q.  The int32 add, the
// left shift and the IIR error term wrap, so they are done in uint32 (signed
// overflow is undefined in C++).
//
// The sum is split so that only two products wait on the sample just
// made: after sample i the next accumulate is
//   part + fc[7] * value + ic[7] * error,
// where ``part`` (taps 0-6 over state entries 1-7) was summed from the
// state one sample earlier, while sample i was still being computed.  The
// sums are in uint64: addition mod 2^64 is associative, so the result is
// the serial int64 sum bit for bit, wrap included.  A block's first sample
// sums all 16 terms with its own taps (after the IIR reset); a frozen
// sample (i >= block_len) shifts nothing, so acc and part stay.
//
// The caller supplies the residuals through an accessor of the staged
// tile (MlpFilterColumn: K1's int32 tile in shared memory, or the CPU
// harness's host copy; K1a's in chunk_filter.cuh), and the next block's
// parameters are loaded one block ahead into registers by a parameter
// policy (MlpFilterTables; K1a's ChunkFilterTables).
// Eight live samples of one block (kFilterGroup) whose taps allow float64
// run as one straight-line group (mlp_filter_run_f64), where the state is
// renamed rather than shifted, the 12 products of the next partial sum
// that need no new value are issued beside the chain, and the shift and
// quant mask are one instruction each; eight frozen samples are one group
// too (mlp_filter_frozen).  A group that crosses block_len or a block's
// end, taps outside +-2^16 (no MLP stream has them: coefficients are at
// most 16 bits), or a shift or quant outside 0-31 (C's shifts, kept as
// they are) take the one-sample step.
#pragma once

#include <math.h>

#include "dvda_hd.cuh"

// lanes of a thread block, residual rows of one staged tile, samples of a
// straight-line group
constexpr int kFilterLanes = 32;
constexpr int kFilterRows = 32;
constexpr int kFilterGroup = 8;

// One block's parameters of one lane.
struct MlpFilterBlock {
  int32_t fc[8], ic[8], init[8];
  int32_t sh, q, blen, rst;
};

// Where a lane's parameters and initial state come from: the sample loop
// below is a template on this policy.  A policy has
//   load(p, lane, nb, NB)  block nb's parameters of ``lane`` into p
//   state0(fs, is, lane)   the lane's initial FIR and IIR state
// MlpFilterTables reads K1's ten arrays (the layouts above);
// ChunkFilterTables (K1a, chunk_filter.cuh) reads a lane's rows straight
// from the chunk arenas.
struct MlpFilterTables {
  const int32_t* __restrict__ rc_fir;
  const int32_t* __restrict__ rc_iir;
  const int32_t* __restrict__ shift;
  const int32_t* __restrict__ quant;
  const uint8_t* __restrict__ iir_reset;
  const int32_t* __restrict__ iir_init;
  const int32_t* __restrict__ block_len;
  const int32_t* __restrict__ fir_state0;
  const int32_t* __restrict__ iir_state0;

  DVDA_HD void load(MlpFilterBlock& p, int lane, int nb, int NB) const {
    const int64_t pb = (int64_t)lane * NB + nb;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      p.fc[k] = rc_fir[pb * 8 + k];
      p.ic[k] = rc_iir[pb * 8 + k];
      p.init[k] = iir_init[pb * 8 + k];
    }
    p.sh = shift[pb];
    p.q = quant[pb];
    p.blen = block_len[pb];
    p.rst = iir_reset[pb];
  }

  DVDA_HD void state0(int32_t* fs, int32_t* is, int lane) const {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      fs[k] = fir_state0[lane * 8 + k];
      is[k] = iir_state0[lane * 8 + k];
    }
  }
};

struct MlpFilterLane {
  int32_t fs[8], is[8];   // FIR / IIR state, 7 = most recent
  MlpFilterBlock cur, nxt;
  uint64_t acc;   // this sample's sum
  uint64_t part;  // the next sample's 14 terms known before this value
  int i, nb;      // sample and block of the next step
  uint32_t mask;  // the quant mask ~0 << q
  bool fast;      // shift and quant in 0-31: the grouped step applies
  // taps within +-2^16: every product of a tap and an int32 is below 2^47
  // and every sum of 16 below 2^51, so float64 holds them exactly, and its
  // multiply-add runs at several times the rate of the 32 x 32 -> 64-bit
  // integer one (IMAD.WIDE), which bounds the integer group on Hopper
  bool dbl;
  double fcd[8], icd[8];  // the taps (when dbl)
  double scale;           // 2^-shift (when fast)
};

// Exact float64 conversions.  An int32 v is 2^52 + 2^31 + v read from its
// bit pattern, less that constant: one integer and one float64 instruction
// on the card, not a conversion.
DVDA_HD double mlp_filter_i2d(int32_t v) {
#if defined(__CUDA_ARCH__)
  return __hiloint2double(0x43300000, (int)((uint32_t)v ^ 0x80000000u)) -
         4503601774854144.0;
#else
  return (double)v;
#endif
}

// 2^n for -31 <= n <= 0, exactly: built from its exponent on the card.
DVDA_HD double mlp_filter_pow2(int n) {
#if defined(__CUDA_ARCH__)
  return __hiloint2double((1023 + n) << 20, 0);
#else
  return ldexp(1.0, n);
#endif
}

// (int32)floor(x * scale) for an integral |x * scale| < 2^51: on the card
// x * scale + 1.5 * 2^52 rounded down, whose low word is that integer's.
DVDA_HD int32_t mlp_filter_shr_d(double x, double scale) {
#if defined(__CUDA_ARCH__)
  return __double2loint(__fma_rd(x, scale, 6755399441055744.0));
#else
  return (int32_t)(uint32_t)(uint64_t)(int64_t)floor(x * scale);
#endif
}

DVDA_HD uint64_t mlp_filter_term(int32_t c, int32_t x) {
  return (uint64_t)((int64_t)c * x);
}

// taps 0-6 over state entries 1-7: the next sample's sum but its newest
// two products
DVDA_HD uint64_t mlp_filter_partial(const MlpFilterLane& L) {
  uint64_t p = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k)
    p += mlp_filter_term(L.cur.fc[k], L.fs[k + 1]) +
         mlp_filter_term(L.cur.ic[k], L.is[k + 1]);
  return p;
}

// Enter block L.nb: its parameters (loaded one block ahead), the IIR
// reset, the full sum of its first sample; then load the next block's.
template <class Tables>
DVDA_HD void mlp_filter_enter(MlpFilterLane& L, int lane, int NB,
                              const Tables& t) {
  L.cur = L.nxt;
  if (L.cur.rst) {
#pragma unroll
    for (int k = 0; k < 8; ++k) L.is[k] = L.cur.init[k];
  }
  L.i = 0;
  L.fast = L.cur.sh >= 0 && L.cur.sh < 32 && L.cur.q >= 0 && L.cur.q < 32;
  L.mask = L.fast ? ~0u << L.cur.q : 0u;
  L.scale = mlp_filter_pow2(L.fast ? -L.cur.sh : 0);
  bool dbl = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    dbl = dbl && L.cur.fc[k] >= -65536 && L.cur.fc[k] <= 65536 &&
          L.cur.ic[k] >= -65536 && L.cur.ic[k] <= 65536;
    L.fcd[k] = mlp_filter_i2d(L.cur.fc[k]);
    L.icd[k] = mlp_filter_i2d(L.cur.ic[k]);
  }
  L.dbl = dbl;
  if (dbl) {  // the block's first sum and partial sum, in float64
    double acc = 0, part = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const double f = mlp_filter_i2d(L.fs[k]), e = mlp_filter_i2d(L.is[k]);
      acc = fma(L.icd[k], e, fma(L.fcd[k], f, acc));
      if (k > 0) part = fma(L.icd[k - 1], e, fma(L.fcd[k - 1], f, part));
    }
    L.acc = (uint64_t)(int64_t)acc;
    L.part = (uint64_t)(int64_t)part;
  } else {
    uint64_t acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc += mlp_filter_term(L.cur.fc[k], L.fs[k]) +
             mlp_filter_term(L.cur.ic[k], L.is[k]);
    L.acc = acc;
    L.part = mlp_filter_partial(L);
  }
  if (L.nb + 1 < NB) t.load(L.nxt, lane, L.nb + 1, NB);
}

template <class Tables>
DVDA_HD void mlp_filter_begin(MlpFilterLane& L, int lane, int NB, int S,
                              const Tables& t) {
  t.state0(L.fs, L.is, lane);
  L.nb = 0;
  L.i = 0;
  if (S <= 0) {  // no samples: only the resets act
    for (int nb = 0; nb < NB; ++nb) {
      t.load(L.nxt, lane, nb, NB);
      if (L.nxt.rst) {
#pragma unroll
        for (int k = 0; k < 8; ++k) L.is[k] = L.nxt.init[k];
      }
    }
    return;
  }
  if (NB > 0) {
    t.load(L.nxt, lane, 0, NB);
    mlp_filter_enter(L, lane, NB, t);
  }
}

// One sample: its residual in, its output value back.  Call NB * S times.
template <class Tables>
DVDA_HD int32_t mlp_filter_step(MlpFilterLane& L, int lane, int NB, int S,
                                int32_t residual, const Tables& t) {
  if (L.i == S) {
    ++L.nb;
    mlp_filter_enter(L, lane, NB, t);
  }
  const int32_t shifted = (int32_t)((int64_t)L.acc >> L.cur.sh);
  const int32_t x = (int32_t)((uint32_t)shifted + (uint32_t)residual);
  const int32_t value = (int32_t)((uint32_t)(x >> L.cur.q) << L.cur.q);
  if (L.i < L.cur.blen) {
    const int32_t err = (int32_t)((uint32_t)value - (uint32_t)shifted);
    L.acc = L.part + mlp_filter_term(L.cur.fc[7], value) +
            mlp_filter_term(L.cur.ic[7], err);
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      L.fs[k] = L.fs[k + 1];
      L.is[k] = L.is[k + 1];
    }
    L.fs[7] = value;
    L.is[7] = err;
    L.part = mlp_filter_partial(L);
  }
  ++L.i;
  return value;
}

// (int32)(acc >> sh) for 0 <= sh < 32: the low word of a funnel shift
DVDA_HD int32_t mlp_filter_shr(uint64_t acc, int sh) {
#if defined(__CUDA_ARCH__)
  return (int32_t)__funnelshift_r((uint32_t)acc, (uint32_t)(acc >> 32), sh);
#else
  return (int32_t)(uint32_t)(acc >> sh);
#endif
}

// A lane's staged residuals as K1 keeps them: column ``col`` of a tile of
// int32 rows (the residual source of the sample loop: ``res(row)``, and
// ``group(row, v)``, rows [row, row + kFilterGroup)).
struct MlpFilterColumn {
  const int32_t (*tile)[kFilterLanes];
  int col;
  DVDA_HD int32_t operator()(int row) const { return tile[row][col]; }
  DVDA_HD void group(int row, int32_t* v) const {
#pragma unroll
    for (int j = 0; j < kFilterGroup; ++j) v[j] = tile[row + j][col];
  }
};

// How the next kFilterGroup samples of the current block run (entering the
// block first if the last one ended): kFilterLive, all live and float64
// taps, by mlp_filter_run_f64; kFilterFrozen, all past block_len, by
// mlp_filter_frozen; else kFilterSingle, one mlp_filter_step each.  The
// groups start at fixed rows, so the lanes of a warp stay in step.
enum { kFilterSingle = 0, kFilterLive = 1, kFilterFrozen = 2 };
template <class Tables>
DVDA_HD int mlp_filter_group_kind(MlpFilterLane& L, int lane, int NB, int S,
                                  const Tables& t) {
  if (L.i == S) {
    ++L.nb;
    mlp_filter_enter(L, lane, NB, t);
  }
  if (!L.fast || L.i + kFilterGroup > S) return kFilterSingle;
  if (L.i + kFilterGroup <= L.cur.blen)
    return L.dbl ? kFilterLive : kFilterSingle;
  return L.i >= L.cur.blen ? kFilterFrozen : kFilterSingle;
}

// kFilterGroup frozen samples, rows [row, row + kFilterGroup) of the
// lane's staged residuals ``res``: the state and the sum stay.  Each
// value to out[j * B].
template <class Res>
DVDA_HD void mlp_filter_frozen(MlpFilterLane& L, const Res& res, int row,
                               int32_t* __restrict__ out, int B) {
  const int32_t shifted = mlp_filter_shr(L.acc, L.cur.sh);
  int32_t r[kFilterGroup];
  res.group(row, r);
#pragma unroll
  for (int j = 0; j < kFilterGroup; ++j)
    out[(int64_t)j * B] =
        (int32_t)(((uint32_t)shifted + (uint32_t)r[j]) & L.mask);
  L.i += kFilterGroup;
}

// kFilterGroup live samples of one block (L.dbl), rows [row, row + N) of
// the lane's staged residuals; each value to out[j * B].  Same sums as
// mlp_filter_step, in float64, where every product and partial sum is an
// integer below 2^51 and so exact, with the next partial sum split as
//   part' = (taps 0-5 over state entries 2-7) + fc[6]*value + ic[6]*error.
template <class Res>
DVDA_HD void mlp_filter_run_f64(MlpFilterLane& L, const Res& staged, int row,
                                int32_t* __restrict__ out, int B) {
  constexpr int N = kFilterGroup;
  int32_t res[N], f[8 + N], e[8 + N];
  double fd[8 + N], ed[8 + N];
  staged.group(row, res);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    f[k] = L.fs[k];
    e[k] = L.is[k];
    fd[k] = mlp_filter_i2d(f[k]);
    ed[k] = mlp_filter_i2d(e[k]);
  }
  double acc = (double)(int64_t)L.acc, part = (double)(int64_t)L.part;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    // taps 0-5 over state entries 2-7: two multiply-add chains, FIR and
    // IIR, the newest entry last
    double pf = L.fcd[0] * fd[j + 2], pi = L.icd[0] * ed[j + 2];
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      pf = fma(L.fcd[k], fd[j + k + 2], pf);
      pi = fma(L.icd[k], ed[j + k + 2], pi);
    }
    const int32_t shifted = mlp_filter_shr_d(acc, L.scale);
    const int32_t value =
        (int32_t)(((uint32_t)shifted + (uint32_t)res[j]) & L.mask);
    const int32_t err = (int32_t)((uint32_t)value - (uint32_t)shifted);
    const double vd = mlp_filter_i2d(value), errd = mlp_filter_i2d(err);
    acc = fma(L.icd[7], errd, fma(L.fcd[7], vd, part));
    part = fma(L.icd[6], errd, fma(L.fcd[6], vd, pf + pi));
    f[j + 8] = value;
    e[j + 8] = err;
    fd[j + 8] = vd;
    ed[j + 8] = errd;
    out[(int64_t)j * B] = value;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    L.fs[k] = f[N + k];
    L.is[k] = e[N + k];
  }
  L.acc = (uint64_t)(int64_t)acc;
  L.part = (uint64_t)(int64_t)part;
  L.i += N;
}

// Rows [0, rows) of the lane's staged residual tile ``res`` through the
// lane, in groups of kFilterGroup samples where the block allows; each
// value to out[r * B] (out: the tile's first row, this lane).  A group
// lies in one filter block.
static_assert(kFilterRows % kFilterGroup == 0, "groups divide a tile");
template <class Tables, class Res>
DVDA_HD void mlp_filter_tile(MlpFilterLane& L, int lane, int NB, int S,
                             const Tables& t, const Res& res, int rows,
                             int32_t* __restrict__ out, int B) {
  constexpr int G = kFilterGroup;
  for (int r = 0; r < rows; r += G) {
    int32_t* __restrict__ o = out + (int64_t)r * B;
    const int kind = r + G <= rows
                         ? mlp_filter_group_kind(L, lane, NB, S, t)
                         : kFilterSingle;
    if (kind == kFilterLive) {
      mlp_filter_run_f64(L, res, r, o, B);
    } else if (kind == kFilterFrozen) {
      mlp_filter_frozen(L, res, r, o, B);
    } else {
      for (int j = 0; j < G && r + j < rows; ++j)
        o[(int64_t)j * B] = mlp_filter_step(L, lane, NB, S, res(r + j), t);
    }
  }
}

DVDA_HD void mlp_filter_end(const MlpFilterLane& L, int lane,
                            int32_t* __restrict__ fir_state,
                            int32_t* __restrict__ iir_state) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    fir_state[lane * 8 + k] = L.fs[k];
    iir_state[lane * 8 + k] = L.is[k];
  }
}

#if defined(__CUDACC__)
// Staging on the card (K1's and K1a's kernels): kFilterStages residual
// tiles in flight, copied by cp.async.
constexpr int kFilterStages = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Rows [t0, t0 + kFilterRows) of the block's lanes into one stage: 16 bytes
// a copy when ``vec`` (B % 4 == 0 and an aligned base: a quarter-row of 4
// lanes is then all inside B or all outside), else 4 bytes a lane.
__device__ __forceinline__ void stage_tile(int32_t (*dst)[kFilterLanes],
                                           const int32_t* __restrict__ res,
                                           int64_t t0, int64_t T, int B,
                                           int lane0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int u = 0; u < kFilterRows * kFilterLanes / 4 / kFilterLanes; ++u) {
      const int c = tid + u * kFilterLanes, r = c >> 3, q = (c & 7) * 4;
      if (t0 + r < T && lane0 + q < B)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(&dst[r][q])),
                     "l"(res + (t0 + r) * B + lane0 + q));
    }
  } else if (lane0 + tid < B) {
    for (int r = 0; r < kFilterRows && t0 + r < T; ++r)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(&dst[r][tid])),
                   "l"(res + (t0 + r) * B + lane0 + tid));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}
#endif
