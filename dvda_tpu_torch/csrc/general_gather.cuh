// K6 bodies: the gathers of the MLP general path around the AR filter.
//
// K6a lane pack -- K1's inputs for one substream, gathered from the parse's
// per-block arrays by the chain table ``bidx``:
//   res       int32 ragged residuals, (block, channel, sample) order, block
//             blk's channel c at res_off[blk] + c*lens[blk] (the parse's
//             own layout: [NBt, n_ch, S] without the zero padding)
//   res_off   int64 [NBt]    lens int32 [NBt]
//   bidx      int32 [Bc, NB] block of chain b's position nb (clamped)
//   bmask     uint8 [Bc, NB] position nb < chain b's length
//   rc_fir, rc_iir, iir_init  int32 [NBt, n_ch, 8]  (16-byte aligned)
//   shift, quant  int32 [NBt, n_ch]      iir_reset uint8 [NBt, n_ch]
// Lane = b*n_ch + c (chain-major, channel-minor: dvda_tpu's lane order),
// n_ch in 1..8.  Outputs, in K1's call layout (B = Bc*n_ch lanes):
//   res_tl    int32 [NB, S, B]  (0 at samples >= the block's length)
//   o_fir, o_iir, o_init  int32 [B, NB, 8]
//   o_shift, o_quant  int32 [B, NB]   o_reset uint8 [B, NB] (& bmask)
//   o_blen    int32 [B, NB] (lens[blk] under bmask, else 0)
//   state0    int32 [B, 8] zeros
// Per lane and chain position nb: lane_pack_source resolves the block once
// (residual offset, length, table row, live flag); lane_pack_residual is
// its sample s; lane_pack_params writes half h of parameter row lane*NB +
// nb (4 words of each 8-word table; h = 0 also the four scalars).  A tile
// is lane_pack_chains_per_tile(n_ch) whole chains, at most
// kLanePackLanes lanes.
//
// K6b -- output rows of the general path, int32 [T, C_out]: row t's
// channels from K1's outputs (out_s [NB_s, S_s, B_s], channel 0 of t at
// flat index idx_s[t], channel c at + c), zero past the streams' channels;
// noise01 [T, 2] and the packed bypassed bits [T]; the frame of t, the last
// f with frame_start[f] <= t (frame_start [F+1], empty frames passed over,
// as dvda_tpu's repeat(arange(F), frame_len)); that frame's matrix chain
// (dvda_rematrix_sample, shared with K234 and K9) over all 6 slots and the
// output shift + WAVE permutation (dvda_output_pick).  Frame tables are
// the parse's int32 arrays: mat_coeff [F,6,8], mat_noise [F,6,2], mat_out,
// mat_quant [F,6], mat_active uint8 [F,6], out_shift [F,8]; wave_perm
// int32 [C_out].
//
// A tile is kRemixRows consecutive rows from t0, run by kRemixThreads
// threads (row t0 + tid + r * kRemixThreads of thread tid).  Its phases:
// series_remix_loads (indices, noise, bypass bits) and, once the indices
// land, series_remix_gathers; the tile's first frame by one search of the
// whole block (series_remix_probe: each round every thread probes one
// frame start, and the count of probes at or before t0 narrows the range
// 256-fold); then pieces of kRemixPiece frames from there
// (series_remix_piece_loads / _stores: their starts and tables into shared
// memory), each running the rows whose frame it holds
// (series_remix_rows), until a piece ends past the tile; the rows staged
// in shared memory go out as 16-byte vectors (series_remix_store).
#pragma once

#include "dvda_hd.cuh"
#include "output_stage.cuh"

constexpr int kLanePackLanes = 128;

DVDA_HD int lane_pack_chains_per_tile(int n_ch) {
  return kLanePackLanes / n_ch;
}

// Where lane (b, c) reads at chain position nb.
struct DvdaLaneSource {
  int64_t base;  // residual index of the lane's sample 0 in its block
  int32_t len;   // the block's length
  int32_t src;   // row of the per-block tables: blk*n_ch + c
  int32_t live;  // nb < the chain's length
};

DVDA_HD DvdaLaneSource lane_pack_source(
    int b, int c, int nb, int NB, int n_ch,
    const int64_t* __restrict__ res_off, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ bidx, const uint8_t* __restrict__ bmask) {
  const int64_t bi = (int64_t)b * NB + nb;
  const int blk = bidx[bi];
  DvdaLaneSource l;
  l.len = lens[blk];
  l.base = res_off[blk] + (int64_t)c * l.len;
  l.src = blk * n_ch + c;
  l.live = bmask[bi] != 0;
  return l;
}

DVDA_HD int32_t lane_pack_residual(const DvdaLaneSource& l, int s,
                                   const int32_t* __restrict__ res) {
  return s < l.len ? res[l.base + s] : 0;
}

DVDA_HD void lane_pack_params(
    const DvdaLaneSource& l, int64_t row, int h,
    const int32_t* __restrict__ rc_fir, const int32_t* __restrict__ rc_iir,
    const int32_t* __restrict__ iir_init, const int32_t* __restrict__ shift,
    const int32_t* __restrict__ quant, const uint8_t* __restrict__ iir_reset,
    int32_t* __restrict__ o_fir, int32_t* __restrict__ o_iir,
    int32_t* __restrict__ o_init, int32_t* __restrict__ o_shift,
    int32_t* __restrict__ o_quant, uint8_t* __restrict__ o_reset,
    int32_t* __restrict__ o_blen) {
  const int64_t from = (int64_t)l.src * 8 + 4 * h, to = row * 8 + 4 * h;
  // every load before the first store: they are all in flight at once
  const DvdaWords4 fir = dvda_load16(rc_fir + from);
  const DvdaWords4 iir = dvda_load16(rc_iir + from);
  const DvdaWords4 init = dvda_load16(iir_init + from);
  int32_t sh = 0, q = 0;
  uint8_t rst = 0;
  if (h == 0) {
    sh = shift[l.src];
    q = quant[l.src];
    rst = iir_reset[l.src];
  }
  dvda_store16(o_fir + to, fir);
  dvda_store16(o_iir + to, iir);
  dvda_store16(o_init + to, init);
  if (h == 0) {
    o_shift[row] = sh;
    o_quant[row] = q;
    o_reset[row] = (l.live && rst != 0) ? 1 : 0;
    o_blen[row] = l.live ? l.len : 0;
  }
}

constexpr int kRemixThreads = 256;  // threads of a tile
constexpr int kRemixRows = 512;     // rows of a tile
constexpr int kRemixPer = kRemixRows / kRemixThreads;  // rows a thread
constexpr int kRemixPiece = 16;     // frames staged at once

// Thread tid's rows' inputs.
struct DvdaRemixInputs {
  int64_t i0[kRemixPer], i1[kRemixPer];
  int32_t n0[kRemixPer], n1[kRemixPer];
  uint32_t byp[kRemixPer];
  int32_t ch[kRemixPer][8];
};

DVDA_HD int64_t series_remix_row(int tid, int r, int64_t t0) {
  return t0 + tid + (int64_t)r * kRemixThreads;
}

DVDA_HD void series_remix_loads(int tid, int64_t t0, int64_t T,
                                const int64_t* __restrict__ idx0,
                                const int64_t* __restrict__ idx1, int nch1,
                                const int32_t* __restrict__ noise01,
                                const uint8_t* __restrict__ bypassed,
                                DvdaRemixInputs& in) {
#pragma unroll
  for (int r = 0; r < kRemixPer; ++r) {
    const int64_t t = series_remix_row(tid, r, t0);
    const bool live = t < T;
    in.i0[r] = live ? idx0[t] : 0;
    in.i1[r] = live && nch1 ? idx1[t] : 0;
    in.n0[r] = live ? noise01[2 * t] : 0;
    in.n1[r] = live ? noise01[2 * t + 1] : 0;
    in.byp[r] = live ? bypassed[t] : 0u;
  }
}

DVDA_HD void series_remix_gathers(int tid, int64_t t0, int64_t T,
                                  const int32_t* __restrict__ out0, int nch0,
                                  const int32_t* __restrict__ out1, int nch1,
                                  DvdaRemixInputs& in) {
#pragma unroll
  for (int r = 0; r < kRemixPer; ++r) {
    const bool live = series_remix_row(tid, r, t0) < T;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      in.ch[r][c] = !live          ? 0
                    : c < nch0        ? out0[in.i0[r] + c]
                    : c < nch0 + nch1 ? out1[in.i1[r] + (c - nch0)]
                                      : 0;
  }
}

// A round of the first-frame search over [lo, hi]: thread k probes frame
// lo + k * step, step = ceil((hi - lo + 1) / kRemixThreads); the probes at
// or before t0 are a prefix (frame_start is sorted; frame 0 counts as at
// or before any t0), and their count narrows [lo, hi] to one step
// (series_remix_narrow).
DVDA_HD int series_remix_step(int lo, int hi) {
  return (hi - lo) / kRemixThreads + 1;
}

DVDA_HD bool series_remix_probe(int k, int lo, int hi, int step, int64_t t0,
                                const int64_t* __restrict__ frame_start) {
  const int64_t f = lo + (int64_t)k * step;
  return f <= hi && (f == 0 || frame_start[f] <= t0);
}

DVDA_HD void series_remix_narrow(int count, int step, int& lo, int& hi) {
  const int64_t top = lo + (int64_t)count * step - 1;
  hi = top < hi ? (int)top : hi;
  lo += (count - 1) * step;
}

// A piece: frames pa .. pa + m - 1 (m = min(kRemixPiece, F - pa)).  Its
// starts s_start[j] = frame_start[pa + j] for j <= m (INT64_MAX past F;
// frame 0 holds every row before frame 1, as the search has it),
// and its tables: load pass p of an array of kN elements a frame takes
// element u = tid + p * kRemixThreads of the piece's m * kN (all
// contiguous).
template <int kN>
constexpr int kRemixPasses = (kRemixPiece * kN + kRemixThreads - 1) /
                             kRemixThreads;

struct DvdaRemixPieceLoads {
  int64_t start;
  int32_t co[kRemixPasses<48>], cn[kRemixPasses<12>],
      mo[kRemixPasses<6>], mq[kRemixPasses<6>],
      act[kRemixPasses<6>], osh[kRemixPasses<8>];
};

template <int kN, class T>
DVDA_HD void series_remix_table_load(int tid, int pa, int m,
                                     const T* __restrict__ src, int32_t* v) {
#pragma unroll
  for (int p = 0; p < kRemixPasses<kN>; ++p) {
    const int u = tid + p * kRemixThreads;
    v[p] = u < m * kN ? (int32_t)src[(int64_t)pa * kN + u] : 0;
  }
}

DVDA_HD void series_remix_piece_loads(
    int tid, int pa, int m, int F, const int64_t* __restrict__ frame_start,
    const int32_t* __restrict__ mat_coeff,
    const int32_t* __restrict__ mat_noise,
    const int32_t* __restrict__ mat_out,
    const uint8_t* __restrict__ mat_active,
    const int32_t* __restrict__ mat_quant,
    const int32_t* __restrict__ out_shift, DvdaRemixPieceLoads& v) {
  v.start = tid > kRemixPiece || pa + tid > F ? INT64_MAX
            : pa + tid == 0                   ? INT64_MIN  // frame 0 from t = 0
                                              : frame_start[pa + tid];
  series_remix_table_load<48>(tid, pa, m, mat_coeff, v.co);
  series_remix_table_load<12>(tid, pa, m, mat_noise, v.cn);
  series_remix_table_load<6>(tid, pa, m, mat_out, v.mo);
  series_remix_table_load<6>(tid, pa, m, mat_quant, v.mq);
  series_remix_table_load<6>(tid, pa, m, mat_active, v.act);
  series_remix_table_load<8>(tid, pa, m, out_shift, v.osh);
}

// Stored into K234's frame record (output_stage_put; nshift unused).
template <int kN, int kArr>
DVDA_HD void series_remix_table_store(int tid, int m, const int32_t* v,
                                      DvdaOutFrame* s_fr) {
#pragma unroll
  for (int p = 0; p < kRemixPasses<kN>; ++p) {
    const int u = tid + p * kRemixThreads, c = u / kN;
    if (u < m * kN) output_stage_put<kArr>(s_fr[c], u - c * kN, v[p]);
  }
}

DVDA_HD void series_remix_piece_stores(int tid, int m,
                                       const DvdaRemixPieceLoads& v,
                                       int64_t* s_start,
                                       DvdaOutFrame* s_fr) {
  if (tid <= kRemixPiece) s_start[tid] = v.start;
  series_remix_table_store<48, kOutCo>(tid, m, v.co, s_fr);
  series_remix_table_store<12, kOutCn>(tid, m, v.cn, s_fr);
  series_remix_table_store<6, kOutMo>(tid, m, v.mo, s_fr);
  series_remix_table_store<6, kOutMq>(tid, m, v.mq, s_fr);
  series_remix_table_store<6, kOutAct>(tid, m, v.act, s_fr);
  series_remix_table_store<8, kOutOsh>(tid, m, v.osh, s_fr);
}

// Thread tid's rows whose frame the piece of m frames holds (s_start[0] <=
// t < s_start[m]): the frame by binary search in s_start, the matrix
// chain and the output stage, the row staged at s_y[(t - t0) * C_out].
DVDA_HD void series_remix_rows(int tid, int64_t t0, int64_t T, int m,
                               const int64_t* s_start,
                               const DvdaOutFrame* s_fr,
                               DvdaRemixInputs& in, const int32_t* perm,
                               int C_out, int32_t* s_y) {
#pragma unroll
  for (int r = 0; r < kRemixPer; ++r) {
    const int64_t t = series_remix_row(tid, r, t0);
    if (t >= T || t < s_start[0] || t >= s_start[m]) continue;
    int lo = 0, hi = m - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_start[mid] <= t)
        lo = mid;
      else
        hi = mid - 1;
    }
    const DvdaOutFrame& fr = s_fr[lo];
    dvda_rematrix_sample(fr.mats, 6, in.ch[r], in.n0[r], in.n1[r],
                         DvdaBypassBits{in.byp[r]});
    int32_t* dst = s_y + (t - t0) * C_out;
    for (int k = 0; k < C_out; ++k)
      dst[k] = (int32_t)dvda_output_pick(in.ch[r], fr.osh, perm[k]);
  }
}

// Store item v of the tile: words 4v .. 4v + 3 of its staged rows, whole
// where all four lie in the tile (its first word is 16-byte aligned:
// kRemixRows * C_out is a multiple of 4), else word by word.
DVDA_HD int series_remix_words(int64_t t0, int64_t T, int C_out) {
  return (int)((T - t0 < kRemixRows ? T - t0 : kRemixRows) * C_out);
}

DVDA_HD void series_remix_store(int v, int64_t t0, int nw, int C_out,
                                const int32_t* s_y,
                                int32_t* __restrict__ out) {
  int32_t* dst = out + t0 * C_out + 4 * v;
  if (4 * v + 4 <= nw) {
    dvda_store16(dst, dvda_load16(s_y + 4 * v));
    return;
  }
  for (int w = 4 * v; w < nw; ++w) out[t0 * C_out + w] = s_y[w];
}
