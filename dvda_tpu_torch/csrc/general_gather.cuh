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
// K6b series_remix_sample -- output row t of the general path: the sample's
// channels from K1's outputs (out_s [NB_s, S_s, B_s], channel 0 of t at
// flat index idx_s[t], channel c at + c), zero past the streams' channels;
// the frame of t by binary search in frame_start [F+1]; noise01 [T, 2] and
// the packed bypassed bits [T]; then that frame's matrix chain
// (dvda_rematrix_sample, shared with K234) over all 6 slots and the output
// shift + WAVE permutation; int32 [T, C_out].  Frame tables are the parse's
// int32 arrays: mat_coeff [F,6,8], mat_noise [F,6,2], mat_out, mat_quant
// [F,6], mat_active uint8 [F,6], out_shift [F,8]; wave_perm int32 [C_out].
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

DVDA_HD void series_remix_sample(
    int64_t t, int F, int C_out,
    const int32_t* __restrict__ out0, const int64_t* __restrict__ idx0,
    int nch0, const int32_t* __restrict__ out1,
    const int64_t* __restrict__ idx1, int nch1,
    const int64_t* __restrict__ frame_start,
    const int32_t* __restrict__ noise01, const uint8_t* __restrict__ bypassed,
    const int32_t* __restrict__ mat_coeff,
    const int32_t* __restrict__ mat_noise,
    const int32_t* __restrict__ mat_out,
    const uint8_t* __restrict__ mat_active,
    const int32_t* __restrict__ mat_quant,
    const int32_t* __restrict__ out_shift,
    const int32_t* __restrict__ wave_perm, int32_t* __restrict__ out) {
  // the frame of t: the last f with frame_start[f] <= t (empty frames are
  // passed over, as dvda_tpu's repeat(arange(F), frame_len) does)
  int lo = 0, hi = F - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (frame_start[mid] <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int64_t f = lo;

  int32_t ch[8];
  const int64_t i0 = idx0[t];
  const int64_t i1 = nch1 ? idx1[t] : 0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    ch[c] = c < nch0 ? out0[i0 + c]
            : c < nch0 + nch1 ? out1[i1 + (c - nch0)] : 0;

  DvdaFrameMats mats;
#pragma unroll
  for (int m = 0; m < 6; ++m) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      mats.co[m][c] = mat_coeff[(f * 6 + m) * 8 + c];
    mats.cn[m][0] = mat_noise[(f * 6 + m) * 2];
    mats.cn[m][1] = mat_noise[(f * 6 + m) * 2 + 1];
    mats.mo[m] = mat_out[f * 6 + m];
    mats.mq[m] = mat_quant[f * 6 + m];
    mats.act[m] = mat_active[f * 6 + m] != 0;
  }
  int osh[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) osh[c] = out_shift[f * 8 + c];

  dvda_rematrix_sample(mats, 6, ch, noise01[2 * t], noise01[2 * t + 1],
                       DvdaBypassBits{bypassed[t]});
  for (int k = 0; k < C_out; ++k)
    out[t * C_out + k] = (int32_t)dvda_output_pick(ch, osh, wave_perm[k]);
}
