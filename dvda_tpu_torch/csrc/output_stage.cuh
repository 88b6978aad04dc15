// K234 bodies: the output half of the uniform chunk program -- LFSR noise,
// bypassed-LSB unpack, rematrix, output shift, WAVE permutation and
// little-endian byte pack, in one pass.  Per (chain, frame)
// output_stage_item / output_stage_set_item read the frame's tables; per
// sample output_stage_channels reads its channels and output_stage_sample
// writes its C_out output words, from the LFSR state stepped to the sample.
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
// builder lays them out.  The output row of (chain b, frame f, sample i) is
// b*period + f*L0 + i: WAV time order.  The output form (``form``) is 3
// or 2 for little-endian 24/16-bit samples ([T_pad, C_out*form] bytes), 4
// for int32 [T_pad, C_out], or kNarrow12 for the 12-bit tier of the narrow
// readback: channel pairs (c0, c1) in 3 bytes ([T_pad, C_out/2*3], even
// C_out).  The narrow 16-bit tier is form 2.  Every sample also reports
// which narrow tiers its values miss (output_stage_misfit).
//
// Semantics are dvda_tpu.ops.rematrix.rematrix_frames_tl followed by
// apply_output_stage_tl and the byte pack of the JAX chunk program.  The
// LFSR is stepped serially from the frame seed (the JAX program expands it
// by GF(2) jump doubling; both give the reference sequence).  Wrapping
// int32 adds and left shifts go through uint32.
#pragma once

#include "dvda_hd.cuh"

DVDA_HD uint32_t dvda_lfsr_step(uint32_t seed) {
  const uint32_t shifted = (seed >> 7) & 0xFFFFu;
  return (seed << 16) ^ shifted ^ (shifted << 5);
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
// and K9 (frame_remix.cuh).
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

// A frame's tables as kOutFrameItems items: 48 coefficients, 12 noise
// coefficients, 6 output channels, 6 quant steps, 6 active flags, 8 output
// shifts, the noise shift.  output_stage_item reads item e of frame fr
// (chain-major index b*fpc + f); output_stage_set_item puts it in place.
// The kernel gives each thread its own items and has all their loads in
// flight before the first store.
constexpr int kOutFrameItems = 87;

DVDA_HD int32_t output_stage_item(
    int64_t fr, int e, const int8_t* __restrict__ frame_nshift,
    const int16_t* __restrict__ mat_coeff,
    const int16_t* __restrict__ mat_noise, const int8_t* __restrict__ mat_out,
    const int8_t* __restrict__ mat_active,
    const int8_t* __restrict__ mat_quant,
    const int8_t* __restrict__ out_shift) {
  if (e < 48) return mat_coeff[fr * 48 + e];
  if (e < 60) return mat_noise[fr * 12 + (e - 48)];
  if (e < 66) return mat_out[fr * 6 + (e - 60)];
  if (e < 72) return mat_quant[fr * 6 + (e - 66)];
  if (e < 78) return mat_active[fr * 6 + (e - 72)];
  if (e < 86) return out_shift[fr * 8 + (e - 78)];
  return frame_nshift[fr];
}

DVDA_HD void output_stage_set_item(DvdaOutFrame& o, int e, int32_t v) {
  if (e < 48)
    o.mats.co[e >> 3][e & 7] = v;
  else if (e < 60)
    o.mats.cn[(e - 48) >> 1][e & 1] = v;
  else if (e < 66)
    o.mats.mo[e - 60] = v;
  else if (e < 72)
    o.mats.mq[e - 66] = v;
  else if (e < 78)
    o.mats.act[e - 72] = v != 0;
  else if (e < 86)
    o.osh[e - 78] = v;
  else
    o.nshift = v;
}

// Chain b's 8 channels at in-chain time t (0 past C_tot).
DVDA_HD void output_stage_channels(const int32_t* __restrict__ series,
                                   int64_t t, int Bc, int C_tot, int b,
                                   int32_t ch[8]) {
  const int32_t* row = series + t * C_tot * Bc + b;
#pragma unroll
  for (int c = 0; c < 8; ++c) ch[c] = c < C_tot ? row[(int64_t)c * Bc] : 0;
}

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
// and the WAVE permutation; its row of C_out values in ``form`` at dst.
// Returns the narrow tiers its values miss (output_stage_misfit, ORed).
DVDA_HD uint32_t output_stage_sample(const DvdaOutFrame& fr, uint32_t seed,
                                     int n_mats, int32_t ch[8], uint32_t bits,
                                     const int8_t* wave_perm, int C_out,
                                     int form, uint8_t* dst) {
  // noise0 = int8(seed >> 15) << nshift, noise1 = int8(seed >> 7) << ...
  const int32_t n0 = (int32_t)((uint32_t)(int32_t)(int8_t)(uint8_t)(
                                   seed >> 15) << fr.nshift);
  const int32_t n1 = (int32_t)((uint32_t)(int32_t)(int8_t)(uint8_t)(
                                   seed >> 7) << fr.nshift);
  dvda_rematrix_sample(fr.mats, n_mats, ch, n0, n1, DvdaBypassBits{bits});
  uint32_t misfit = 0;
  if (form == kNarrow12) {
    // pair j: c0 & 0xFF, (c0 >> 8 & 0xF) | (c1 & 0xF) << 4, c1 >> 4 & 0xFF
    for (int j = 0; j < C_out / 2; ++j) {
      const uint32_t c0 = dvda_output_pick(ch, fr.osh, wave_perm[2 * j]);
      const uint32_t c1 = dvda_output_pick(ch, fr.osh, wave_perm[2 * j + 1]);
      misfit |= output_stage_misfit((int32_t)c0) |
                output_stage_misfit((int32_t)c1);
      dst[3 * j] = (uint8_t)c0;
      dst[3 * j + 1] = (uint8_t)(((c0 >> 8) & 0xFu) | ((c1 & 0xFu) << 4));
      dst[3 * j + 2] = (uint8_t)(c1 >> 4);
    }
    return misfit;
  }
  for (int k = 0; k < C_out; ++k) {
    const uint32_t v = dvda_output_pick(ch, fr.osh, wave_perm[k]);
    misfit |= output_stage_misfit((int32_t)v);
    for (int j = 0; j < form; ++j) dst[k * form + j] = (uint8_t)(v >> (8 * j));
  }
  return misfit;
}
