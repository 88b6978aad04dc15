// CPU build of the kernel bodies, for tests only.
//
// g++ compiles the same lane bodies that nvcc compiles for the card
// (DVDA_HD expands to nothing here), and a serial loop stands in for the
// grid.  tests/test_torch_kernel_bodies.py builds this file into a shared
// library and holds it bit-exact against the plain PyTorch versions.  No
// decode path uses it.
#include <string.h>

#include "c2_decrypt.cuh"
#include "frame_remix.cuh"
#include "general_gather.cuh"
#include "huffman_decode.cuh"
#include "mlp_filter.cuh"
#include "output_stage.cuh"
#include "pcm_unpack.cuh"

extern "C" void cpu_lane_pack(
    const int32_t* res, const int64_t* res_off, const int32_t* lens,
    const int32_t* bidx, const uint8_t* bmask, const int32_t* rc_fir,
    const int32_t* rc_iir, const int32_t* iir_init, const int32_t* shift,
    const int32_t* quant, const uint8_t* iir_reset, int32_t* res_tl,
    int32_t* o_fir, int32_t* o_iir, int32_t* o_init, int32_t* o_shift,
    int32_t* o_quant, uint8_t* o_reset, int32_t* o_blen, int32_t* state0,
    int B, int NB, int S, int n_ch) {
  // the kernel's tiles of whole chains, in order; each tile's lanes
  // resolve their block once per chain position
  const int Bc = B / n_ch, cpt = lane_pack_chains_per_tile(n_ch);
  for (int b0 = 0; b0 < Bc; b0 += cpt) {
    const int lane0 = b0 * n_ch;
    const int nl = (Bc - b0 < cpt ? Bc - b0 : cpt) * n_ch;
    for (int h = 0; h < 2 * nl; ++h)
      dvda_store16(state0 + (int64_t)(lane0 + (h >> 1)) * 8 + 4 * (h & 1),
                   DvdaWords4{});
    for (int nb = 0; nb < NB; ++nb)
      for (int j = 0; j < nl; ++j) {
        const DvdaLaneSource l = lane_pack_source(
            b0 + j / n_ch, j % n_ch, nb, NB, n_ch, res_off, lens, bidx,
            bmask);
        for (int h = 0; h < 2; ++h)
          lane_pack_params(l, (int64_t)(lane0 + j) * NB + nb, h, rc_fir,
                           rc_iir, iir_init, shift, quant, iir_reset, o_fir,
                           o_iir, o_init, o_shift, o_quant, o_reset, o_blen);
        for (int s = 0; s < S; ++s)
          res_tl[((int64_t)nb * S + s) * B + lane0 + j] =
              lane_pack_residual(l, s, res);
      }
  }
}

extern "C" void cpu_series_remix(
    const int32_t* out0, const int64_t* idx0, int nch0, const int32_t* out1,
    const int64_t* idx1, int nch1, const int64_t* frame_start,
    const int32_t* noise01, const uint8_t* bypassed, const int32_t* mat_coeff,
    const int32_t* mat_noise, const int32_t* mat_out,
    const uint8_t* mat_active, const int32_t* mat_quant,
    const int32_t* out_shift, const int32_t* wave_perm, int32_t* out,
    int64_t T, int F, int C_out) {
  for (int64_t t = 0; t < T; ++t)
    series_remix_sample(t, F, C_out, out0, idx0, nch0, out1, idx1,
                        nch1, frame_start, noise01, bypassed, mat_coeff,
                        mat_noise, mat_out, mat_active, mat_quant, out_shift,
                        wave_perm, out);
}

extern "C" void cpu_frame_remix(
    const int32_t* channels, const int32_t* noise, const int32_t* mat_coeff,
    const int32_t* mat_noise, const int32_t* mat_out,
    const uint8_t* mat_active, const int32_t* mat_quant,
    const int32_t* bypassed, const int32_t* out_shift, int32_t* out, int F,
    int L, int C, int C_out, int n_mats, unsigned perm) {
  for (int64_t i = 0; i < (int64_t)F * L; ++i)
    frame_remix_sample(i, L, C, C_out, n_mats, perm, channels, noise,
                       mat_coeff, mat_noise, mat_out, mat_active, mat_quant,
                       bypassed, out_shift, out);
}

extern "C" void cpu_huffman_decode(
    const uint32_t* words, int64_t n_words, int64_t word_base,
    const int32_t* bitpos, const int32_t* codebook, const int32_t* lsb_bits,
    const int32_t* offset, const int32_t* quant, const int32_t* nbyp,
    const int8_t* bypk, const int8_t* bypv, int32_t* res, int32_t* byp_field,
    int8_t* byp_slots, int L, int nsub, int C, int S0, int k, int has_burst,
    int NB0) {
  for (int l = 0; l < L; ++l)
    for (int u = 0; u < nsub; ++u)
      huffman_decode_sublane(l, u, L, nsub, C, S0, k, has_burst != 0, NB0,
                             words, n_words, word_base, bitpos, codebook,
                             lsb_bits, offset, quant, nbyp, bypk, bypv, res,
                             byp_field, byp_slots);
}

extern "C" void cpu_mlp_filter(
    const int32_t* res_tl, const int32_t* rc_fir, const int32_t* rc_iir,
    const int32_t* shift, const int32_t* quant, const uint8_t* iir_reset,
    const int32_t* iir_init, const int32_t* block_len,
    const int32_t* fir_state0, const int32_t* iir_state0, int32_t* out_tl,
    int32_t* fir_state, int32_t* iir_state, int B, int NB, int S) {
  for (int lane = 0; lane < B; ++lane)
    mlp_filter_lane(lane, B, NB, S, res_tl, rc_fir, rc_iir, shift, quant,
                    iir_reset, iir_init, block_len, fir_state0, iir_state0,
                    out_tl, fir_state, iir_state);
}

extern "C" void cpu_output_stage(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, int Bc, int fpc, int L0, int C_tot, int C_out, int n_mats,
    int nbytes) {
  // per (chain, frame): the tables, then the LFSR stepped over the
  // frame's samples, each sample's words straight into its output row
  const int nb = nbytes ? nbytes : 4;
  const int64_t period = (int64_t)fpc * L0;
  for (int b = 0; b < Bc; ++b)
    for (int f = 0; f < fpc; ++f) {
      const int64_t fi = (int64_t)b * fpc + f;
      DvdaOutFrame fr;
      for (int e = 0; e < kOutFrameItems; ++e)
        output_stage_set_item(
            fr, e, output_stage_item(fi, e, frame_nshift, mat_coeff,
                                     mat_noise, mat_out, mat_active,
                                     mat_quant, out_shift));
      uint32_t seed = (uint32_t)frame_seed[fi];
      for (int i = 0; i < L0; ++i) {
        const int64_t t = (int64_t)f * L0 + i;
        int32_t ch[8];
        output_stage_channels(series, t, Bc, C_tot, b, ch);
        output_stage_sample(fr, seed, n_mats, ch,
                            (uint8_t)byp[(int64_t)b * period + t], wave_perm,
                            C_out, nb, out + (b * period + t) * C_out * nb);
        seed = dvda_lfsr_step(seed);
      }
    }
}

extern "C" void cpu_pcm_unpack(const uint8_t* chunks, int64_t n, int csize,
                               int channels, int bits, int nbytes,
                               const int32_t* table, uint8_t* out) {
  DvdaPcmTable t;
  memset(&t, 0xff, sizeof(t));
  memcpy(t.idx, table, sizeof(int32_t) * 3 * 2 * channels);
  for (int64_t i = 0; i < n * 2 * channels; ++i)
    pcm_unpack_slot(i, 2 * channels, csize, bits, nbytes, t, chunks, out);
}

extern "C" void cpu_c2_decrypt(uint8_t* sectors, int64_t n, uint64_t k_au,
                               int preserve_cci, const uint32_t* sbox,
                               const uint32_t* sbox_f) {
  for (int64_t s = 0; s < n; ++s)
    c2_decrypt_sector(sectors + s * DVDA_SECTOR_SIZE, k_au, preserve_cci != 0,
                      sbox, sbox_f);
}
