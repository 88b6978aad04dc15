// CPU build of the kernel bodies, for tests only.
//
// g++ compiles the same lane bodies that nvcc compiles for the card
// (DVDA_HD expands to nothing here), and a serial loop stands in for the
// grid.  tests/test_torch_kernel_bodies.py builds this file into a shared
// library and holds it bit-exact against the plain PyTorch versions.  No
// decode path uses it.
#include <string.h>

#include <vector>

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

template <int kC>
static void huffman_blocks(const HuffmanArgs& a, const uint32_t* words,
                           int64_t n_words, int window_words, int trim,
                           int* counts) {
  // the kernel's blocks of whole chains: each block's window of words
  // staged into a host copy when it fits ``window_words`` (``trim`` words
  // short of its end, to test the redo), else the block reads the track's
  // words; a read outside the window decodes the block again from the
  // track's words.  counts: blocks staged, blocks decoded again.
  const int nb0e = a.NB0 > 0 ? a.NB0 : 1;
  const int chains = huffman_chains_per_block(nb0e, a.nsub);
  const int Bce = a.L / nb0e;
  uint16_t code[kHuffmanCodeRows * 512];
  for (int i = 0; i < kHuffmanCodeRows * 512; ++i)
    code[i] = huffman_code_entry(i >> 9, i & 511);
  std::vector<uint32_t> win;
  for (int c0 = 0; c0 < Bce; c0 += chains) {
    const int nc = Bce - c0 < chains ? Bce - c0 : chains;
    const int n = nc * nb0e * a.nsub;
    int64_t lo = INT64_MAX, hi = INT64_MIN;
    bool ok = true;
    for (int q = 0; q < n; ++q) {
      int l, u;
      int64_t wl, wh;
      huffman_block_sublane(q, c0, nc, nb0e, &l, &u);
      if (huffman_sublane_words(a, l, u, &wl, &wh)) {
        lo = wl < lo ? wl : lo;
        hi = wh > hi ? wh : hi;
      } else {
        ok = false;
      }
    }
    const int64_t lo4 = lo & ~(int64_t)3;
    if (ok && n > 0 && hi - lo4 <= window_words) {
      const int64_t full = ((hi - lo4 + 3) >> 2) * 4;
      win.resize(full - trim > 0 ? full - trim : 1);
      for (size_t w = 0; w < win.size(); ++w)
        win[w] = dvda_word(words, n_words, lo4 + (int64_t)w);
      HuffmanWindowWords W{win.data(), lo4, (uint32_t)win.size(), false};
      for (int q = 0; q < n; ++q) {
        int l, u;
        huffman_block_sublane(q, c0, nc, nb0e, &l, &u);
        huffman_decode_sublane<kC>(l, u, a, code, W);
      }
      ++counts[0];
      if (!W.outside) continue;
      ++counts[1];
    }
    HuffmanGlobalWords G{words, n_words};
    for (int q = 0; q < n; ++q) {
      int l, u;
      huffman_block_sublane(q, c0, nc, nb0e, &l, &u);
      huffman_decode_sublane<kC>(l, u, a, code, G);
    }
  }
}

// window_words < 0: the kernel's budget; trim > 0 stages windows that
// many words short (at least one word).  counts[0]: blocks staged, counts[1]: decoded again.
extern "C" void cpu_huffman_decode(
    const uint32_t* words, int64_t n_words, int64_t word_base,
    const int32_t* bitpos, const int32_t* codebook, const int32_t* lsb_bits,
    const int32_t* offset, const int32_t* quant, const int32_t* nbyp,
    const int8_t* bypk, const int8_t* bypv, int32_t* res, int32_t* byp_field,
    int8_t* byp_slots, int L, int nsub, int C, int S0, int k, int has_burst,
    int NB0, int window_words, int trim, int* counts) {
  const HuffmanArgs a{L,      nsub,     C,        S0,     k,
                      NB0,    has_burst != 0,     word_base,
                      bitpos, codebook, lsb_bits, offset, quant,
                      nbyp,   bypk,     bypv,     res,    byp_field,
                      byp_slots};
  if (window_words < 0) window_words = kHuffmanWindowWords;
  counts[0] = counts[1] = 0;
  switch (C) {
#define DVDA_HUFFMAN_CASE(c)                                            \
  case c:                                                               \
    return huffman_blocks<c>(a, words, n_words, window_words, trim, counts);
    DVDA_HUFFMAN_CASE(1) DVDA_HUFFMAN_CASE(2) DVDA_HUFFMAN_CASE(3)
    DVDA_HUFFMAN_CASE(4) DVDA_HUFFMAN_CASE(5) DVDA_HUFFMAN_CASE(6)
    DVDA_HUFFMAN_CASE(7) DVDA_HUFFMAN_CASE(8)
#undef DVDA_HUFFMAN_CASE
    default:
      return huffman_blocks<0>(a, words, n_words, window_words, trim, counts);
  }
}

extern "C" void cpu_mlp_filter(
    const int32_t* res_tl, const int32_t* rc_fir, const int32_t* rc_iir,
    const int32_t* shift, const int32_t* quant, const uint8_t* iir_reset,
    const int32_t* iir_init, const int32_t* block_len,
    const int32_t* fir_state0, const int32_t* iir_state0, int32_t* out_tl,
    int32_t* fir_state, int32_t* iir_state, int B, int NB, int S) {
  // the kernel's blocks of kFilterLanes lanes, each walking its rows in
  // tiles of kFilterRows staged into a local copy, as the card's shared
  // memory holds them
  const MlpFilterTables t{rc_fir, rc_iir, shift, quant, iir_reset, iir_init,
                          block_len};
  const int64_t T = (int64_t)NB * S;
  int32_t tile[kFilterRows][kFilterLanes];
  for (int lane0 = 0; lane0 < B; lane0 += kFilterLanes) {
    const int nl = B - lane0 < kFilterLanes ? B - lane0 : kFilterLanes;
    MlpFilterLane lanes[kFilterLanes];
    for (int j = 0; j < nl; ++j)
      mlp_filter_begin(lanes[j], lane0 + j, NB, S, t, fir_state0,
                       iir_state0);
    for (int64_t t0 = 0; t0 < T; t0 += kFilterRows) {
      const int rows = T - t0 < kFilterRows ? (int)(T - t0) : kFilterRows;
      for (int r = 0; r < rows; ++r)
        memcpy(tile[r], res_tl + (t0 + r) * B + lane0, 4 * nl);
      for (int j = 0; j < nl; ++j)
        mlp_filter_tile(lanes[j], lane0 + j, NB, S, t, tile, j, rows,
                        out_tl + t0 * B + lane0 + j, B);
    }
    for (int j = 0; j < nl; ++j)
      mlp_filter_end(lanes[j], lane0 + j, fir_state, iir_state);
  }
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
