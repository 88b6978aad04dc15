// CPU build of the kernel bodies, for tests only.
//
// g++ compiles the same lane bodies that nvcc compiles for the card
// (DVDA_HD expands to nothing here), and a serial loop stands in for the
// grid.  tests/test_torch_kernel_bodies.py builds this file into a shared
// library and holds it bit-exact against the plain PyTorch versions.  No
// decode path uses it.
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <vector>

#include "c2_decrypt.cuh"
#include "chunk_filter.cuh"
#include "chunk_lanes.cuh"
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

// K6b as the card runs it: the tiles in order, each tile's phases thread
// by thread -- loads and gathers, the search rounds (each probe of a round
// counted), the pieces (every thread's loads, then its stores, then its
// rows), the 16-byte store items from the staged rows (stale where no row
// lands)
extern "C" void cpu_series_remix(
    const int32_t* out0, const int64_t* idx0, int nch0, const int32_t* out1,
    const int64_t* idx1, int nch1, const int64_t* frame_start,
    const int32_t* noise01, const uint8_t* bypassed, const int32_t* mat_coeff,
    const int32_t* mat_noise, const int32_t* mat_out,
    const uint8_t* mat_active, const int32_t* mat_quant,
    const int32_t* out_shift, const int32_t* wave_perm, int32_t* out,
    int64_t T, int F, int C_out, int* pieces) {
  std::vector<DvdaRemixInputs> in(kRemixThreads);
  std::vector<DvdaRemixPieceLoads> v(kRemixThreads);
  std::vector<DvdaOutFrame> s_fr(kRemixPiece);
  std::vector<int32_t> s_y(kRemixRows * 8);
  int64_t s_start[kRemixPiece + 1];
  *pieces = 0;
  for (int64_t t0 = 0; t0 < T; t0 += kRemixRows) {
    for (int tid = 0; tid < kRemixThreads; ++tid)
      series_remix_loads(tid, t0, T, idx0, idx1, nch1, noise01, bypassed,
                         in[tid]);
    int lo = 0, hi = F - 1;
    while (lo < hi) {
      const int step = series_remix_step(lo, hi);
      int count = 0;
      for (int k = 0; k < kRemixThreads; ++k)
        count += series_remix_probe(k, lo, hi, step, t0, frame_start);
      series_remix_narrow(count, step, lo, hi);
    }
    for (int tid = 0; tid < kRemixThreads; ++tid)
      series_remix_gathers(tid, t0, T, out0, nch0, out1, nch1, in[tid]);
    const int nw = series_remix_words(t0, T, C_out);
    const int64_t t_last = t0 + nw / C_out - 1;
    std::fill(s_y.begin(), s_y.end(), 0x5A5A5A5A);
    for (int pa = lo;; pa += kRemixPiece) {
      const int m = F - pa < kRemixPiece ? F - pa : kRemixPiece;
      for (int tid = 0; tid < kRemixThreads; ++tid)
        series_remix_piece_loads(tid, pa, m, F, frame_start, mat_coeff,
                                 mat_noise, mat_out, mat_active, mat_quant,
                                 out_shift, v[tid]);
      for (int tid = 0; tid < kRemixThreads; ++tid)
        series_remix_piece_stores(tid, m, v[tid], s_start, s_fr.data());
      for (int tid = 0; tid < kRemixThreads; ++tid)
        series_remix_rows(tid, t0, T, m, s_start, s_fr.data(), in[tid],
                          wave_perm, C_out, s_y.data());
      ++*pieces;
      if (m < kRemixPiece || s_start[kRemixPiece] > t_last) break;
    }
    for (int w = 0; 4 * w < nw; ++w)
      series_remix_store(w, t0, nw, C_out, s_y.data(), out);
  }
}

// K9 as the card runs it: the tiles in order, each tile's phases thread
// by thread -- inputs, the pieces (every thread's table loads, then its
// stores, then its rows), the store items from the staged rows -- in the
// instantiation the launcher picks (the channel count, the vector body
// where the bases are aligned).  Returns the most pieces a tile took.
template <int kC, bool kVec>
static int frame_remix_tiles(
    const int32_t* channels, const int32_t* noise, const int32_t* mat_coeff,
    const int32_t* mat_noise, const int32_t* mat_out,
    const uint8_t* mat_active, const int32_t* mat_quant,
    const int32_t* bypassed, const int32_t* out_shift, int32_t* out,
    int64_t n, int L, int C, int C_out, int n_mats, unsigned perm) {
  std::vector<DvdaK9Row> in(kK9Threads);
  std::vector<DvdaK9PieceLoads> v(kK9Threads);
  std::vector<DvdaOutFrame> s_fr(kK9Piece);
  std::vector<uint32_t> s_byp(6 * kK9Threads);
  std::vector<uint32_t> s_pick(kK9Rows * kK9PickPitch);
  int most = 0;
  for (int64_t blk = 0; blk * kK9Rows < n; ++blk) {
    const DvdaK9Tile tl = frame_remix_tile(blk, n, L);
    std::fill(s_pick.begin(), s_pick.end(), 0x5A5A5A5Au);
    for (int tid = 0; tid < kK9Threads; ++tid)
      frame_remix_inputs<kC, kVec>(tid, tl, L, C, channels, noise, in[tid]);
    int pieces = 0;
    for (int pa = 0; pa < tl.nf; pa += kK9Piece, ++pieces) {
      const int m = tl.nf - pa < kK9Piece ? tl.nf - pa : kK9Piece;
      for (int tid = 0; tid < kK9Threads; ++tid)
        frame_remix_piece_loads(tid, tl.f0 + pa, m, C, n_mats, mat_coeff,
                                mat_noise, mat_out, mat_active, mat_quant,
                                out_shift, v[tid]);
      for (int tid = 0; tid < kK9Threads; ++tid)
        frame_remix_piece_stores(tid, m, v[tid], s_fr.data());
      for (int tid = 0; tid < kK9Threads; ++tid)
        frame_remix_rows(tid, tl, pa, m, s_fr.data(), L, n_mats, bypassed,
                         in[tid], s_byp.data(),
                         s_pick.data() + tid * kK9PickPitch);
    }
    most = std::max(most, pieces);
    for (int w = 0; 4 * w < tl.nrows * C_out; ++w)
      frame_remix_store<kVec>(w, tl, C_out, perm, s_pick.data(), out);
  }
  return most;
}

extern "C" int cpu_frame_remix(
    const int32_t* channels, const int32_t* noise, const int32_t* mat_coeff,
    const int32_t* mat_noise, const int32_t* mat_out,
    const uint8_t* mat_active, const int32_t* mat_quant,
    const int32_t* bypassed, const int32_t* out_shift, int32_t* out, int F,
    int L, int C, int C_out, int n_mats, unsigned perm, int* vec) {
  const int64_t n = (int64_t)F * L;
  const int kc = frame_remix_kc(C);
  *vec = frame_remix_vec(kc, channels, noise, out);
#define DVDA_K9_TILES(KC, VEC)                                            \
  frame_remix_tiles<KC, VEC>(channels, noise, mat_coeff, mat_noise,       \
                             mat_out, mat_active, mat_quant, bypassed,    \
                             out_shift, out, n, L, C, C_out, n_mats, perm)
#define DVDA_K9_CASE(KC) \
  return *vec ? DVDA_K9_TILES(KC, true) : DVDA_K9_TILES(KC, false)
  if (kc == 8) DVDA_K9_CASE(8);
  DVDA_K9_CASE(0);
#undef DVDA_K9_CASE
#undef DVDA_K9_TILES
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
    int NB0, int64_t res_stride, int64_t lane0, int window_words, int trim,
    int* counts) {
  const HuffmanArgs a{L,      nsub,     C,        S0,     k,
                      NB0,    has_burst != 0,     word_base,
                      bitpos, codebook, lsb_bits, offset, quant,
                      nbyp,   bypk,     bypv,     res,    byp_field,
                      byp_slots, res_stride, lane0};
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

// K10: the kernel's grid in order.  Returns -1 where the kernel's entry
// would refuse the descriptor.
extern "C" int cpu_chunk_lanes(const int64_t* desc, int64_t n_words,
                               const int32_t* a4, const int16_t* a2,
                               const int8_t* a1, int32_t* out32) {
  if (n_words * 8 != (int64_t)sizeof(ChunkLanesDesc)) return -1;
  ChunkLanesDesc d;
  memcpy(&d, desc, sizeof d);
  if (!chunk_lanes_desc_ok(d)) return -1;
  const ChunkArenas A{a4, a2, a1};
  const int64_t blocks = chunk_lanes_plan(d);
  for (int64_t blk = 0; blk < blocks; ++blk) {
    int64_t e0;
    const ChunkLanesSub& s = d.sub[chunk_lanes_locate(d, blk, &e0)];
    for (int k = 0; k < kChunkLanesPerThread; ++k)
      for (int tid = 0; tid < kChunkLanesThreads; ++tid) {
        const int64_t e = e0 + (int64_t)k * kChunkLanesThreads + tid;
        if (e < s.elems) chunk_lanes_element(s, A, (int32_t)e, out32);
      }
  }
  return 0;
}

// K1a on one filter group: the kernel's variant for the descriptor, its
// blocks of kFilterLanes lanes, each thread's lane resolved as on the
// card, its residual tile staged as the kernel stages it (the granules
// memcpy'd into a raw area and unstaged, or one load a row; or K5's rows
// copied in), then K1's sample loop through the arena policy.
template <bool kUsual, int kResW>
static void chunk_filter_group(const ChunkLanesDesc& d, const ChunkArenas& A,
                               const int64_t* n, const int32_t* res_tl,
                               int32_t* out_tl, int ldo, int B, int NB,
                               int S) {
  const int T = NB * S;
  int32_t tile[kFilterRows][kFilterLanes];
  static unsigned char raw[kFilterLanes][kChunkRawBytes];
  for (int lane0 = 0; lane0 < B; lane0 += kFilterLanes) {
    const int nl = B - lane0 < kFilterLanes ? B - lane0 : kFilterLanes;
    std::vector<ChunkFilterTables<kUsual>> t(nl);
    std::vector<ChunkFilterStaging> st(nl);
    std::vector<bool> granules(nl);
    MlpFilterLane lanes[kFilterLanes];
    for (int j = 0; j < nl; ++j) {
      int c, b;
      const int i = chunk_filter_locate(d, lane0 + j, &c, &b);
      ChunkFilterSource src;
      chunk_filter_lane(d.sub[i], A, c, b, &t[j], &src);
      mlp_filter_begin(lanes[j], lane0 + j, NB, S, t[j]);
      if (kResW != 0) {
        const int w = chunk_filter_w<kResW>(src);
        st[j] = chunk_filter_staging<kResW>(
            A, src, n[w == 4 ? 0 : w == 2 ? 1 : 2] * w);
        granules[j] = chunk_filter_granules_ok(st[j], S);
      }
    }
    for (int t0 = 0; t0 < T; t0 += kFilterRows) {
      const int rows = T - t0 < kFilterRows ? T - t0 : kFilterRows;
      int32_t* out = out_tl + (int64_t)t0 * ldo + lane0;
      if (kResW == 0) {
        for (int r = 0; r < rows; ++r)
          memcpy(tile[r], res_tl + (int64_t)(t0 + r) * B + lane0, 4 * nl);
        for (int j = 0; j < nl; ++j)
          mlp_filter_tile(lanes[j], lane0 + j, NB, S, t[j],
                          MlpFilterColumn{tile, j}, rows, out + j, ldo);
        continue;
      }
      for (int j = 0; j < nl; ++j) {
        memset(raw[j], 0xA5, kChunkRawBytes);
        if (granules[j])
          chunk_filter_granules<kResW>(
              st[j], S, t0, rows, [&](int pos, int off, int len) {
                if (pos + 16 > kChunkRawBytes) abort();  // the card's bound
                memcpy(raw[j] + pos, st[j].at + off, len);
              });
        else
          chunk_filter_rows<kResW>(st[j], S, t0, rows, raw[j]);
      }
      for (int j = 0; j < nl; ++j)
        mlp_filter_tile(
            lanes[j], lane0 + j, NB, S, t[j],
            chunk_filter_runs<kResW>(raw[j], st[j], S, t0, granules[j]),
            rows, out + j, ldo);
    }
  }
}

// K1a's entry on the CPU: the kernel entry's checks and its choice of
// variant.  Returns -1 where the kernel's entry would refuse.
extern "C" int cpu_chunk_filter(const int64_t* desc, int64_t n_words,
                                const int32_t* a4, const int16_t* a2,
                                const int8_t* a1, int64_t n4, int64_t n2,
                                int64_t n1, const int32_t* res_tl,
                                int32_t* out_tl, int B, int NB, int S,
                                int ldo) {
  if (n_words * 8 != (int64_t)sizeof(ChunkLanesDesc)) return -1;
  ChunkLanesDesc d;
  memcpy(&d, desc, sizeof d);
  if (!chunk_filter_desc_ok(d, B, NB, S, res_tl != nullptr) || ldo < B)
    return -1;
  const ChunkArenas A{a4, a2, a1};
  const int64_t n[3] = {n4, n2, n1};
  const int rw = chunk_filter_res_width(d, res_tl != nullptr);
  if (!chunk_filter_usual(d)) {
    if (rw == 0)
      chunk_filter_group<false, 0>(d, A, n, res_tl, out_tl, ldo, B, NB, S);
    else
      chunk_filter_group<false, kChunkResAny>(d, A, n, res_tl, out_tl, ldo,
                                              B, NB, S);
  } else if (rw == 0) {
    chunk_filter_group<true, 0>(d, A, n, res_tl, out_tl, ldo, B, NB, S);
  } else if (rw == 2) {
    chunk_filter_group<true, 2>(d, A, n, res_tl, out_tl, ldo, B, NB, S);
  } else if (rw == 4) {
    chunk_filter_group<true, 4>(d, A, n, res_tl, out_tl, ldo, B, NB, S);
  } else {
    chunk_filter_group<false, kChunkResAny>(d, A, n, res_tl, out_tl, ldo,
                                            B, NB, S);
  }
  return 0;
}

// K1 as the card runs it, in each layout of dvda_mlp_filter
// (kFilterTimeLeading, kFilterLaneIn at C channels a frame): the kernel's
// blocks of kFilterLanes lanes, each walking its rows in tiles of
// kFilterRows staged into a local copy as the card's shared memory holds
// them (a [rows, lanes] tile, or lane-major at kFilterRowPitch), each
// lane's output through the kernel's writer (mlp_filter_writer).  Returns
// -1 where the kernel's entry would refuse (mlp_filter_layout_ok).
extern "C" int cpu_mlp_filter(
    const int32_t* res, const int32_t* rc_fir, const int32_t* rc_iir,
    const int32_t* shift, const int32_t* quant, const uint8_t* iir_reset,
    const int32_t* iir_init, const int32_t* block_len,
    const int32_t* fir_state0, const int32_t* iir_state0, int32_t* out,
    int32_t* fir_state, int32_t* iir_state, int B, int NB, int S,
    int layout, int C) {
  if (!mlp_filter_layout_ok(layout, B, C)) return -1;
  const MlpFilterTables t{rc_fir,   rc_iir,   shift,     quant,     iir_reset,
                          iir_init, block_len, fir_state0, iir_state0};
  const int64_t T = (int64_t)NB * S;
  const bool lane_in = layout == kFilterLaneIn;
  int32_t tile[kFilterRows][kFilterLanes];
  alignas(16) int32_t rows_of[kFilterLanes][kFilterRowPitch];
  for (int lane0 = 0; lane0 < B; lane0 += kFilterLanes) {
    const int nl = B - lane0 < kFilterLanes ? B - lane0 : kFilterLanes;
    MlpFilterLane lanes[kFilterLanes];
    for (int j = 0; j < nl; ++j)
      mlp_filter_begin(lanes[j], lane0 + j, NB, S, t);
    for (int64_t t0 = 0; t0 < T; t0 += kFilterRows) {
      const int rows = T - t0 < kFilterRows ? (int)(T - t0) : kFilterRows;
      if (lane_in) {
        for (int j = 0; j < nl; ++j)
          memcpy(rows_of[j], res + (lane0 + j) * T + t0, 4 * rows);
      } else {
        for (int r = 0; r < rows; ++r)
          memcpy(tile[r], res + (t0 + r) * B + lane0, 4 * nl);
      }
      for (int j = 0; j < nl; ++j) {
        const int lane = lane0 + j;
        const MlpFilterWriter w = mlp_filter_writer(layout, lane, T, B, C);
        int32_t* o = out + w.base + t0 * w.stride;
        if (lane_in)
          mlp_filter_tile(lanes[j], lane, NB, S, t, MlpFilterRow{rows_of[j]},
                          rows, o, w.stride);
        else
          mlp_filter_tile(lanes[j], lane, NB, S, t, MlpFilterColumn{tile, j},
                          rows, o, w.stride);
      }
    }
    for (int j = 0; j < nl; ++j)
      mlp_filter_end(lanes[j], lane0 + j, fir_state, iir_state);
  }
  return 0;
}

// K234 as the card runs it: the grid's tiles in order, each tile's phases
// thread by thread (every thread's loads, then its shared stores, then the
// strip seeds, each thread's samples into the staged runs -- stale where
// no sample lands -- and the 16-byte store items); returns the OR of the
// samples' misfit bits
template <int kForm>
static uint32_t output_stage_chunk(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, int Bc, int fpc, int L0, int C_tot, int C_out,
    int n_mats) {
  const int row = output_stage_row_bytes(C_out, kForm);
  const int nx = fpc * output_stage_strips(L0);
  const int ny = (Bc + kOutTileChains - 1) / kOutTileChains;
  std::vector<DvdaOutFrame> s_fr(kOutTileChains);
  std::vector<uint32_t> s_out(kOutTileChains * kOutPitch);
  std::vector<uint8_t> s_byp(kOutTileChains * kOutStrip);
  std::vector<uint32_t> s_seed(kOutTileChains);
  std::vector<DvdaOutInputs> in(kOutThreads);
  int8_t s_perm[8];
  memcpy(s_perm, wave_perm, C_out);
  uint32_t misfit = 0;
  for (int y = 0; y < ny; ++y)
    for (int x = 0; x < nx; ++x) {
      const DvdaOutTile t = output_stage_tile(x, y, Bc, fpc, L0, row);
      for (int tid = 0; tid < kOutThreads; ++tid) {
        output_stage_inputs(tid, t, series, Bc, C_tot, in[tid]);
        DvdaOutTableLoads tab;
        output_stage_table_loads(tid, t, fpc, frame_nshift, mat_coeff,
                                 mat_noise, mat_out, mat_active, mat_quant,
                                 out_shift, tab);
        uint8_t bv[kOutBypPasses];
        output_stage_byp_loads(tid, t, byp, bv);
        output_stage_table_stores(tid, t, tab, s_fr.data());
        output_stage_byp_stores(tid, bv, s_byp.data());
      }
      for (int c = 0; c < kOutTileChains; ++c)
        s_seed[c] = dvda_lfsr_at(
            output_stage_frame_seed(c, t, fpc, frame_seed), t.i0);
      memset(s_out.data(), 0xA5, s_out.size() * 4);
      uint32_t slot[8];
      for (int tid = 0; tid < kOutThreads; ++tid)
        misfit |= output_stage_samples<kForm>(
            tid, t, in[tid], s_fr.data(), s_seed.data(), s_byp.data(), s_perm,
            n_mats, C_out, slot, s_out.data());
      const int items = t.nct * output_stage_vectors(t);
      for (int k = 0; k < items; ++k)
        output_stage_store(k, t, s_out.data(), out);
    }
  return misfit;
}

// The LFSR state i steps after each seed by the kernel's jump
// (dvda_lfsr_at, steps 0), or by i single steps (dvda_lfsr_step, steps 1),
// for the tests to hold one against the other
extern "C" void cpu_lfsr_at(const uint32_t* seeds, int n, int64_t i,
                            int steps, uint32_t* out) {
  for (int k = 0; k < n; ++k) {
    uint32_t s = seeds[k];
    if (steps)
      for (int64_t j = 0; j < i; ++j) s = dvda_lfsr_step(s);
    else
      s = dvda_lfsr_at(s, i);
    out[k] = s;
  }
}

extern "C" void cpu_output_stage(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, int Bc, int fpc, int L0, int C_tot, int C_out, int n_mats,
    int nbytes) {
  auto chunk = nbytes == 2   ? output_stage_chunk<2>
               : nbytes == 3 ? output_stage_chunk<3>
                             : output_stage_chunk<4>;
  chunk(series, frame_seed, frame_nshift, byp, mat_coeff, mat_noise, mat_out,
        mat_active, mat_quant, out_shift, wave_perm, out, Bc, fpc, L0, C_tot,
        C_out, n_mats);
}

// K234n: the narrow rows of ``tier`` (12 or 16), then the 8 flag rows
extern "C" void cpu_output_stage_narrow(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, int Bc, int fpc, int L0, int C_tot, int C_out, int n_mats,
    int tier) {
  const int form = tier == 16 ? 2 : kNarrow12;
  const uint32_t misfit =
      (tier == 16 ? output_stage_chunk<2> : output_stage_chunk<kNarrow12>)(
          series, frame_seed, frame_nshift, byp, mat_coeff, mat_noise,
          mat_out, mat_active, mat_quant, out_shift, wave_perm, out, Bc, fpc,
          L0, C_tot, C_out, n_mats);
  const int64_t rows = (int64_t)Bc * fpc * L0 * output_stage_row_bytes(C_out,
                                                                       form);
  memset(out + rows, output_stage_narrow_flag(misfit, tier),
         8 * output_stage_row_bytes(C_out, form));
}

// K8 as the card runs it: tiles of DVDA_PCM_TILE chunks staged in turn
// into two buffers (a ragged tile leaves the rest of its buffer stale),
// each tile's 16-byte vectors built from the sources of their position in
// the period and stored, the last one cut at the output's end
extern "C" void cpu_pcm_unpack(const uint8_t* chunks, int64_t n, int csize,
                               int channels, int bits, int nbytes,
                               const int32_t* table, uint8_t* out) {
  DvdaPcmTable t;
  memset(&t, 0xff, sizeof(t));
  memcpy(t.idx, table, sizeof(int32_t) * 3 * 2 * channels);
  const DvdaPcmGeom g = pcm_geom(csize, channels, bits, nbytes);
  std::vector<DvdaPcmVec> src(g.period_v);
  for (int pv = 0; pv < g.period_v; ++pv)
    src[pv] = pcm_vector_sources(g, t, pv);
  std::vector<uint8_t> buf(2 * DVDA_PCM_TILE_BYTES, 0xA5);
  const int64_t tile_out = (int64_t)DVDA_PCM_TILE * g.slots * g.ob;
  const int64_t out_end = n * g.slots * g.ob;
  for (int64_t tile = 0; tile * DVDA_PCM_TILE < n; ++tile) {
    uint8_t* in = buf.data() + (tile & 1) * DVDA_PCM_TILE_BYTES;
    const int64_t nc = std::min<int64_t>(n - tile * DVDA_PCM_TILE,
                                         DVDA_PCM_TILE);
    memcpy(in, chunks + tile * DVDA_PCM_TILE * csize, nc * csize);
    const int64_t base = tile * tile_out;
    const int64_t end = std::min(out_end - base, tile_out);
    for (int64_t v = 0; 16 * v < end; ++v)
      pcm_store_vector(out + base, 16 * v, end,
                       pcm_vector(in + (v / g.period_v) * g.period_in,
                                  src[v % g.period_v]));
  }
}

// K7 as the card runs it: blocks of 32 sectors staged into a tile of
// DVDA_C2_PITCH-word rows (the rest of the tile stale), the sectors' first
// 128 bytes first, the 32 lanes' kinds and content keys from those alone,
// then the rest of the rows and each lane's D-CBC and CCI walk, which
// write the batch directly
extern "C" void cpu_c2_decrypt(uint8_t* sectors, int64_t n, uint64_t k_au,
                               int preserve_cci, const uint32_t* sbox,
                               const uint32_t* sbox_f) {
  uint32_t key4[256], mixf[256];
  for (int j = 0; j < 256; ++j) {
    key4[j] = c2_derive_table(0, j, sbox, sbox_f);
    mixf[j] = c2_derive_table(1, j, sbox, sbox_f);
  }
  const C2Tables t{key4, mixf};
  std::vector<uint32_t> tile(DVDA_C2_LANES * DVDA_C2_PITCH, 0xA5A5A5A5u);
  for (int64_t first = 0; first < n; first += DVDA_C2_LANES) {
    const int ns = (int)(n - first < DVDA_C2_LANES ? n - first
                                                   : DVDA_C2_LANES);
    uint8_t* batch = sectors + first * DVDA_SECTOR_SIZE;
    for (int s = 0; s < ns; ++s)
      memcpy(c2_tile_row(tile.data(), s), batch + s * DVDA_SECTOR_SIZE,
             DVDA_C2_HEAD);
    int kind[DVDA_C2_LANES];
    uint64_t key[DVDA_C2_LANES];
    for (int lane = 0; lane < ns; ++lane) {
      const uint8_t* sec = c2_tile_row(tile.data(), lane);
      kind[lane] = c2_sector_kind(sec);
      key[lane] = kind[lane] == 2 ? c2_content_key(sec, k_au, t) : 0;
    }
    for (int s = 0; s < ns; ++s)
      memcpy(c2_tile_row(tile.data(), s) + DVDA_C2_HEAD,
             batch + s * DVDA_SECTOR_SIZE + DVDA_C2_HEAD,
             DVDA_SECTOR_SIZE - DVDA_C2_HEAD);
    for (int lane = 0; lane < ns; ++lane)
      c2_decrypt_rest(c2_tile_row(tile.data(), lane),
                      batch + lane * DVDA_SECTOR_SIZE, kind[lane],
                      key[lane], preserve_cci != 0, t);
  }
}
