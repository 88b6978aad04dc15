// K1a's bodies: the AR filter of a uniform chunk, reading its inputs
// from the chunk arenas (dvda_tpu native_engine.py:219-222 after the
// :111-267 front end), built on K1's sample loop (mlp_filter.cuh).
//
// A lane of a filter group (the substreams of one (NB0, S0), fused on the
// lane axis in the order of ops/chunk_lanes.py's layout) is lane
// u = c*Bc + b of one substream of the group's ChunkLanesDesc
// (chunk_lanes.cuh): channel c of chain b.  Its parameters and residuals
// are read where the chunk arenas hold them, at each array's own width,
// with dvda_tpu's front-end semantics (:128-129, :192-213): the per-chain
// row b*n_ch + c for every block, or block nb's row (b*NB0 + nb)*n_ch +
// c; iir_reset kept in block 0 only when per chain; block_len = S0; zero
// initial states.
#pragma once

#include "chunk_lanes.cuh"
#include "dvda_hd.cuh"
#include "mlp_filter.cuh"

// The widths are template parameters where they are known: a width read
// at run time puts a branch around every load, and in the sample loop's
// block entry (28 loads, inlined at each of its call sites) those
// branches tripled the code and its divergence barriers.  kUsual: the
// parameter arrays at the arena builders' widths (int16 taps, int32
// init, int8 shift, quant and reset; chunk_filter_usual), else each at
// its own width.  kResW: the residuals' width (4, 2 or 1), 0 where K5's
// int32 buffer holds them, or kChunkResAny: each substream's own.
constexpr int kChunkResAny = -1;

// An arena element at ``p``, sign-extended: of width kW, or w where kW is
// 0.
template <int kW>
DVDA_HD int32_t chunk_filter_ld(const unsigned char* p, int w, int64_t i) {
  const int ww = kW ? kW : w;
  return ww == 4   ? ((const int32_t*)p)[i]
         : ww == 2 ? (int32_t)((const int16_t*)p)[i]
                   : (int32_t)((const int8_t*)p)[i];
}

// The parameter policy of one lane: each array at the lane's first row
// (a byte pointer into its arena), the six widths packed 4 bits each
// (read only when not kUsual), and the rows between two of the lane's
// blocks (0 per chain).  Kept small: it is live through the whole sample
// loop.
template <bool kUsual>
struct ChunkFilterTables {
  const unsigned char *fir, *iir, *init, *shift, *quant, *reset;
  int32_t widths, step, S0;

  DVDA_HD int w(int k) const { return (widths >> (4 * k)) & 15; }

  DVDA_HD void load(MlpFilterBlock& p, int, int nb, int) const {
    constexpr int kTap = kUsual ? 2 : 0, kInit = kUsual ? 4 : 0,
                  kByte = kUsual ? 1 : 0;
    const int64_t r = (int64_t)nb * step;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      p.fc[k] = chunk_filter_ld<kTap>(fir, w(0), r * 8 + k);
      p.ic[k] = chunk_filter_ld<kTap>(iir, w(1), r * 8 + k);
      p.init[k] = chunk_filter_ld<kInit>(init, w(2), r * 8 + k);
    }
    p.sh = chunk_filter_ld<kByte>(shift, w(3), r);
    p.q = chunk_filter_ld<kByte>(quant, w(4), r);
    p.blen = S0;
    p.rst = (step != 0 || nb == 0) &&
            chunk_filter_ld<kByte>(reset, w(5), r) != 0;
  }

  DVDA_HD void state0(int32_t* fs, int32_t* is, int) const {
#pragma unroll
    for (int k = 0; k < 8; ++k) fs[k] = is[k] = 0;
  }
};

// A lane's residuals in the arenas: row t = nb*S0 + s of lane (c, b) is
// element res.off + ((b*NB0 + nb)*n_ch + c)*S0 + s, i.e. runs of S0
// elements ``stride`` = n_ch*S0 apart.
struct ChunkFilterSource {
  ChunkArray res;  // offset of the lane's row 0
  int32_t stride;
};

DVDA_HD const unsigned char* chunk_arena_bytes(const ChunkArenas& A,
                                               int64_t width) {
  return width == 4   ? (const unsigned char*)A.a4
         : width == 2 ? (const unsigned char*)A.a2
                      : (const unsigned char*)A.a1;
}

// Whether d describes a filter group of B lanes of blocks [NB, S]: 1-4
// substreams of that (NB0, S0) whose n_ch*Bc lanes sum to B, every
// parameter array present and, unless K5 supplies them (``staged``), the
// residuals too; T = NB*S and the lanes within 32-bit indices.
DVDA_HD bool chunk_filter_desc_ok(const ChunkLanesDesc& d, int B, int NB,
                                  int S, bool staged) {
  if (d.n_subs < 1 || d.n_subs > kChunkLanesMaxSubs || B < 0 || NB < 0 ||
      S < 0 || (int64_t)NB * S >= (1LL << 31) - kFilterRows)
    return false;
  int64_t lanes = 0;
  for (int i = 0; i < d.n_subs; ++i) {
    const ChunkLanesSub& s = d.sub[i];
    if (s.NB0 != NB || s.S0 != S || s.Bc < 1 || s.n_ch < 1 ||
        (int64_t)NB * s.n_ch * S * 4 + 64 >= (1LL << 31))  // 32-bit lanes
      return false;
    const ChunkArray* need[] = {&s.rc_fir, &s.rc_iir, &s.iir_init, &s.shift,
                                &s.quant,  &s.iir_reset, &s.res};
    for (int k = 0; k < (staged ? 6 : 7); ++k)
      if (need[k]->width != 1 && need[k]->width != 2 && need[k]->width != 4)
        return false;
    lanes += s.n_ch * s.Bc;
  }
  return lanes == B;
}

// Whether every substream of d has the arena builders' parameter widths
// (int16 taps, int32 init, int8 shift, quant and reset).
DVDA_HD bool chunk_filter_usual(const ChunkLanesDesc& d) {
  for (int i = 0; i < d.n_subs; ++i) {
    const ChunkLanesSub& s = d.sub[i];
    if (s.rc_fir.width != 2 || s.rc_iir.width != 2 || s.iir_init.width != 4 ||
        s.shift.width != 1 || s.quant.width != 1 || s.iir_reset.width != 1)
      return false;
  }
  return true;
}

// The residual width of K1a's variant for d: 0 with K5's buffer
// (``staged``), else the substreams' common width, or kChunkResAny.
DVDA_HD int chunk_filter_res_width(const ChunkLanesDesc& d, bool staged) {
  if (staged) return 0;
  for (int i = 1; i < d.n_subs; ++i)
    if (d.sub[i].res.width != d.sub[0].res.width) return kChunkResAny;
  return (int)d.sub[0].res.width;
}

// Substream s's lane (c, b): its parameter policy and residual source.
template <bool kUsual>
DVDA_HD void chunk_filter_lane(const ChunkLanesSub& s, const ChunkArenas& A,
                               int c, int b, ChunkFilterTables<kUsual>* t,
                               ChunkFilterSource* src) {
  const int64_t n_ch = s.n_ch, NB0 = s.NB0;
  const int64_t row = s.per_chain ? b * n_ch + c : b * NB0 * n_ch + c;
  const ChunkArray* x[6] = {&s.rc_fir, &s.rc_iir, &s.iir_init,
                            &s.shift,  &s.quant,  &s.iir_reset};
  const unsigned char* at[6];
  int32_t widths = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int64_t per_row = k < 3 ? 8 : 1;
    at[k] = chunk_arena_bytes(A, x[k]->width) +
            (x[k]->off + row * per_row) * x[k]->width;
    widths |= (int32_t)x[k]->width << (4 * k);
  }
  *t = ChunkFilterTables<kUsual>{at[0], at[1],  at[2],
                                 at[3], at[4],  at[5],
                                 widths, s.per_chain ? 0 : (int32_t)n_ch,
                                 (int32_t)s.S0};
  src->res = ChunkArray{s.res.off + (b * NB0 * n_ch + c) * s.S0, s.res.width};
  src->stride = (int32_t)(n_ch * s.S0);
}

// The substream of lane ``lane`` of a filter group and its place there:
// returns the substream's index in d and sets (c, b).  The substreams lie
// end to end on the lane axis, each n_ch*Bc lanes, in d's order.
DVDA_HD int chunk_filter_locate(const ChunkLanesDesc& d, int lane, int* c,
                                int* b) {
  int i = 0, u = lane;
  // constant indices into d.sub (a runtime index puts the descriptor on
  // the stack)
#pragma unroll
  for (int j = 0; j + 1 < kChunkLanesMaxSubs; ++j) {
    const int n = (int)(d.sub[j].n_ch * d.sub[j].Bc);
    if (i == j && j + 1 < d.n_subs && u >= n) {
      u -= n;
      i = j + 1;
    }
  }
  int Bc;
  switch (i) {
    case 0: Bc = (int)d.sub[0].Bc; break;
    case 1: Bc = (int)d.sub[1].Bc; break;
    case 2: Bc = (int)d.sub[2].Bc; break;
    default: Bc = (int)d.sub[3].Bc;
  }
  *c = u / Bc;
  *b = u - *c * Bc;
  return i;
}

// Staging a lane's residual rows [t0, t0 + rows) of a 32-row tile (kResW
// not 0) into the lane's raw area of a stage, kChunkRawBytes, where the
// sample loop reads them as they are (ChunkFilterRuns: no widening pass),
// in one of two ways (the kernel and the CPU harness run the same code):
//  * granules, where S0 >= kChunkGranuleMinS0 and the arena starts on 16
//    bytes: the 16-byte granules that hold the rows' runs (one run per
//    filter block the tile touches, at most 3) are copied in order (on
//    the card by 16-byte cp.async, the last granule of the arena cut at
//    its end).  A few wide copies a tile, where one element a load costs
//    a warp-wide load instruction a row, each of 32 cache lines;
//  * rows, else: one load per row, row r at byte r*w (one run).
constexpr int kChunkGranuleMinS0 = 16;
constexpr int kChunkRawBytes = 256;  // 32 rows x 4 bytes + 3 runs' slack

// The lane's residual width: kResW, or its own where kResW is
// kChunkResAny.
template <int kResW>
DVDA_HD int chunk_filter_w(const ChunkFilterSource& src) {
  return kResW == kChunkResAny ? (int)src.res.width : kResW;
}

// A lane's residuals for staging, with 32-bit offsets from here on:
// ``at`` the 16-byte granule that holds its row 0 (on 16 bytes where the
// arena is), ``lead`` row 0's byte in it, ``left`` the arena's bytes
// from ``at`` on (capped at 2^31 - 1), ``stride`` the elements between
// its blocks, ``w`` its width.  chunk_filter_desc_ok keeps a lane's
// offsets within 32 bits.
struct ChunkFilterStaging {
  const unsigned char* at;
  int32_t lead, left, stride, w;
};

template <int kResW>
DVDA_HD ChunkFilterStaging chunk_filter_staging(const ChunkArenas& A,
                                                const ChunkFilterSource& src,
                                                int64_t arena_bytes) {
  const int w = chunk_filter_w<kResW>(src);
  const int64_t b = src.res.off * w, left = arena_bytes - (b & ~15LL);
  return ChunkFilterStaging{chunk_arena_bytes(A, w) + (b & ~15LL),
                            (int32_t)(b & 15),
                            (int32_t)(left < 2147483647 ? left : 2147483647),
                            src.stride, w};
}

DVDA_HD bool chunk_filter_granules_ok(const ChunkFilterStaging& st, int S0) {
  return S0 >= kChunkGranuleMinS0 && ((uintptr_t)st.at & 15) == 0;
}

// For each granule of the lane's rows [t0, t0 + rows), in order:
// copy(raw byte, the granule's byte offset from st.at, bytes to copy).
template <int kResW, class Copy>
DVDA_HD void chunk_filter_granules(const ChunkFilterStaging& st, int S0,
                                   int t0, int rows, Copy copy) {
  const int w = kResW == kChunkResAny ? st.w : kResW;
  int nb = t0 / S0, s = t0 - nb * S0, pos = 0;
  for (int r = 0; r < rows;) {
    const int n = S0 - s < rows - r ? S0 - s : rows - r;
    const int b0 = st.lead + (nb * st.stride + s) * w;
    for (int g = b0 >> 4; g < (b0 + n * w + 15) >> 4; ++g, pos += 16) {
      const int left = st.left - g * 16;
      copy(pos, g * 16, left < 16 ? left : 16);
    }
    r += n;
    s = 0;
    ++nb;
  }
}

// A lane's staged residual tile in its raw area, read in place: rows
// [0, r1), [r1, r2) and [r2, 32) are three runs at raw byte offsets o0,
// o1, o2, each row at its arena width (sign-extended as it is read).  A
// group of rows lies in one filter block, so in one run.
template <int kResW>
struct ChunkFilterRuns {
  static constexpr int kW = kResW == kChunkResAny ? 0 : kResW;
  const unsigned char* raw;
  int o0, o1, o2, r1, r2, w;

  DVDA_HD const unsigned char* at(int row) const {
    const int ww = kW ? kW : w;
    return raw + (row < r1   ? o0 + row * ww
                  : row < r2 ? o1 + (row - r1) * ww
                             : o2 + (row - r2) * ww);
  }
  DVDA_HD int32_t operator()(int row) const {
    return chunk_filter_ld<kW>(at(row), w, 0);
  }
  DVDA_HD void group(int row, int32_t* v) const {
    const unsigned char* p = at(row);
#pragma unroll
    for (int j = 0; j < kFilterGroup; ++j) v[j] = chunk_filter_ld<kW>(p, w, j);
  }
};

// The runs that read the lane's staged rows [t0, ...): as
// chunk_filter_granules lays them out, or (``granules`` false) one run of
// rows r at byte r*w, as chunk_filter_rows does.
template <int kResW>
DVDA_HD ChunkFilterRuns<kResW> chunk_filter_runs(const unsigned char* raw,
                                                 const ChunkFilterStaging& st,
                                                 int S0, int t0,
                                                 bool granules) {
  const int w = kResW == kChunkResAny ? st.w : kResW;
  if (!granules)
    return ChunkFilterRuns<kResW>{raw, 0, 0, 0, kFilterRows, kFilterRows, w};
  const int nb = t0 / S0, s = t0 - nb * S0;
  int o[3], pos = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int b0 = st.lead + ((nb + k) * st.stride + (k ? 0 : s)) * w;
    const int n = k ? S0 : S0 - s;
    o[k] = pos + (b0 & 15);
    pos += (((b0 + n * w + 15) >> 4) - (b0 >> 4)) * 16;
  }
  return ChunkFilterRuns<kResW>{raw, o[0], o[1], o[2], S0 - s, 2 * S0 - s,
                                w};
}

// Rows [t0, t0 + rows) of the lane's residuals, one load a row, into its
// raw area at their width, row r at byte r*w.
template <int kResW>
DVDA_HD void chunk_filter_rows(const ChunkFilterStaging& st, int S0, int t0,
                               int rows, unsigned char* raw) {
  const int w = kResW == kChunkResAny ? st.w : kResW;
  const unsigned char* row0 = st.at + st.lead;
  int nb = t0 / S0, s = t0 - nb * S0;
  for (int r = 0; r < rows; ++r) {
    const int i = nb * st.stride + s;
    if (w == 4)
      ((int32_t*)raw)[r] = ((const int32_t*)row0)[i];
    else if (w == 2)
      ((int16_t*)raw)[r] = ((const int16_t*)row0)[i];
    else
      ((int8_t*)raw)[r] = ((const int8_t*)row0)[i];
    if (++s == S0) {
      s = 0;
      ++nb;
    }
  }
}
