// K1a: the MLP AR filter of a uniform chunk, reading its inputs from the
// chunk arenas.
//
// Replaces the filter call of dvda_tpu's chunk program
// (codecs/mlp/native_engine.py:219-222) together with the part of the
// front end before it (:111-267) that makes the filter's inputs: the
// residuals widened and transposed time-leading, the parameter rows
// packed and broadcast over each chain's blocks, iir_reset, block_len and
// the zero states are never written to device memory.  Bound: K1's
// dependent chain (mlp_filter.cu); its bytes fall to what it must move
// (at the headline chunk 2.07 MB of arenas in, 3.93 MB out).  The design
// is K1's (one thread a lane, a warp a block, the sample loop of
// mlp_filter.cuh), with two changes:
//   * the parameter policy (ChunkFilterTables) reads a lane's block from
//     its arena row one block ahead, at widths fixed at compile time for
//     the arena builders' dtypes (a kernel variant; any other widths take
//     the variant that reads each width at run time);
//   * in standard mode each thread stages its own lane: the residual rows
//     of a tile are one run per filter block (adjacent lanes lie
//     NB0*n_ch*S0 elements apart, so a warp's loads of one row touch 32
//     cache lines), copied as their 16-byte granules by cp.async into the
//     lane's raw area two tiles ahead, and the sample loop reads them
//     there at their width (ChunkFilterRuns), with no widening pass.  In
//     device Huffman K5's int32 buffer is staged as K1 stages its input.
// The granules are not widened into an int32 tile once they land: that
// pass, a shared-memory load and store a row that the compiler may not
// reorder, costs more than the staging saves.  Nor does K10 write the
// standard chunk's residuals time-leading for K1a to stage as K5's: that
// extra launch made the chunk program slower on the card and per call
// (PERF.md §6).
#include <cuda_runtime.h>
#include <string.h>

#include "chunk_filter.cuh"

namespace {

// One granule of a lane's residual rows into its raw area: 16 bytes, of
// which the first n are read (the arena's last granule), by cp.async.
struct GranuleCopy {
  unsigned char* raw;
  const unsigned char* at;
  __host__ __device__ void operator()(int pos, int off, int n) const {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(raw + pos)),
                 "l"(at + off), "r"(n));
#endif
  }
};

// K1a: the filter of one filter group of a uniform chunk, its inputs read
// from the chunk arenas (chunk_filter.cuh, ChunkFilterTables).  The sample
// loop is K1's, over a 3-stage ring of 32-row residual tiles staged two
// tiles ahead: with K5's time-leading output (kResW 0, device Huffman)
// by stage_tile into int32 tiles, as K1; else each thread stages its own
// lane from the arenas into its raw area (chunk_filter_granules: 16-byte
// cp.async of the granules holding its rows; or, for S0 below
// kChunkGranuleMinS0 or an arena off 16 bytes, one load a row), where
// the sample loop reads them at their width (ChunkFilterRuns).
template <bool kUsual, int kResW>
__global__ void __launch_bounds__(kFilterLanes) mlp_filter_arena_kernel(
    const __grid_constant__ ChunkLanesDesc d, const ChunkArenas A,
    int64_t n4, int64_t n2, int64_t n1, int B, int NB, int S,
    const int32_t* __restrict__ res_tl, bool vec,
    int32_t* __restrict__ out_tl) {
  constexpr bool kStaged = kResW == 0;
  // int32 tiles (K5's residuals) or each lane's raw area, 16 bytes more
  // than kChunkRawBytes: lane areas 68 words apart, not 64 (bank
  // conflicts)
  constexpr int kStageBytes = kStaged ? kFilterRows * kFilterLanes * 4
                                      : kFilterLanes * (kChunkRawBytes + 16);
  __shared__ __align__(16) unsigned char
      s_stage[kFilterStages][kStageBytes];
  const int lane0 = blockIdx.x * kFilterLanes;
  const int tid = threadIdx.x, lane = lane0 + tid;
  const bool live = lane < B;
  const int T = NB * S;
  const int tiles = (T + kFilterRows - 1) / kFilterRows;
  ChunkFilterTables<kUsual> t;
  ChunkFilterSource src;
  ChunkFilterStaging st{};
  if (live) {
    int c, b;
    // the substream by a constant index, the descriptor read in place
    switch (chunk_filter_locate(d, lane, &c, &b)) {
      case 0: chunk_filter_lane(d.sub[0], A, c, b, &t, &src); break;
      case 1: chunk_filter_lane(d.sub[1], A, c, b, &t, &src); break;
      case 2: chunk_filter_lane(d.sub[2], A, c, b, &t, &src); break;
      default: chunk_filter_lane(d.sub[3], A, c, b, &t, &src);
    }
    if constexpr (!kStaged) {
      const int w = chunk_filter_w<kResW>(src);
      st = chunk_filter_staging<kResW>(
          A, src, w == 4 ? n4 * 4 : w == 2 ? n2 * 2 : n1);
    }
  }
  const bool granules = !kStaged && live && chunk_filter_granules_ok(st, S);
  auto tile_of = [&](int q) {
    return reinterpret_cast<int32_t(*)[kFilterLanes]>(s_stage[q]);
  };
  auto raw_of = [&](int q) {
    return s_stage[q] + tid * (kChunkRawBytes + 16);
  };
  // tile j into stage q, then the commit
  auto stage = [&](int q, int j) {
    const int t0 = j * kFilterRows, rows = min(kFilterRows, T - t0);
    if constexpr (kStaged) {
      stage_tile(tile_of(q), res_tl, t0, T, B, lane0, vec);
    } else {
      if (rows > 0 && granules)
        chunk_filter_granules<kResW>(st, S, t0, rows,
                                     GranuleCopy{raw_of(q), st.at});
      else if (rows > 0 && live)
        chunk_filter_rows<kResW>(st, S, t0, rows, raw_of(q));
      asm volatile("cp.async.commit_group;\n" ::);
    }
  };
#pragma unroll
  for (int q = 0; q < kFilterStages - 1; ++q) stage(q, q);
  MlpFilterLane L;
  if (live) mlp_filter_begin(L, lane, NB, S, t);
  for (int k = 0; k < tiles; ++k) {
    // the tile kFilterStages - 1 ahead goes into the stage read two tiles
    // ago
    const int ahead = k + kFilterStages - 1;
    stage(ahead % kFilterStages, ahead);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFilterStages - 1));
    __syncthreads();
    const int t0 = k * kFilterRows;
    const int rows = min(kFilterRows, T - t0);
    int32_t* __restrict__ out = out_tl + (int64_t)t0 * B + lane;
    const int q = k % kFilterStages;
    if (live) {
      if constexpr (kStaged)
        mlp_filter_tile(L, lane, NB, S, t, MlpFilterColumn{tile_of(q), tid},
                        rows, out, B);
      else
        mlp_filter_tile(L, lane, NB, S, t,
                        chunk_filter_runs<kResW>(raw_of(q), st, S, t0,
                                                 granules),
                        rows, out, B);
    }
    __syncthreads();
  }
}

}  // namespace

// K1a on one filter group: ``desc`` the group's ChunkLanesDesc (its
// substreams in lane order), arenas of n4 / n2 / n1 elements, ``res_tl``
// K5's [NB, S, B] residuals or null (standard mode: the arenas'),
// ``out_tl`` [NB, S, B].  Returns -1 where the descriptor is not
// ChunkLanesDesc's size or does not describe B lanes of blocks [NB, S];
// else launches on ``stream`` and returns cudaGetLastError().  Never
// synchronises and allocates nothing.
extern "C" int dvda_chunk_filter(const int64_t* desc, int64_t n_words,
                                 const int32_t* a4, const int16_t* a2,
                                 const int8_t* a1, int64_t n4, int64_t n2,
                                 int64_t n1, const int32_t* res_tl,
                                 int32_t* out_tl, int B, int NB, int S,
                                 void* stream) {
  if (n_words * 8 != (int64_t)sizeof(ChunkLanesDesc)) return -1;
  ChunkLanesDesc d;
  memcpy(&d, desc, sizeof d);
  if (!chunk_filter_desc_ok(d, B, NB, S, res_tl != nullptr)) return -1;
  if (B <= 0) return 0;
  const bool vec = B % 4 == 0 && (uintptr_t)res_tl % 16 == 0;
  const int blocks = (B + kFilterLanes - 1) / kFilterLanes;
  const ChunkArenas A{a4, a2, a1};
  // the variant: the arena builders' parameter widths and residuals of
  // one width (K5's, int16, int32), else any widths
  auto run = [&](auto kernel) {
    kernel<<<blocks, kFilterLanes, 0, (cudaStream_t)stream>>>(
        d, A, n4, n2, n1, B, NB, S, res_tl, vec, out_tl);
  };
  const int rw = chunk_filter_res_width(d, res_tl != nullptr);
  if (!chunk_filter_usual(d))
    run(rw == 0 ? mlp_filter_arena_kernel<false, 0>
                : mlp_filter_arena_kernel<false, kChunkResAny>);
  else if (rw == 0)
    run(mlp_filter_arena_kernel<true, 0>);
  else if (rw == 2)
    run(mlp_filter_arena_kernel<true, 2>);
  else if (rw == 4)
    run(mlp_filter_arena_kernel<true, 4>);
  else
    run(mlp_filter_arena_kernel<false, kChunkResAny>);
  return (int)cudaGetLastError();
}
