// K6: the gathers of the MLP general path on the card, around K1.
//
// Replaces dvda_tpu/codecs/mlp/native_engine.py::_pipeline (:502-556), the
// jitted program dvda_tpu runs on streams its pipelined chunk driver
// abandons (geometry churn, coupled restarts, non-uniform chains): the lane
// pack by ``bidx`` (:520-532), then -- after the AR filter, which stays K1
// -- the series gather by ``series_idx`` (:539), the frame gather by
// ``frame_idx`` (:546-551), rematrix_frames + apply_output_stage
// (ops/rematrix.py:33-63, :113-121) and the ``flat_idx`` gather (:556).
//
// K6a (lane_pack_kernel): a 2-D grid of (chain position nb, tile of whole
// chains, at most 128 lanes), 256 threads a block.  Bound: bytes (a
// gather: each output written once, each input read about once; 374 MB at
// the churn disc).  The design keeps every access a full sector:
//   * the tile's lanes resolve their block (offset, length, table row) once
//     into shared memory, with 32-bit index arithmetic;
//   * a chain's n_ch x len residuals are contiguous in the parse's ragged
//     layout: a warp reads each lane's run along s, the block transposes
//     them through a shared [rows][129] tile (conflict-free both ways, in
//     strips of 64 rows for any S), and a warp stores each row
//     res_tl[nb, s, lane0 : lane0 + 128] along the lanes;
//   * a warp has 8 lanes' loads in flight before its first shared store
//     (with one load in flight a warp waits out the memory latency per
//     lane, and the gather does not reach the card's memory rate);
//   * each 32-byte parameter row goes out as two 16-byte vector stores;
//   * the blocks at nb = 0 zero the tile's initial state.
// It reads the ragged residuals through per-block offsets, so the host
// never builds a padded copy.
//
// K6b (series_remix_kernel): a block per tile of 512 consecutive output
// rows, 256 threads.  Bound: bytes (per 5.1 sample 16 B of indices, 24 B
// of channels, 8 B of noise, 1 B of bits in, 24 B out; 222 MB at the
// churn disc).  The design (general_gather.cuh's tile bodies):
//   * a thread issues its rows' index, noise and bit loads first, then,
//     after the search below, its channel gathers (all 16 in flight);
//   * the tile's first frame by one search of the whole block, 256 probes
//     a round (two rounds at 36,000 frames), not a binary search a thread;
//     replaces dvda_tpu's frame_idx / flat_idx gathers (they exist to give
//     XLA static frame-major shapes);
//   * the tables of 16 frames from there staged in shared memory at once
//     (loaded with the frame starts, before the rows' frames are known),
//     walked in pieces where short or empty frames put more in a tile;
//     consecutive rows share a frame, so a warp's table reads broadcast;
//   * the tile's [512, C_out] rows staged in shared memory and stored as
//     16-byte vectors.
#include <cuda_runtime.h>

#include "general_gather.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = kLanePackLanes + 1;  // tile row, in words
constexpr int kRows = 64;                   // residual rows per strip
constexpr int kBatch = 8;                   // lanes a warp loads at once

__global__ void __launch_bounds__(kThreads) lane_pack_kernel(
    int Bc, int NB, int S, int n_ch, int cpt,
    const int32_t* __restrict__ res, const int64_t* __restrict__ res_off,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ bidx,
    const uint8_t* __restrict__ bmask, const int32_t* __restrict__ rc_fir,
    const int32_t* __restrict__ rc_iir, const int32_t* __restrict__ iir_init,
    const int32_t* __restrict__ shift, const int32_t* __restrict__ quant,
    const uint8_t* __restrict__ iir_reset, int32_t* __restrict__ res_tl,
    int32_t* __restrict__ o_fir, int32_t* __restrict__ o_iir,
    int32_t* __restrict__ o_init, int32_t* __restrict__ o_shift,
    int32_t* __restrict__ o_quant, uint8_t* __restrict__ o_reset,
    int32_t* __restrict__ o_blen, int32_t* __restrict__ state0) {
  extern __shared__ int32_t s_tile[];  // [rows][kPitch]
  __shared__ DvdaLaneSource s_lane[kLanePackLanes];
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int nb = blockIdx.x;
  const int b0 = blockIdx.y * cpt;
  const int lane0 = b0 * n_ch;
  const int nl = min(cpt, Bc - b0) * n_ch;  // lanes of this tile
  if (nb == 0)
    for (int h = tid; h < 2 * nl; h += kThreads)
      dvda_store16(state0 + (int64_t)(lane0 + (h >> 1)) * 8 + 4 * (h & 1),
                   DvdaWords4{});
  if (nb >= NB) return;  // NB == 0: the grid's one column only zeroes
  if (tid < nl) {
    const int bl = tid / n_ch;
    s_lane[tid] = lane_pack_source(b0 + bl, tid - bl * n_ch, nb, NB, n_ch,
                                   res_off, lens, bidx, bmask);
  }
  __syncthreads();
  for (int h = tid; h < 2 * nl; h += kThreads)
    lane_pack_params(s_lane[h >> 1], (int64_t)(lane0 + (h >> 1)) * NB + nb,
                     h & 1, rc_fir, rc_iir, iir_init, shift, quant,
                     iir_reset, o_fir, o_iir, o_init, o_shift, o_quant,
                     o_reset, o_blen);
  const int64_t B = (int64_t)Bc * n_ch;
  for (int s0 = 0; s0 < S; s0 += kRows) {
    const int rows = min(kRows, S - s0);
    // each lane's run along s, kBatch lanes a warp: all their loads are
    // in flight before the first shared store
    for (int j0 = warp; j0 < nl; j0 += kWarps * kBatch) {
      int32_t v[kBatch][kRows / 32];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kWarps;
        const DvdaLaneSource l = s_lane[j < nl ? j : 0];
#pragma unroll
        for (int q = 0; q < kRows / 32; ++q) {
          const int r = lid + 32 * q;
          v[u][q] = j < nl && r < rows ? lane_pack_residual(l, s0 + r, res)
                                       : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int q = 0; q < kRows / 32; ++q) {
          const int j = j0 + u * kWarps, r = lid + 32 * q;
          if (j < nl && r < rows) s_tile[r * kPitch + j] = v[u][q];
        }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {  // each row along the lanes
      int32_t* dst = res_tl + ((int64_t)nb * S + s0 + r) * B + lane0;
#pragma unroll 4
      for (int j = lid; j < nl; j += 32) dst[j] = s_tile[r * kPitch + j];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kRemixThreads) series_remix_kernel(
    int64_t T, int F, int C_out, const int32_t* __restrict__ out0,
    const int64_t* __restrict__ idx0, int nch0,
    const int32_t* __restrict__ out1, const int64_t* __restrict__ idx1,
    int nch1, const int64_t* __restrict__ frame_start,
    const int32_t* __restrict__ noise01,
    const uint8_t* __restrict__ bypassed,
    const int32_t* __restrict__ mat_coeff,
    const int32_t* __restrict__ mat_noise,
    const int32_t* __restrict__ mat_out,
    const uint8_t* __restrict__ mat_active,
    const int32_t* __restrict__ mat_quant,
    const int32_t* __restrict__ out_shift,
    const int32_t* __restrict__ wave_perm, int32_t* __restrict__ out) {
  __shared__ DvdaOutFrame s_fr[kRemixPiece];
  __shared__ int64_t s_start[kRemixPiece + 1];
  __shared__ __align__(16) int32_t s_y[kRemixRows * 8];
  __shared__ int32_t s_perm[8];
  const int tid = threadIdx.x;
  const int64_t t0 = (int64_t)blockIdx.x * kRemixRows;
  DvdaRemixInputs in;
  series_remix_loads(tid, t0, T, idx0, idx1, nch1, noise01, bypassed, in);
  if (tid < C_out) s_perm[tid] = wave_perm[tid];
  int lo = 0, hi = F - 1;  // the tile's first frame lies in [lo, hi]
  while (lo < hi) {
    const int step = series_remix_step(lo, hi);
    const int count = __syncthreads_count(
        series_remix_probe(tid, lo, hi, step, t0, frame_start));
    series_remix_narrow(count, step, lo, hi);
  }
  series_remix_gathers(tid, t0, T, out0, nch0, out1, nch1, in);
  const int nw = series_remix_words(t0, T, C_out);
  const int64_t t_last = t0 + nw / C_out - 1;
  for (int pa = lo;; pa += kRemixPiece) {
    const int m = F - pa < kRemixPiece ? F - pa : kRemixPiece;
    DvdaRemixPieceLoads v;
    series_remix_piece_loads(tid, pa, m, F, frame_start, mat_coeff,
                             mat_noise, mat_out, mat_active, mat_quant,
                             out_shift, v);
    if (pa != lo) __syncthreads();  // the last piece's rows are done
    series_remix_piece_stores(tid, m, v, s_start, s_fr);
    __syncthreads();
    series_remix_rows(tid, t0, T, m, s_start, s_fr, in, s_perm, C_out, s_y);
    if (m < kRemixPiece || s_start[kRemixPiece] > t_last) break;
  }
  __syncthreads();
  for (int w = tid; 4 * w < nw; w += kRemixThreads)
    series_remix_store(w, t0, nw, C_out, s_y, out);
}

}  // namespace

// Both entry points launch on ``stream`` and return cudaGetLastError();
// neither synchronises nor allocates (the caller owns every buffer).
extern "C" int dvda_lane_pack(
    const int32_t* res, const int64_t* res_off, const int32_t* lens,
    const int32_t* bidx, const uint8_t* bmask, const int32_t* rc_fir,
    const int32_t* rc_iir, const int32_t* iir_init, const int32_t* shift,
    const int32_t* quant, const uint8_t* iir_reset, int32_t* res_tl,
    int32_t* o_fir, int32_t* o_iir, int32_t* o_init, int32_t* o_shift,
    int32_t* o_quant, uint8_t* o_reset, int32_t* o_blen, int32_t* state0,
    int B, int NB, int S, int n_ch, void* stream) {
  if (n_ch < 1 || n_ch > 8 || B % n_ch || NB < 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  const int Bc = B / n_ch, cpt = lane_pack_chains_per_tile(n_ch);
  const int tiles = (Bc + cpt - 1) / cpt;
  if (tiles == 0) return 0;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 blocks(NB > 0 ? NB : 1, tiles);
  const size_t smem = sizeof(int32_t) * kPitch * (S < kRows ? S : kRows);
  lane_pack_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      Bc, NB, S, n_ch, cpt, res, res_off, lens, bidx, bmask, rc_fir, rc_iir,
      iir_init, shift, quant, iir_reset, res_tl, o_fir, o_iir, o_init,
      o_shift, o_quant, o_reset, o_blen, state0);
  return (int)cudaGetLastError();
}

extern "C" int dvda_series_remix(
    const int32_t* out0, const int64_t* idx0, int nch0, const int32_t* out1,
    const int64_t* idx1, int nch1, const int64_t* frame_start,
    const int32_t* noise01, const uint8_t* bypassed, const int32_t* mat_coeff,
    const int32_t* mat_noise, const int32_t* mat_out,
    const uint8_t* mat_active, const int32_t* mat_quant,
    const int32_t* out_shift, const int32_t* wave_perm, int32_t* out,
    int64_t T, int F, int C_out, void* stream) {
  if (T <= 0) return 0;
  if (F < 1 || C_out < 1 || C_out > 8 || nch0 < 1 || nch1 < 0 ||
      nch0 + nch1 > 8)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (T + kRemixRows - 1) / kRemixRows;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  series_remix_kernel<<<(unsigned)blocks, kRemixThreads, 0,
                        (cudaStream_t)stream>>>(
      T, F, C_out, out0, idx0, nch0, out1, idx1, nch1, frame_start,
      noise01, bypassed, mat_coeff, mat_noise, mat_out, mat_active, mat_quant,
      out_shift, wave_perm, out);
  return (int)cudaGetLastError();
}
