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
// K6b (series_remix_kernel): one thread per output sample t.  The frame of t
// is found by binary search over the frame starts, which replaces dvda_tpu's
// frame_idx / flat_idx gathers (they exist to give XLA static frame-major
// shapes); the thread gathers its 8 channels from K1's outputs, runs the
// frame's 6-slot matrix chain and the output stage, and writes row t.
// Bound: bytes in principle (36 B of inputs and 24 B of output per 5.1
// sample); each thread also re-reads its frame's ~80 matrix words, which
// neighbouring threads share through L1/L2.  The design does nothing more
// yet: a later change can stage a frame's tables in shared memory.
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

__global__ void series_remix_kernel(
    int64_t T, int F, int C_out, const int32_t* out0,
    const int64_t* idx0, int nch0, const int32_t* out1, const int64_t* idx1,
    int nch1, const int64_t* frame_start, const int32_t* noise01,
    const uint8_t* bypassed, const int32_t* mat_coeff,
    const int32_t* mat_noise, const int32_t* mat_out,
    const uint8_t* mat_active, const int32_t* mat_quant,
    const int32_t* out_shift, const int32_t* wave_perm, int32_t* out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  series_remix_sample(t, F, C_out, out0, idx0, nch0, out1, idx1, nch1,
                      frame_start, noise01, bypassed, mat_coeff, mat_noise,
                      mat_out, mat_active, mat_quant, out_shift, wave_perm,
                      out);
}

unsigned grid(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

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
  series_remix_kernel<<<grid(T), kThreads, 0, (cudaStream_t)stream>>>(
      T, F, C_out, out0, idx0, nch0, out1, idx1, nch1, frame_start,
      noise01, bypassed, mat_coeff, mat_noise, mat_out, mat_active, mat_quant,
      out_shift, wave_perm, out);
  return (int)cudaGetLastError();
}
