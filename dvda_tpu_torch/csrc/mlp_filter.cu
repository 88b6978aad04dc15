// K1: the MLP AR reconstruction filter on the card.
//
// Replaces dvda_tpu/ops/pallas_filter.py::_kernel (the Pallas kernel behind
// mlp_filter_blocks_pallas) and the lax.scan filter of
// dvda_tpu/ops/mlp_filter.py::mlp_filter_blocks_tl; both compute the same
// function, and so does this kernel.
//
// Bound: the dependent chain and the issue of one warp, not bytes.  Each
// lane is a serial recurrence of NB*S samples (640 at the 5.1/96k headline
// chunk: 16 blocks x 40), each waiting on the one before, and a chunk has
// only 1,536 lanes: one warp per SM scheduler at most, so nothing hides a
// warp's latency but its own instruction stream.  The floor is NB*S times
// one step: a chain of about 45 cycles (a shift, an add, the mask, two
// multiply-adds).  The design:
//   * one thread per lane, a block of 32 lanes (one warp): 48 blocks at the
//     headline chunk, 64 at the fused step, each warp alone on a scheduler;
//   * the residuals are staged ahead of the chain: the block's [NB*S, 32]
//     rows are copied into shared memory in tiles of 32 rows by cp.async,
//     16 bytes a thread (4 bytes where B is not a multiple of 4), three
//     tiles in flight (12 KB of shared memory a block, all of it static),
//     so the sample loop reads only registers and shared memory;
//   * the next block's taps, shift, quant, reset, init and length are
//     loaded one block ahead into registers;
//   * only the two newest products wait on the sample just made: the other
//     14 terms of the next sum are added while it is computed, and eight
//     live samples of a block run as one straight-line group, the state
//     renamed rather than shifted (mlp_filter.cuh);
//   * the group sums in float64 where the block's taps lie within +-2^16
//     (every MLP stream: coefficients are at most 16 bits): each product
//     and sum is then an integer below 2^51 and exact.  On this card one
//     warp issues a dependent 32 x 32 -> 64-bit integer multiply-add
//     (IMAD.WIDE) every 14.7 cycles and eight independent ones no faster,
//     the float64 one every 8.2 cycles dependent and 2.1 independent, and a
//     step needs 16 of them; other taps take the one-sample step in int64;
//   * outputs are stored straight from the loop: a warp writes 32
//     neighbouring words a sample, and stores do not stall the chain.
// tools/torch_timing_check.py chains times the float64 group alone and
// this kernel per dependent step (PERF.md §6): the kernel takes about three
// times the group's cycles a sample.  The SASS between the groups holds
// register copies where the group kinds' paths join, the branches between
// them, and the float64 <-> int64 conversions of the sums at each group's
// edges; groups of 4 or 2 samples pay that more often and were slower.
#include <cuda_runtime.h>

#include "mlp_filter.cuh"

namespace {

__global__ void __launch_bounds__(kFilterLanes) mlp_filter_kernel(
    int B, int NB, int S, bool vec, const int32_t* __restrict__ res_tl,
    MlpFilterTables t, int32_t* __restrict__ out_tl,
    int32_t* __restrict__ fir_state, int32_t* __restrict__ iir_state) {
  __shared__ __align__(16) int32_t
      s_res[kFilterStages][kFilterRows][kFilterLanes];
  const int lane0 = blockIdx.x * kFilterLanes;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < B;
  const int64_t T = (int64_t)NB * S;
  const int tiles = (int)((T + kFilterRows - 1) / kFilterRows);
#pragma unroll
  for (int s = 0; s < kFilterStages - 1; ++s)
    stage_tile(s_res[s], res_tl, (int64_t)s * kFilterRows, T, B, lane0, vec);
  MlpFilterLane L;
  if (live) mlp_filter_begin(L, lane, NB, S, t);
  for (int k = 0; k < tiles; ++k) {
    // the tile kFilterStages - 1 ahead goes into the stage read two tiles
    // ago
    const int ahead = k + kFilterStages - 1;
    stage_tile(s_res[ahead % kFilterStages], res_tl,
               (int64_t)ahead * kFilterRows, T, B, lane0, vec);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFilterStages - 1));
    __syncthreads();
    const int32_t(*tile)[kFilterLanes] = s_res[k % kFilterStages];
    const int64_t t0 = (int64_t)k * kFilterRows;
    const int rows = (int)min((int64_t)kFilterRows, T - t0);
    if (live)
      mlp_filter_tile(L, lane, NB, S, t,
                      MlpFilterColumn{tile, (int)threadIdx.x}, rows,
                      out_tl + t0 * B + lane, B);
    __syncthreads();
  }
  if (live) mlp_filter_end(L, lane, fir_state, iir_state);
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError(); never synchronises
// and allocates nothing (the caller owns every buffer).
extern "C" int dvda_mlp_filter(
    const int32_t* res_tl, const int32_t* rc_fir, const int32_t* rc_iir,
    const int32_t* shift, const int32_t* quant, const uint8_t* iir_reset,
    const int32_t* iir_init, const int32_t* block_len,
    const int32_t* fir_state0, const int32_t* iir_state0, int32_t* out_tl,
    int32_t* fir_state, int32_t* iir_state, int B, int NB, int S,
    void* stream) {
  if (B <= 0) return 0;
  const bool vec = B % 4 == 0 && (uintptr_t)res_tl % 16 == 0;
  const int blocks = (B + kFilterLanes - 1) / kFilterLanes;
  const MlpFilterTables t{rc_fir,   rc_iir,   shift,     quant,     iir_reset,
                          iir_init, block_len, fir_state0, iir_state0};
  mlp_filter_kernel<<<blocks, kFilterLanes, 0, (cudaStream_t)stream>>>(
      B, NB, S, vec, res_tl, t, out_tl, fir_state, iir_state);
  return (int)cudaGetLastError();
}
