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
//     16 bytes a thread (4 bytes where the tile's rows are not whole
//     16-byte granules), three tiles in flight (12 KB of shared memory a
//     block, 13.5 KB for lane-leading input, all of it static), so the
//     sample loop reads only registers and shared memory;
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
//
// Layouts.  dvda_tpu's lane-leading entry (ops/mlp_filter.py:128-145,
// mlp_filter_blocks) moves the residuals [B, NB, S] time-leading and the
// output back inside one jitted program, and its decode step
// (parallel/step.py:59-75) passes zero states and moves the output on to
// the frame-major [F, L, C] channels the rematrix reads.  Here those
// layout changes are the kernel's staging and writer, not copies: the
// kernel is a template on its layout (mlp_filter.cuh: time-leading rows
// staged as a [32 rows, 32 lanes] tile; lane-leading rows, one
// contiguous run a lane, staged as a lane-major tile read by
// MlpFilterRow), and writes its output through a (base, row stride) pair
// of the lane (mlp_filter_writer):
//   time-leading [NB, S, B]   out + lane         + t*B
//   frame-major  [F, T, C]    out + (f*T)*C + c  + t*C   (lane = f*C + c)
// the lane-leading [B, NB, S] output being the frame-major one at C = 1.
// A null initial state is zero and a null final state is not written, so
// the step and the engine upload and allocate no states.
#include <cuda_runtime.h>

#include "mlp_filter.cuh"

namespace {

// The layout is a template parameter, so that the time-leading variant
// is the kernel it was before the other layouts came: a run-time choice
// of the writer cost it 0.4-1.1 % (PERF.md §6).
template <int kLayout>
__global__ void __launch_bounds__(kFilterLanes) mlp_filter_kernel(
    int B, int NB, int S, int C, bool vec, const int32_t* __restrict__ res,
    MlpFilterTables t, int32_t* __restrict__ out,
    int32_t* __restrict__ fir_state, int32_t* __restrict__ iir_state) {
  constexpr bool kLaneIn = kLayout == kFilterLaneIn;
  constexpr int kStageWords =
      kLaneIn ? kFilterLanes * kFilterRowPitch : kFilterRows * kFilterLanes;
  __shared__ __align__(16) int32_t s_res[kFilterStages][kStageWords];
  const int lane0 = blockIdx.x * kFilterLanes;
  const int lane = lane0 + threadIdx.x;
  const bool live = lane < B;
  const int64_t T = (int64_t)NB * S;
  const int tiles = (int)((T + kFilterRows - 1) / kFilterRows);
  const MlpFilterWriter w = mlp_filter_writer(kLayout, lane, T, B, C);
  auto stage = [&](int q, int j) {
    if constexpr (kLaneIn)
      stage_lane_tile(s_res[q], res, (int64_t)j * kFilterRows, T, B, lane0,
                      vec);
    else
      stage_tile(reinterpret_cast<int32_t(*)[kFilterLanes]>(s_res[q]), res,
                 (int64_t)j * kFilterRows, T, B, lane0, vec);
  };
#pragma unroll
  for (int s = 0; s < kFilterStages - 1; ++s) stage(s, s);
  MlpFilterLane L;
  if (live) mlp_filter_begin(L, lane, NB, S, t);
  for (int k = 0; k < tiles; ++k) {
    // the tile kFilterStages - 1 ahead goes into the stage read two tiles
    // ago
    const int ahead = k + kFilterStages - 1;
    stage(ahead % kFilterStages, ahead);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFilterStages - 1));
    __syncthreads();
    const int32_t* tile = s_res[k % kFilterStages];
    const int64_t t0 = (int64_t)k * kFilterRows;
    const int rows = (int)min((int64_t)kFilterRows, T - t0);
    int32_t* __restrict__ o = out + w.base + t0 * w.stride;
    if (live) {
      if constexpr (kLaneIn)
        mlp_filter_tile(
            L, lane, NB, S, t,
            MlpFilterRow{tile + threadIdx.x * kFilterRowPitch}, rows, o,
            w.stride);
      else
        mlp_filter_tile(
            L, lane, NB, S, t,
            MlpFilterColumn{
                reinterpret_cast<const int32_t(*)[kFilterLanes]>(tile),
                (int)threadIdx.x},
            rows, o, w.stride);
    }
    __syncthreads();
  }
  if (live) mlp_filter_end(L, lane, fir_state, iir_state);
}

}  // namespace

// ``layout``: kFilterTimeLeading (res and out [NB, S, B]) or
// kFilterLaneIn (res [B, NB, S], out [B / C, NB*S, C], lane b = f*C + c;
// lane-leading [B, NB, S] at C = 1).  Null fir_state0 / iir_state0: zero
// initial states; null fir_state / iir_state: the final states are not
// written.  Returns -1 where mlp_filter_layout_ok refuses; else launches
// on ``stream`` and returns cudaGetLastError().  Never synchronises and
// allocates nothing (the caller owns every buffer).
extern "C" int dvda_mlp_filter(
    const int32_t* res, const int32_t* rc_fir, const int32_t* rc_iir,
    const int32_t* shift, const int32_t* quant, const uint8_t* iir_reset,
    const int32_t* iir_init, const int32_t* block_len,
    const int32_t* fir_state0, const int32_t* iir_state0, int32_t* out,
    int32_t* fir_state, int32_t* iir_state, int B, int NB, int S,
    int layout, int C, void* stream) {
  if (!mlp_filter_layout_ok(layout, B, C)) return -1;
  if (B <= 0) return 0;
  const bool lane_in = layout == kFilterLaneIn;
  // 16-byte copies where a row of the staged tile is whole 16-byte
  // granules: B lanes time-leading, T rows lane-leading
  const bool vec = (lane_in ? (int64_t)NB * S : B) % 4 == 0 &&
                   (uintptr_t)res % 16 == 0;
  const int blocks = (B + kFilterLanes - 1) / kFilterLanes;
  const MlpFilterTables t{rc_fir,   rc_iir,   shift,     quant,     iir_reset,
                          iir_init, block_len, fir_state0, iir_state0};
  auto kernel = lane_in ? mlp_filter_kernel<kFilterLaneIn>
                        : mlp_filter_kernel<kFilterTimeLeading>;
  kernel<<<blocks, kFilterLanes, 0, (cudaStream_t)stream>>>(
      B, NB, S, C, vec, res, t, out, fir_state, iir_state);
  return (int)cudaGetLastError();
}
