// K234: the fused output half of the uniform MLP chunk program on the card.
//
// Replaces, in one pass, the XLA stages that follow the AR filter in
// dvda_tpu/codecs/mlp/native_engine.py::_uniform_arena_pipeline: the LFSR
// noise expansion (:282-301), the bypassed-LSB unpack (:303-311),
// dvda_tpu/ops/rematrix.py::rematrix_frames_tl and apply_output_stage_tl,
// and the little-endian byte pack into WAV time order (:319-328, :370-372).
//
// K234n, the narrow readback of the same program (dvda_tpu
// native_engine.py:330-369): the same kernel writes the 16-bit tier (form
// 2) or the 12-bit tier (channel pairs in 3 bytes), and the 8 flag rows
// after them, in the same launch.
//
// Bound: bytes (6.37 MB in and 2.95 MB out wide, 1.97 MB at tier 16, per
// headline chunk: 2-3 us), but a chunk is one wave of short blocks, so
// what costs is each block's chain of latencies, the samples' integer work
// (about half the time at the headline: PERF.md) and the launches.  The
// design (output_stage.cuh's tile bodies):
//   * a block is a tile of 32 chains (a warp's lanes: its series loads
//     are 128 contiguous bytes, whole sectors) x 16 samples of one frame,
//     256 threads of 2 samples each; 320 blocks at the headline chunk;
//   * every load is issued before the first shared store: the thread's
//     channels, the tile's frame tables (13 loads a thread, widened into
//     shared memory, where the runtime slot count indexes them with no
//     stack frame), its bypass bytes and frame seeds;
//   * no serial LFSR: warp 0 jumps each chain's frame seed to the strip's
//     start by one table of M^(16q) in constant memory (the step is
//     GF(2)-linear), and each thread steps at most 14 times from there;
//   * each chain's run of output bytes is staged in shared memory (an
//     odd-word pitch: no bank conflicts) and stored as 16-byte vectors;
//   * the output form is a template parameter, so a sample's byte loop
//     unrolls and only the narrow forms test the tiers;
//   * the WAVE permutation, the same for every sample, goes through 8
//     shared words of the thread's own (8 stores, C_out loads) instead
//     of an 8-way select per output channel;
//   * K234n folds the fits test into the same launch: each warp ORs its
//     misfit bits (__reduce_or_sync) into the block's word, and each block
//     adds its ticket and the tiers it misses to the chunk's 64-bit counter
//     in one atomicAdd; the block whose add completes the count (as in
//     CUDA's threadFenceReduction sample, but the counter itself carries
//     the bits, so no fence) writes the 8 flag rows and zeroes the counter
//     for the next launch.  The caller keeps the counter per stream, zeroed
//     once.  Sums of 0/1: the flag does not depend on the blocks' order.
#include <cuda_runtime.h>

#include "output_stage.cuh"

namespace {

constexpr unsigned long long kTicketMask = (1ull << 21) - 1;
// a thread's 8 permutation words, at an odd pitch: the lanes' stores of
// one channel and loads of one WAVE slot fall in 32 banks
constexpr int kOutPickPitch = 9;

template <int kForm>
__global__ void __launch_bounds__(kOutThreads) output_stage_kernel(
    int Bc, int fpc, int L0, int C_tot, int C_out, int n_mats, int tier, const int32_t* __restrict__ series,
    const int32_t* __restrict__ frame_seed,
    const int8_t* __restrict__ frame_nshift, const int8_t* __restrict__ byp,
    const int16_t* __restrict__ mat_coeff,
    const int16_t* __restrict__ mat_noise, const int8_t* __restrict__ mat_out,
    const int8_t* __restrict__ mat_active,
    const int8_t* __restrict__ mat_quant,
    const int8_t* __restrict__ out_shift,
    const int8_t* __restrict__ wave_perm, uint8_t* __restrict__ out,
    uint32_t* __restrict__ scratch) {
  __shared__ DvdaOutFrame s_fr[kOutTileChains];
  __shared__ uint32_t s_out[kOutTileChains * kOutPitch];
  __shared__ uint8_t s_byp[kOutTileChains * kOutStrip];
  __shared__ uint32_t s_seed[kOutTileChains];
  __shared__ uint32_t s_pick[kOutThreads * kOutPickPitch];
  __shared__ int8_t s_perm[8];
  __shared__ uint32_t s_miss, s_flag;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int row = output_stage_row_bytes(C_out, kForm);
  const DvdaOutTile t =
      output_stage_tile(blockIdx.x, blockIdx.y, Bc, fpc, L0, row);

  // every load in flight before the first shared store
  DvdaOutInputs in;
  output_stage_inputs(tid, t, series, Bc, C_tot, in);
  DvdaOutTableLoads tab;
  output_stage_table_loads(tid, t, fpc, frame_nshift, mat_coeff, mat_noise,
                           mat_out, mat_active, mat_quant, out_shift, tab);
  uint8_t bv[kOutBypPasses];
  output_stage_byp_loads(tid, t, byp, bv);
  const uint32_t seed0 =
      tid < kOutTileChains ? output_stage_frame_seed(tid, t, fpc, frame_seed)
                           : 0u;
  const int8_t perm = tid < C_out ? wave_perm[tid] : 0;
  output_stage_table_stores(tid, t, tab, s_fr);
  output_stage_byp_stores(tid, bv, s_byp);
  if (tid < kOutTileChains) s_seed[tid] = dvda_lfsr_at(seed0, t.i0);
  if (tid < C_out) s_perm[tid] = perm;
  if (tid == 0) s_miss = 0;
  __syncthreads();
  uint32_t miss = output_stage_samples<kForm>(
      tid, t, in, s_fr, s_seed, s_byp, s_perm, n_mats, C_out,
      s_pick + tid * kOutPickPitch, s_out);
  __syncthreads();
  const int items = t.nct * output_stage_vectors(t);
  for (int k = tid; k < items; k += kOutThreads)
    output_stage_store(k, t, s_out, out);
  if (scratch == nullptr) return;  // K234: no fits test

  // K234n: the block's misfit bits and its ticket in one 64-bit atomicAdd
  // on the chunk's counter (bits 0-20 the blocks, 21-41 those that miss
  // 12 bits, 42-62 those that miss int16).  Its result tells the block that
  // comes last the whole chunk's bits, so no fence is needed; that block
  // zeroes the counter for the next launch and writes the flag rows.
  miss = __reduce_or_sync(0xffffffffu, miss);
  if ((tid & 31) == 0 && miss) atomicOr(&s_miss, miss);
  __syncthreads();
  if (tid == 0) {
    const unsigned long long add = 1ull |
                                   (unsigned long long)(s_miss & 1u) << 21 |
                                   (unsigned long long)(s_miss >> 1) << 42;
    unsigned long long* counter =
        reinterpret_cast<unsigned long long*>(scratch);
    const unsigned long long sum = atomicAdd(counter, add) + add;
    s_last = (sum & kTicketMask) == gridDim.x * gridDim.y;
    s_flag = ((sum >> 21) & kTicketMask ? 1u : 0u) |
             ((sum >> 42) & kTicketMask ? 2u : 0u);
    if (s_last) *counter = 0;
  }
  __syncthreads();
  if (!s_last) return;
  uint8_t* flags = out + (int64_t)Bc * t.period * row;
  for (int k = tid; k < 8 * row; k += kOutThreads)
    flags[k] = output_stage_narrow_flag(s_flag, tier);
}

// One launch in ``form`` (scratch null: no fits test).
int launch_output_stage(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, uint32_t* scratch, int Bc, int fpc, int L0, int C_tot,
    int C_out, int n_mats, int form, int tier, cudaStream_t stream) {
  const int64_t x = (int64_t)fpc * output_stage_strips(L0);
  const int y = (Bc + kOutTileChains - 1) / kOutTileChains;
  if (C_tot < 1 || C_tot > 8 || C_out < 1 || C_out > 8 || n_mats < 0 ||
      n_mats > 6 || x > 0x7FFFFFFF || y > 65535 ||
      x * y > (scratch ? (long long)kTicketMask : 0xFFFFFFFFll))
    return (int)cudaErrorInvalidValue;
  auto kernel = form == 2   ? output_stage_kernel<2>
                : form == 3 ? output_stage_kernel<3>
                : form == 4 ? output_stage_kernel<4>
                            : output_stage_kernel<kNarrow12>;
  kernel<<<dim3((unsigned)x, y), kOutThreads, 0, stream>>>(
      Bc, fpc, L0, C_tot, C_out, n_mats, tier, series, frame_seed,
      frame_nshift, byp, mat_coeff, mat_noise, mat_out, mat_active, mat_quant,
      out_shift, wave_perm, out, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError(); never synchronises
// and allocates nothing (the caller owns every buffer).
extern "C" int dvda_output_stage(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, int Bc, int fpc, int L0, int C_tot, int C_out, int n_mats,
    int nbytes, void* stream) {
  if (Bc <= 0 || fpc <= 0 || L0 <= 0) return 0;
  if (nbytes != 0 && nbytes != 2 && nbytes != 3)
    return (int)cudaErrorInvalidValue;
  return launch_output_stage(
      series, frame_seed, frame_nshift, byp, mat_coeff, mat_noise, mat_out,
      mat_active, mat_quant, out_shift, wave_perm, out, nullptr, Bc, fpc, L0,
      C_tot, C_out, n_mats, nbytes ? nbytes : 4, 0, (cudaStream_t)stream);
}

// K234n: the narrow rows of tier 12 or 16 into out[0, Bc*period), then 8
// flag rows, out being uint8 [Bc*period + 8, row] (row: C_out*2 at tier
// 16, C_out/2*3 at tier 12).  ``scratch`` is two device words (one 8-byte
// aligned 64-bit counter), zero on entry, that the launch leaves zero: the
// caller keeps one pair per stream (launches on one stream run in order).
// At most 2^21 - 1 blocks.  One launch on ``stream``; never synchronises.
extern "C" int dvda_output_stage_narrow(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, uint32_t* scratch, int Bc, int fpc, int L0, int C_tot,
    int C_out, int n_mats, int tier, void* stream) {
  if (Bc <= 0 || fpc <= 0 || L0 <= 0) return 0;
  if (!(tier == 16 || (tier == kNarrow12 && C_out % 2 == 0)))
    return (int)cudaErrorInvalidValue;
  return launch_output_stage(
      series, frame_seed, frame_nshift, byp, mat_coeff, mat_noise, mat_out,
      mat_active, mat_quant, out_shift, wave_perm, out, scratch, Bc, fpc, L0,
      C_tot, C_out, n_mats, tier == 16 ? 2 : kNarrow12, tier,
      (cudaStream_t)stream);
}
