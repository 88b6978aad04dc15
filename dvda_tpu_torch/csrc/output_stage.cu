// K234: the fused output half of the uniform MLP chunk program on the card.
//
// Replaces, in one pass, the XLA stages that follow the AR filter in
// dvda_tpu/codecs/mlp/native_engine.py::_uniform_arena_pipeline: the LFSR
// noise expansion (:282-301), the bypassed-LSB unpack (:303-311),
// dvda_tpu/ops/rematrix.py::rematrix_frames_tl and apply_output_stage_tl,
// and the little-endian byte pack into WAV time order (:319-328, :370-372).
//
// Bound: latency.  The bytes are few (2.2 us at the headline chunk); what
// costs is the chain of up to 6 dependent int64 matrix dots per sample,
// the LFSR's serial steps and the table loads.  The design:
//   * one thread per (chain, sample): a block takes a tile of CT chains x
//     one frame (CT * Ls <= 512 threads, chains fastest so a warp's
//     ``series`` loads stay chain-minor), in strips of Ls = min(L0, 160)
//     samples; 163,840 threads at the headline chunk;
//   * the block loads the tile's frame tables into shared memory, one
//     item a thread with every load in flight before the first store;
//     there the runtime slot count indexes them with no stack frame;
//   * one thread per chain steps the frame's LFSR serially into shared
//     memory while the other threads load their samples;
//   * each sample's output bytes are staged in shared memory, and the
//     block stores each chain-frame's contiguous run of L0 x C_out x
//     nbytes bytes as whole 32-bit words (bytes only at an unaligned edge).
//
// K234n, the narrow readback of the same program (dvda_tpu
// native_engine.py:330-369): the same kernel writes the 16-bit tier (form
// 2) or the 12-bit tier (channel pairs in 3 bytes), and a second launch
// writes the 8 flag rows after them.  Bound: bytes, less than K234's
// (1.97 MB written at tier 16 and 1.47 MB at tier 12 per headline chunk,
// 2.95 MB wide); the work added to a sample is two compares a value.  The
// fits test is a reduction over the whole chunk: each sample ORs the tiers
// its values miss, each block folds them with two __syncthreads_or and one
// atomicOr into a device word the launch zeroed, and the flag launch
// reads that word.  Bit operations only: the result does not depend on the
// order of the blocks.
#include <cuda_runtime.h>

#include "output_stage.cuh"

namespace {

constexpr int kThreads = 512;  // CT * Ls at most
constexpr int kStrip = 160;    // samples of a frame a block holds at once
constexpr int kMaxTile = 32;   // chains of a tile at most
constexpr int kMaxRow = 32;    // output bytes of a sample at most (8 x 4)
constexpr int kItems = 4;      // table items a thread loads at once

// The output word at byte a from the staged run [gs, ge) (staged[0] is
// byte gs); bytes outside the run belong to other chain-frames.
__device__ __forceinline__ void store_word(uint8_t* __restrict__ out,
                                           int64_t a, int64_t gs, int64_t ge,
                                           const uint8_t* staged) {
  if (a >= gs && a + 4 <= ge) {
    const uint8_t* p = staged + (a - gs);
    *reinterpret_cast<uint32_t*>(out + a) =
        p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
        (uint32_t)p[3] << 24;
    return;
  }
  for (int k = 0; k < 4; ++k)
    if (a + k >= gs && a + k < ge) out[a + k] = staged[a + k - gs];
}

__global__ void __launch_bounds__(kThreads) output_stage_kernel(
    int Bc, int fpc, int L0, int tile_log2, int Ls, int C_tot, int C_out,
    int n_mats, int form, const int32_t* __restrict__ series,
    const int32_t* __restrict__ frame_seed,
    const int8_t* __restrict__ frame_nshift, const int8_t* __restrict__ byp,
    const int16_t* __restrict__ mat_coeff,
    const int16_t* __restrict__ mat_noise, const int8_t* __restrict__ mat_out,
    const int8_t* __restrict__ mat_active,
    const int8_t* __restrict__ mat_quant,
    const int8_t* __restrict__ out_shift,
    const int8_t* __restrict__ wave_perm, uint8_t* __restrict__ out,
    uint32_t* __restrict__ misfit) {
  __shared__ DvdaOutFrame s_fr[kMaxTile];
  __shared__ uint32_t s_seed[kThreads];
  __shared__ uint32_t s_words[kThreads * kMaxRow / 4];
  __shared__ int8_t s_perm[8];
  uint8_t* const s_out = reinterpret_cast<uint8_t*>(s_words);
  const int CT = 1 << tile_log2;
  const int tid = threadIdx.x;
  const int bl = tid & (CT - 1), i = tid >> tile_log2;
  const int f = blockIdx.y, b0 = blockIdx.x << tile_log2;
  const int nct = min(CT, Bc - b0);  // chains of this tile
  const int row = output_stage_row_bytes(C_out, form);  // bytes a sample
  const int64_t period = (int64_t)fpc * L0;

  if (tid < C_out) s_perm[tid] = wave_perm[tid];
  // the tile's frame tables, kItems items a thread in flight at once
  const int items = nct * kOutFrameItems;
  for (int k0 = tid; k0 < items; k0 += kItems * blockDim.x) {
    int32_t v[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int k = k0 + u * blockDim.x, c = k / kOutFrameItems;
      if (k < items)
        v[u] = output_stage_item((int64_t)(b0 + c) * fpc + f,
                                 k - c * kOutFrameItems, frame_nshift,
                                 mat_coeff, mat_noise, mat_out, mat_active,
                                 mat_quant, out_shift);
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int k = k0 + u * blockDim.x, c = k / kOutFrameItems;
      if (k < items) output_stage_set_item(s_fr[c], k - c * kOutFrameItems,
                                           v[u]);
    }
  }
  uint32_t miss = 0;  // the narrow tiers this thread's samples miss
  uint32_t seed =
      tid < nct ? (uint32_t)frame_seed[(int64_t)(b0 + tid) * fpc + f] : 0u;
  for (int i0 = 0; i0 < L0; i0 += Ls) {
    const int ns = min(Ls, L0 - i0);
    if (tid < nct)
      for (int k = 0; k < ns; ++k) {
        s_seed[k * CT + tid] = seed;
        seed = dvda_lfsr_step(seed);
      }
    const bool live = bl < nct && i < ns;
    const int64_t t = (int64_t)f * L0 + i0 + i;  // in-chain time
    int32_t ch[8];
    uint32_t bits = 0;
    if (live) {
      output_stage_channels(series, t, Bc, C_tot, b0 + bl, ch);
      bits = (uint8_t)byp[(int64_t)(b0 + bl) * period + t];
    }
    __syncthreads();
    if (live)
      miss |= output_stage_sample(s_fr[bl], s_seed[i * CT + bl], n_mats, ch,
                                  bits, s_perm, C_out, form,
                                  s_out + (bl * Ls + i) * row);
    __syncthreads();
    // chain c's run of ns samples starts at output byte gs; its words
    const int run = ns * row, wpc = (run >> 2) + 2;
    for (int w = tid; w < nct * wpc; w += blockDim.x) {
      const int c = w / wpc;
      const int64_t gs =
          ((int64_t)(b0 + c) * period + (int64_t)f * L0 + i0) * row;
      const int64_t a = ((gs >> 2) + (w - c * wpc)) << 2;
      if (a < gs + run) store_word(out, a, gs, gs + run, s_out + c * Ls * row);
    }
    __syncthreads();
  }
  if (misfit) {  // narrow: the block's misfit bits into the chunk's word
    const int m12 = __syncthreads_or(miss & 1u);
    const int m16 = __syncthreads_or(miss & 2u);
    if (tid == 0 && (m12 | m16))
      atomicOr(misfit, (m12 ? 1u : 0u) | (m16 ? 2u : 0u));
  }
}

// The 8 flag rows after the narrow rows: every byte the chunk's flag.
__global__ void output_stage_narrow_kernel(const uint32_t* __restrict__ misfit,
                                           int tier, uint8_t* __restrict__ rows,
                                           int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) rows[k] = output_stage_narrow_flag(*misfit, tier);
}

// One K234 launch in ``form`` (misfit null: no fits test).
int launch_output_stage(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, uint32_t* misfit, int Bc, int fpc, int L0, int C_tot,
    int C_out, int n_mats, int form, cudaStream_t stream) {
  if (fpc > 65535 || C_out < 1 || C_out > 8 || n_mats < 0 || n_mats > 6)
    return (int)cudaErrorInvalidValue;
  const int Ls = L0 < kStrip ? L0 : kStrip;
  int tile_log2 = 0;  // the most chains, up to 32, that fit the threads
  while ((1 << (tile_log2 + 1)) <= kMaxTile &&
         (Ls << (tile_log2 + 1)) <= kThreads)
    ++tile_log2;
  const dim3 blocks((Bc + (1 << tile_log2) - 1) >> tile_log2, fpc);
  output_stage_kernel<<<blocks, Ls << tile_log2, 0, stream>>>(
      Bc, fpc, L0, tile_log2, Ls, C_tot, C_out, n_mats, form, series,
      frame_seed, frame_nshift, byp, mat_coeff, mat_noise, mat_out,
      mat_active, mat_quant, out_shift, wave_perm, out, misfit);
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
      C_tot, C_out, n_mats, nbytes ? nbytes : 4, (cudaStream_t)stream);
}

// K234n: the narrow rows of tier 12 or 16 into out[0, Bc*period), then 8
// flag rows, out being uint8 [Bc*period + 8, row] (row: C_out*2 at tier
// 16, C_out/2*3 at tier 12).  ``misfit`` is one device word of scratch,
// zeroed here.  Three operations on ``stream``; never synchronises.
extern "C" int dvda_output_stage_narrow(
    const int32_t* series, const int32_t* frame_seed,
    const int8_t* frame_nshift, const int8_t* byp, const int16_t* mat_coeff,
    const int16_t* mat_noise, const int8_t* mat_out, const int8_t* mat_active,
    const int8_t* mat_quant, const int8_t* out_shift, const int8_t* wave_perm,
    uint8_t* out, uint32_t* misfit, int Bc, int fpc, int L0, int C_tot,
    int C_out, int n_mats, int tier, void* stream) {
  if (Bc <= 0 || fpc <= 0 || L0 <= 0) return 0;
  if (!(tier == 16 || (tier == kNarrow12 && C_out % 2 == 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(misfit, 0, sizeof(uint32_t), s);
  if (rc != cudaSuccess) return (int)rc;
  const int form = tier == 16 ? 2 : kNarrow12;
  const int err = launch_output_stage(
      series, frame_seed, frame_nshift, byp, mat_coeff, mat_noise, mat_out,
      mat_active, mat_quant, out_shift, wave_perm, out, misfit, Bc, fpc, L0,
      C_tot, C_out, n_mats, form, s);
  if (err) return err;
  const int row = output_stage_row_bytes(C_out, form);
  const int n = 8 * row;
  output_stage_narrow_kernel<<<1, (n + 31) / 32 * 32, 0, s>>>(
      misfit, tier, out + (int64_t)Bc * fpc * L0 * row, n);
  return (int)cudaGetLastError();
}
