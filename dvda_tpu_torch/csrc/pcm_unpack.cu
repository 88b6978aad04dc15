// K8: the PCM unpack of a whole track's chunk batch on the card.
//
// Replaces dvda_tpu/ops/pcm_unpack.py::_unpack (the jitted XLA program of
// static column selects behind decode_chunks_device and pcm_unpack_jit).
// With ``nbytes`` 2 or 3 it also replaces the host byte repack of the PCM
// disc-to-WAV path (host.pcm_repack in TrackReader._pcm_packed_native): the
// kernel writes the little-endian WAV payload directly.
//
// Bound: bytes.  Each chunk is read once and each output byte written once
// (51.84 MB in, 51.84 MB out packed or 69.12 MB as int32 for a 30 s
// 5.1/96k/24 track); there is no arithmetic to speak of.  The design moves
// those bytes in 16-byte pieces both ways:
//   * a persistent grid, 4 blocks of 256 threads on each SM, walks the
//     tiles of DVDA_PCM_TILE chunks; each block stages its next two tiles
//     by 16-byte cp.async copies (the ragged last tile's tail bytes one by
//     one) while it builds the current one, a ring of three tiles of
//     shared memory (27 KB);
//   * each thread builds 16-byte output vectors at one position of the
//     configuration's period (pcm_unpack.cuh), its 16 byte sources in
//     registers, from byte loads of the staged tile, and stores each with
//     one 16-byte store; neighbouring threads store neighbouring vectors;
//   * the gather table travels by value as a kernel parameter (no device
//     upload) and each block copies it into shared memory to derive its
//     threads' sources.
// The wrapper guarantees 16-byte aligned chunks and output.
#include <cuda_runtime.h>

#include <string.h>

#include "pcm_unpack.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
//: tiles a block holds in shared memory: the one it builds and the
//: copies in flight for the next two
constexpr int kStages = 3;

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int bytes) {
  const int vecs = bytes >> 4;
  for (int i = threadIdx.x; i < vecs; i += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst + 16 * i)),
                 "l"(src + 16 * i));
  const int tail = 16 * vecs + threadIdx.x;
  if (tail < bytes) dst[tail] = src[tail];
}

// The chunk count of tile t.
__device__ __forceinline__ int tile_chunks(int64_t n, int64_t t) {
  const int64_t left = n - t * DVDA_PCM_TILE;
  return (int)(left < DVDA_PCM_TILE ? left : DVDA_PCM_TILE);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) pcm_unpack_kernel(
    int64_t n, DvdaPcmGeom g, DvdaPcmTable table,
    const uint8_t* __restrict__ chunks, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t s_in[kStages][DVDA_PCM_TILE_BYTES];
  __shared__ DvdaPcmTable tab;
  if (threadIdx.x < DVDA_PCM_MAX_SLOTS * 3)
    tab.idx[threadIdx.x] = table.idx[threadIdx.x];
  const int64_t tiles = (n + DVDA_PCM_TILE - 1) / DVDA_PCM_TILE;
  const int64_t tile_in = (int64_t)DVDA_PCM_TILE * g.csize;
  const int64_t tile_out = (int64_t)DVDA_PCM_TILE * g.slots * g.ob;
  const int64_t out_end = n * g.slots * g.ob;
  // a thread builds the vectors at position pv of their period, every
  // ``step``-th vector of a tile from its own
  const int per = kThreads / g.period_v;
  const int step = per * g.period_v;
  const int pv = threadIdx.x % g.period_v;
  const int p0 = threadIdx.x / g.period_v;
  // the ring: tiles t, t + grid, ... staged kStages - 1 ahead (a group
  // committed for each, empty past the last tile)
  const int64_t grid = gridDim.x;
  for (int k = 0; k < kStages - 1; ++k) {
    const int64_t t = blockIdx.x + k * grid;
    if (t < tiles)
      stage(s_in[k], chunks + t * tile_in, tile_chunks(n, t) * g.csize);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __syncthreads();  // the table
  const DvdaPcmVec src = pcm_vector_sources(g, tab, pv);
  int k = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += grid, ++k) {
    const int64_t ahead = t + (kStages - 1) * grid;
    if (ahead < tiles)
      stage(s_in[(k + kStages - 1) % kStages], chunks + ahead * tile_in,
            tile_chunks(n, ahead) * g.csize);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();
    const uint8_t* in = s_in[k % kStages];
    const int64_t base = t * tile_out;
    const int64_t end = out_end - base < tile_out ? out_end - base : tile_out;
    if (threadIdx.x < step) {
      for (int v = threadIdx.x, p = p0; 16 * (int64_t)v < end;
           v += step, p += per)
        pcm_store_vector(out + base, 16 * (int64_t)v, end,
                         pcm_vector(in + p * g.period_in, src));
    }
    __syncthreads();  // before a later stage overwrites this buffer
  }
}

}  // namespace

// ``table``: host int32 [slots, 3].  ``chunks`` and ``out``: 16-byte
// aligned.  Launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a bad geometry or alignment); never
// synchronises, allocates nothing, and launches nothing when n == 0.
extern "C" int dvda_pcm_unpack(const uint8_t* chunks, int64_t n, int csize,
                               int channels, int bits, int nbytes,
                               const int32_t* table, uint8_t* out,
                               void* stream) {
  const int slots = 2 * channels;
  if (channels < 1 || slots > DVDA_PCM_MAX_SLOTS || n < 0 ||
      csize < 1 || csize > DVDA_PCM_MAX_CSIZE ||
      !(bits == 16 || bits == 20 || bits == 24) ||
      !(nbytes == 0 || nbytes == 2 || nbytes == 3) ||
      ((uintptr_t)chunks & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  DvdaPcmTable t;
  memset(&t, 0xff, sizeof(t));
  memcpy(t.idx, table, sizeof(int32_t) * 3 * slots);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + DVDA_PCM_TILE - 1) / DVDA_PCM_TILE;
  const int64_t most = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(tiles < most ? tiles : most);
  pcm_unpack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, pcm_geom(csize, channels, bits, nbytes), t, chunks, out);
  return (int)cudaGetLastError();
}
