// K10: a device-Huffman chunk's K5 inputs on the card.
//
// Replaces the part of dvda_tpu/codecs/mlp/native_engine.py:111-267 (the
// jitted chunk program _uniform_arena_pipeline between the arenas'
// upload and the filter) that K5 reads: the bitpos, codebook, lsb_bits,
// offset, quant and nbyp arrays sliced from the arenas, widened to int32
// and the per-chain quant broadcast over each chain's blocks (:140-172;
// chunk_lanes.cuh says exactly what).  The rest of that front end, the
// filter's inputs, is read by K1a (chunk_filter.cu) from the arenas
// itself.  The chunk program launches K10 only in device Huffman, once a
// chunk, on the current stream, before K5 and K1a.
//
// Bound: bytes (at the 5.1/96k headline chunk about 0.65 MB: 0.19 read,
// 0.46 written), so in practice a launch.  Every output is written one
// element a thread, consecutive threads on consecutive outputs, each
// reading its source by the index arithmetic of chunk_lanes_element.
// The descriptor is a kernel parameter (passed by value, read in place as
// a __grid_constant__): nothing is uploaded per chunk.
#include <cuda_runtime.h>

#include "chunk_lanes.cuh"

namespace {

// One block's output elements of substream s, from e0 on.
__device__ __forceinline__ void chunk_lanes_block(const ChunkLanesSub& s,
                                                  int64_t e0,
                                                  const ChunkArenas& A,
                                                  int32_t* __restrict__ out32) {
#pragma unroll
  for (int k = 0; k < kChunkLanesPerThread; ++k) {
    const int64_t e = e0 + (int64_t)k * kChunkLanesThreads + threadIdx.x;
    if (e < s.elems) chunk_lanes_element(s, A, (int32_t)e, out32);
  }
}

__global__ void __launch_bounds__(kChunkLanesThreads)
    chunk_lanes_kernel(const __grid_constant__ ChunkLanesDesc d,
                       const ChunkArenas A, int32_t* __restrict__ out32) {
  int64_t e0;
  // the substream by a constant index: with d.sub[i] at a runtime index
  // ptxas kept the kernel at 32 registers and spilled (an 8-byte stack)
  switch (chunk_lanes_locate(d, blockIdx.x, &e0)) {
    case 0: chunk_lanes_block(d.sub[0], e0, A, out32); break;
    case 1: chunk_lanes_block(d.sub[1], e0, A, out32); break;
    case 2: chunk_lanes_block(d.sub[2], e0, A, out32); break;
    default: chunk_lanes_block(d.sub[3], e0, A, out32);
  }
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError(), or -1 when
// ``n_words`` is not the descriptor's size in int64 words (the wrapper and
// this file disagree on its layout) or the descriptor is not a
// device-Huffman chunk's of at most kChunkLanesMaxSubs substreams.  Never
// synchronises and allocates nothing.
extern "C" int dvda_chunk_lanes(const int64_t* desc, int64_t n_words,
                                const int32_t* a4, const int16_t* a2,
                                const int8_t* a1, int32_t* out32,
                                void* stream) {
  if (n_words * 8 != (int64_t)sizeof(ChunkLanesDesc)) return -1;
  ChunkLanesDesc d;
  memcpy(&d, desc, sizeof d);
  if (!chunk_lanes_desc_ok(d)) return -1;
  const int64_t blocks = chunk_lanes_plan(d);
  if (blocks <= 0) return 0;
  chunk_lanes_kernel<<<(unsigned)blocks, kChunkLanesThreads, 0,
                       (cudaStream_t)stream>>>(d, ChunkArenas{a4, a2, a1},
                                               out32);
  return (int)cudaGetLastError();
}
