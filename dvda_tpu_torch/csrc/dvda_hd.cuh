// Host/device qualifier shared by the kernel bodies.
//
// Each lane body (c2_decrypt.cuh, frame_remix.cuh, general_gather.cuh,
// huffman_decode.cuh, mlp_filter.cuh, output_stage.cuh, pcm_unpack.cuh) is
// written once and compiled twice: by nvcc for the card (the .cu files) and
// by g++ for the CPU harness (cpu_harness.cc) that the tests hold against
// the plain PyTorch versions.
#pragma once

#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define DVDA_HD __host__ __device__ __forceinline__
#else
#define DVDA_HD inline
#endif

// 16 bytes at a 16-byte aligned address: one vector load or store on the
// card.  Separate loads and stores, so a caller can have several loads in
// flight before its first store.
struct DvdaWords4 {
  int32_t w[4];
};
DVDA_HD DvdaWords4 dvda_load16(const int32_t* src) {
  DvdaWords4 v;
#if defined(__CUDA_ARCH__)
  const int4 x = *reinterpret_cast<const int4*>(src);
  v.w[0] = x.x, v.w[1] = x.y, v.w[2] = x.z, v.w[3] = x.w;
#else
  memcpy(v.w, src, 16);
#endif
  return v;
}
DVDA_HD void dvda_store16(int32_t* dst, const DvdaWords4& v) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int4*>(dst) = make_int4(v.w[0], v.w[1], v.w[2], v.w[3]);
#else
  memcpy(dst, v.w, 16);
#endif
}

// Shifts with XLA's semantics: an amount of 32 or more (as unsigned) gives 0.
// In C++ such a shift is undefined behaviour.
DVDA_HD uint32_t dvda_shl(uint32_t x, uint32_t s) {
  return s < 32u ? x << s : 0u;
}
DVDA_HD uint32_t dvda_shr(uint32_t x, uint32_t s) {
  return s < 32u ? x >> s : 0u;
}
