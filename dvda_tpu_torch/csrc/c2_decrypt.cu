// K7: CPPM sector decryption (C2 content keys + D-CBC) on the card.
//
// Replaces dvda_tpu/ops/c2_decrypt.py::dcbc_dec_device and
// content_keys_device (with _F, _schedule and _c2_g_vec), the lax.scan of
// 240 D-CBC steps over a batch of sectors.  Unlike that program, which takes
// hi/lo word arrays the host built in numpy (cppm/decrypt.py:158-176), this
// kernel works in place on the raw uint8 [N, 2048] sector batch and does the
// whole per-sector function of the host C2 (host/src/c2.cc): pack
// check, scrambling control, content key, D-CBC, control reset and CCI walk.
//
// Bound: the dependent chain, not bytes.  A sector is one serial chain of
// 240 words; only the state after round 5 of a word feeds the next word's
// key, so the chain is a 2-round schedule (one table load) and 5 rounds
// (one table load each) a word.  A 4,096-sector batch is 4,096 chains: a
// warp on each of 128 SMs, and nothing hides a lane's latency but its own
// instructions.  The design keeps everything else off that chain:
//   * a block of one warp stages its 32 sectors (64 KB) into shared memory
//     by TMA bulk copies, a lane's own sector in two (its first 128 bytes
//     on one mbarrier, the rest on another): the content keys are computed
//     while the rest lands.  Bulk copies need a 16-byte aligned batch (a
//     fresh allocation always is; the wrapper raises on any other);
//   * the block builds the two derived tables of c2_decrypt.cuh (sbox << 4
//     and P(sbox_f), 1 KB each) in static shared memory while the copies
//     fly, so that a lookup addresses its table by an immediate offset.
//     32 lane replicas of them (32 KB each: no bank conflicts) were slower
//     on the H100 (PERF.md);
//   * word 0 is peeled, and the loop over the later words runs rounds 4..0
//     of word w-1 beside the schedule and rounds 9..5 of word w, with the
//     next word loaded a pass ahead;
//   * each plaintext word is stored to the batch as it is made (the
//     lanes' stores are uncoalesced, but off the chain and one a pass), so
//     no pass writes the tile back.
// A block stays one warp so that a 4,096-sector batch spreads over 128 SMs
// (a track's tail batch is smaller: 284 sectors are 9 warps).
#include <cuda_runtime.h>

#include "c2_decrypt.cuh"

namespace {

//: dynamic shared memory a block takes: the tile of staged rows
constexpr int kSmemBytes = 4 * DVDA_C2_LANES * DVDA_C2_PITCH;

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ``bytes`` of global ``src`` to shared ``dst`` (both 16-byte aligned, a
// multiple of 16) by a TMA bulk copy completing on ``bar``.
__device__ __forceinline__ void bulk_copy(uint8_t* dst, const uint8_t* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar))
        : "memory");
}

__global__ void __launch_bounds__(DVDA_C2_LANES) c2_decrypt_kernel(
    uint8_t* __restrict__ sectors, int64_t n, uint64_t k_au,
    int preserve_cci, const uint32_t* __restrict__ sbox_g,
    const uint32_t* __restrict__ sbox_f_g) {
  extern __shared__ __align__(16) uint32_t tile[];
  __shared__ uint32_t s_key4[256], s_mixf[256];
  __shared__ __align__(8) uint64_t s_bar[2];  // the heads, the rest
  const int lane = threadIdx.x;
  const int64_t first = (int64_t)blockIdx.x * DVDA_C2_LANES;
  const int ns = (int)(n - first < DVDA_C2_LANES ? n - first : DVDA_C2_LANES);
  uint8_t* batch = sectors + first * DVDA_SECTOR_SIZE;
  uint8_t* sec = c2_tile_row(tile, lane);
  uint8_t* out = batch + (int64_t)lane * DVDA_SECTOR_SIZE;
  const int rest = DVDA_SECTOR_SIZE - DVDA_C2_HEAD;
  if (lane == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem(&s_bar[b])),
                   "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem(&s_bar[0])),
        "r"(ns * DVDA_C2_HEAD)
        : "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem(&s_bar[1])),
        "r"(ns * rest)
        : "memory");
  }
  __syncwarp();
  if (lane < ns) {
    bulk_copy(sec, out, DVDA_C2_HEAD, &s_bar[0]);
    bulk_copy(sec + DVDA_C2_HEAD, out + DVDA_C2_HEAD, rest, &s_bar[1]);
  }
  for (int j = lane; j < 256; j += DVDA_C2_LANES) {
    s_key4[j] = c2_derive_table(0, j, sbox_g, sbox_f_g);
    s_mixf[j] = c2_derive_table(1, j, sbox_g, sbox_f_g);
  }
  const C2Tables t{s_key4, s_mixf};
  wait_phase0(&s_bar[0]);
  __syncthreads();
  const int kind = lane < ns ? c2_sector_kind(sec) : 0;
  const uint64_t key = kind == 2 ? c2_content_key(sec, k_au, t) : 0;
  wait_phase0(&s_bar[1]);
  __syncthreads();
  c2_decrypt_rest(sec, out, kind, key, preserve_cci != 0, t);
}

}  // namespace

// ``sectors``: device uint8 [n, 2048] at a 16-byte aligned address,
// decrypted in place.  ``sbox`` and ``sbox_f``: device uint32 [256] each.
// Launches on ``stream`` and returns the error of the shared-memory request
// or cudaGetLastError(); never synchronises, allocates nothing, and
// launches nothing when n == 0.
extern "C" int dvda_c2_decrypt(uint8_t* sectors, int64_t n, uint64_t k_au,
                               int preserve_cci, const uint32_t* sbox,
                               const uint32_t* sbox_f, void* stream) {
  if (n < 0 || ((uintptr_t)sectors & 15)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n + DVDA_C2_LANES - 1) / DVDA_C2_LANES;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      c2_decrypt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  c2_decrypt_kernel<<<(unsigned)blocks, DVDA_C2_LANES, kSmemBytes,
                      (cudaStream_t)stream>>>(sectors, n, k_au, preserve_cci,
                                              sbox, sbox_f);
  return (int)cudaGetLastError();
}
