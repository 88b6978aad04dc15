// K5: the MLP Huffman residual decode on the card.
//
// Replaces dvda_tpu/ops/huffman_decode.py::decode_residuals_device (with
// codebook_arith_decode), the XLA scan that re-decodes residual values
// from the raw bitstream in device-Huffman mode: the host parse walks the
// residual bits length-only and ships one start bit per block (or per
// k-sample sub-lane); the device decodes the values ahead of K1.
//
// Bound: the dependent chain and one warp's issue, not bytes.  Each
// sub-lane is a serial chain of k*C variable-length symbols (160 at the
// 5.1/96k headline's 4-channel substream, 80 at its 2-channel one): where
// a symbol starts depends on the one before, and a launch has 4,096
// sub-lanes, one warp per SM scheduler at most.  The design keeps device
// memory off that chain and the instructions on it few:
//   * a thread block owns consecutive whole chains, all their blocks and
//     sub-lanes, as many as fill 128 threads: 8 chains of 16 blocks at the
//     headline (32 blocks a launch, one warp on each of 128 schedulers).
//     Fewer chains a block would spread the same warps over more SMs and
//     shrink the window, but 8 consecutive chains make a warp's residual
//     stores whole 32-byte sectors of the [NB0, S0, C*Bc] layout;
//   * the block first stages its window of stream words (a chain's bits
//     are one contiguous range of the stream), from its lowest start bit
//     to its highest plus what k samples can read (a burst, then per slot
//     a 10-bit code and its LSB field) and 4 words, into shared memory by
//     16-byte cp.async copies, all in flight at once: at most 24,576
//     words (96 KB of dynamic shared memory; 7,000-8,500 words a block at
//     the headline);
//   * a wider window (a corrupt table, or start bits spread at random as in
//     the synthetic tests) makes that block read device memory, as before;
//     the body is one template over the word source, and a read outside
//     the staged window (a bound it missed) sets a flag on which the block
//     decodes again from device memory, so no result depends on the window;
//   * a sub-lane keeps three stream words in registers and reads the next
//     ahead at each symbol, shifted in by selects as its bit offset passes
//     32; the MSB code's value and length come from a 4 KB table in shared
//     memory (built per block) in one load instead of the codebook
//     arithmetic, so lanes of other codebooks do not diverge; its slot
//     constants (codebook row, LSB mask, offset, quant, burst width and
//     slot map) are loaded before its loop, and the advance is summed in 32
//     bits where its tables are in the parser's ranges.
// One launch per substream, as before.
#include <cuda_runtime.h>

#include "huffman_decode.cuh"

namespace {

constexpr int kWarps = kHuffmanThreads / 32;

template <int kC>
__global__ void __launch_bounds__(kHuffmanThreads) huffman_decode_kernel(
    HuffmanArgs a, const int32_t* __restrict__ word_base_ptr,
    const uint32_t* __restrict__ words, int64_t n_words, int nb0e,
    int chains) {
  extern __shared__ __align__(16) uint32_t s_win[];
  __shared__ int64_t s_lo[kWarps], s_hi[kWarps];
  __shared__ int s_ok[kWarps];
  __shared__ uint16_t s_code[kHuffmanCodeRows * 512];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * chains;
  const int Bce = a.L / nb0e;
  const int nc = min(chains, Bce - c0);
  const int n = nc * nb0e * a.nsub;  // sub-lanes of this block
  if (word_base_ptr) a.word_base += *word_base_ptr;
  for (int i = tid; i < kHuffmanCodeRows * 512; i += kHuffmanThreads)
    s_code[i] = huffman_code_entry(i >> 9, i & 511);

  // the window: the words every sub-lane of the block reads at most
  int64_t lo = INT64_MAX, hi = INT64_MIN;
  int ok = 1;
  for (int q = tid; q < n; q += kHuffmanThreads) {
    int l, u;
    huffman_block_sublane(q, c0, nc, nb0e, &l, &u);
    int64_t wl, wh;
    if (huffman_sublane_words(a, l, u, &wl, &wh)) {
      lo = wl < lo ? wl : lo;
      hi = wh > hi ? wh : hi;
    } else {
      ok = 0;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int64_t ol = __shfl_xor_sync(0xFFFFFFFFu, (long long)lo, o);
    const int64_t oh = __shfl_xor_sync(0xFFFFFFFFu, (long long)hi, o);
    lo = ol < lo ? ol : lo;
    hi = oh > hi ? oh : hi;
  }
  ok = __all_sync(0xFFFFFFFFu, ok);
  if ((tid & 31) == 0) {
    s_lo[tid >> 5] = lo;
    s_hi[tid >> 5] = hi;
    s_ok[tid >> 5] = ok;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = s_lo[w] < lo ? s_lo[w] : lo;
    hi = s_hi[w] > hi ? s_hi[w] : hi;
    ok &= s_ok[w];
  }
  const int64_t lo4 = lo & ~(int64_t)3;  // floor to a 16-byte boundary
  const bool staged = ok && n > 0 && hi - lo4 <= kHuffmanWindowWords;

  if (staged) {
    // every 16-byte copy of the window in flight at once (cp.async), the
    // words at the stream's ends through dvda_word
    const int chunks = (int)((hi - lo4 + 3) >> 2);
    const bool aligned = ((uintptr_t)words & 15) == 0;
    for (int c = tid; c < chunks; c += kHuffmanThreads) {
      const int64_t w = lo4 + 4 * (int64_t)c;
      if (aligned && w >= 0 && w + 4 <= n_words) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(s_win + 4 * c)),
                     "l"(words + w));
      } else {
        uint4 v;
        v.x = dvda_word(words, n_words, w);
        v.y = dvda_word(words, n_words, w + 1);
        v.z = dvda_word(words, n_words, w + 2);
        v.w = dvda_word(words, n_words, w + 3);
        *reinterpret_cast<uint4*>(s_win + 4 * c) = v;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    HuffmanWindowWords W{s_win, lo4, 4u * chunks, false};
    for (int q = tid; q < n; q += kHuffmanThreads) {
      int l, u;
      huffman_block_sublane(q, c0, nc, nb0e, &l, &u);
      huffman_decode_sublane<kC>(l, u, a, s_code, W);
    }
    // a read outside the window: the whole block again from device memory
    if (!__syncthreads_or(W.outside)) return;
  }
  HuffmanGlobalWords G{words, n_words};
  for (int q = tid; q < n; q += kHuffmanThreads) {
    int l, u;
    huffman_block_sublane(q, c0, nc, nb0e, &l, &u);
    huffman_decode_sublane<kC>(l, u, a, s_code, G);
  }
}

template <int kC>
int launch(const HuffmanArgs& a, const int32_t* word_base_ptr,
           const uint32_t* words, int64_t n_words, cudaStream_t stream) {
  const int nb0e = a.NB0 > 0 ? a.NB0 : 1;  // NB0 == 0: a lane is a chain
  const int chains = huffman_chains_per_block(nb0e, a.nsub);
  const int Bce = a.L / nb0e;
  const int blocks = (Bce + chains - 1) / chains;
  const int smem = 4 * (kHuffmanWindowWords + 4);
  cudaError_t err = cudaFuncSetAttribute(
      huffman_decode_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  huffman_decode_kernel<kC><<<blocks, kHuffmanThreads, smem, stream>>>(
      a, word_base_ptr, words, n_words, nb0e, chains);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError(); never synchronises
// and allocates nothing (the caller owns every buffer).  The word base is
// ``word_base`` plus, when ``word_base_ptr`` is not null, the int32 it
// points to on the device (the chunk arena's scalar: no host round trip).
// Null outputs are not written; bypk/bypv may be null unless byp_slots
// is given.
extern "C" int dvda_huffman_decode(
    const uint32_t* words, int64_t n_words, const int32_t* word_base_ptr,
    int64_t word_base, const int32_t* bitpos, const int32_t* codebook,
    const int32_t* lsb_bits, const int32_t* offset, const int32_t* quant,
    const int32_t* nbyp, const int8_t* bypk, const int8_t* bypv,
    int32_t* res, int32_t* byp_field, int8_t* byp_slots, int L, int nsub,
    int C, int S0, int k, int has_burst, int NB0, void* stream) {
  if ((int64_t)L * nsub <= 0) return 0;
  const HuffmanArgs a{L,      nsub,     C,        S0,     k,
                      NB0,    has_burst != 0,     word_base,
                      bitpos, codebook, lsb_bits, offset, quant,
                      nbyp,   bypk,     bypv,     res,    byp_field,
                      byp_slots};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch<1>(a, word_base_ptr, words, n_words, s);
    case 2: return launch<2>(a, word_base_ptr, words, n_words, s);
    case 3: return launch<3>(a, word_base_ptr, words, n_words, s);
    case 4: return launch<4>(a, word_base_ptr, words, n_words, s);
    case 5: return launch<5>(a, word_base_ptr, words, n_words, s);
    case 6: return launch<6>(a, word_base_ptr, words, n_words, s);
    case 7: return launch<7>(a, word_base_ptr, words, n_words, s);
    case 8: return launch<8>(a, word_base_ptr, words, n_words, s);
    default: return launch<0>(a, word_base_ptr, words, n_words, s);
  }
}
