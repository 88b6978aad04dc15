// K5 sub-lane body: the MLP Huffman residual decode (mlp.c:1122-1241) for
// one sub-lane, i.e. the samples [u*k, min(S0, u*k + k)) of block l, read
// from the raw bitstream words.
//
// Semantics are dvda_tpu.ops.huffman_decode.decode_residuals_device: per
// sample, an optional bypass burst of nbyp <= 6 bits fused into channel
// slot 0, then per channel slot j a Huffman MSB (9-bit peek, value and
// length by arithmetic for codebooks 1-3) and an LSB field of lsb_bits
// bits; value = ((msb << lsb_bits) + lsb + offset) << quant.  The widest
// symbol is 39 bits (6 burst + 9 code + 24 LSB bits), so slot 0 reads three
// words; the rest read two.
//
// Inputs (layouts of the JAX function):
//   words      uint32 [n_words]  big-endian stream words (a whole track)
//   word_base  int64             word index that bitpos is relative to
//   bitpos     int32 [L, nsub]   sub-lane start bits, relative to word_base*32
//   codebook, lsb_bits, offset, quant  int32 [L, C]
//   nbyp       int32 [L]         bypassed-LSB bits per sample
//   bypk, bypv int8 [L, 6] or null: the slot map of the bypass burst
// Outputs (each may be null):
//   res        NB0 > 0: int32 [NB0, S0, C*Bc] (L = Bc*NB0, chain-major);
//              NB0 == 0: int32 [C, L, S0]
//   byp_field  int32 [L, S0]  the 6-bit burst field (bit 5-m = m-th symbol)
//   byp_slots  int8  [L*S0]   bit m = the bypassed LSB of rematrix slot m,
//              K234's ``byp`` layout (needs bypk/bypv)
//
// C++ is stricter than XLA: a shift by 32 or more, a left shift of a
// negative int32 and signed overflow are undefined.  Every shift here is on
// uint32, by an amount below 32 or through dvda_shl/dvda_shr, which give
// XLA's result (0) for larger amounts; the sums wrap in uint32.  Word loads
// outside [0, n_words) read 0, so a corrupt table cannot read out of bounds.
//
// The stream is read through a word source: the track's words in device
// memory (HuffmanGlobalWords), or a window of them staged in shared memory
// (HuffmanWindowWords, which flags a read outside the window so that the
// block decodes again from device memory).  A sub-lane keeps three
// consecutive words and a bit offset in registers (HuffmanBits), the words
// the symbol at ``pos`` reads, and reads the fourth ahead at each symbol,
// shifted in as the offset passes 32: one load a symbol instead of two or
// three, issued before the symbol needs it.  The MSB code comes from a
// table (huffman_code_entry, filled by the codebook arithmetic), so lanes
// of other codebooks do not diverge.  A sub-lane's slot constants are made
// before its symbol loop when C is a compile-time width (1-8).
#pragma once

#include "dvda_hd.cuh"

// Chains of a thread block: as many whole chains (all their blocks and
// sub-lanes) as fill kHuffmanThreads sub-lanes, at least one; and the
// stream words a block stages at most (96 KB of shared memory).
constexpr int kHuffmanThreads = 128;
constexpr int kHuffmanWindowWords = 24576;

// Bit length of x (0 for 0): __clz on the card, __builtin_clz on the host,
// where it is undefined for 0.
DVDA_HD int dvda_bitlen(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return 32 - __clz((int)x);
#else
  return x ? 32 - __builtin_clz(x) : 0;
#endif
}

// (value, length) of the MSB code under codebook cb (1, 2, or 3 for any
// other positive cb) from the 9-bit peek p: the codebooks are
// unary-structured (dvda_tpu/codecs/mlp/codebooks.py), so both follow from
// p's leading zeros.  Same formulas as codebook_arith_decode.  The length
// is at most 10 (p == 0 under any codebook).  It fills the code table.
DVDA_HD void huffman_codebook_decode(int cb, int p, int* val, int* len) {
  const int m = 9 - dvda_bitlen((uint32_t)p);            // leading zeros
  const int m01 = 7 - dvda_bitlen((uint32_t)p & 0x7Fu);  // zeros after "01"
  const bool top1 = (p >> 8) == 1;
  const int top2 = p >> 7;
  const bool mid = top2 == 1;  // the "01 0^m01 1" class of every book
  const int v1 = top1 ? (p >> 6) + 3 : mid ? 11 + m01 : 8 - m;
  const int n1 = top1 ? 3 : mid ? 3 + m01 : m + 1;
  const int v2 = top2 == 3 ? 8 : top2 == 2 ? 7 : mid ? 9 + m01 : 8 - m;
  const int n2 = top2 >= 2 ? 2 : mid ? 3 + m01 : m + 1;
  const int v3 = top1 ? 7 : mid ? 8 + m01 : 8 - m;
  const int n3 = top1 ? 1 : mid ? 3 + m01 : m + 1;
  *val = cb == 1 ? v1 : cb == 2 ? v2 : v3;
  *len = cb == 1 ? n1 : cb == 2 ? n2 : n3;
}

// The high word of (hi:lo) << b for 0 <= b < 32: the 32 stream bits from
// bit b of word hi on.
DVDA_HD uint32_t dvda_funnel_l(uint32_t lo, uint32_t hi, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, b);
#else
  return b ? (hi << b) | (lo >> (32u - b)) : hi;
#endif
}

DVDA_HD uint32_t dvda_word(const uint32_t* __restrict__ words,
                           int64_t n_words, int64_t i) {
  return (i >= 0 && i < n_words) ? words[i] : 0u;
}

// The track's words in device memory, by absolute index.
struct HuffmanGlobalWords {
  using Index = int64_t;
  const uint32_t* __restrict__ words;
  int64_t n_words;
  DVDA_HD Index index(int64_t i) const { return i; }
  DVDA_HD int64_t absolute(Index i) const { return i; }
  DVDA_HD uint32_t operator()(Index i) const {
    return dvda_word(words, n_words, i);
  }
};

// Words [lo, lo + n) staged at win[0..n), by index relative to lo.  A read
// outside the window (a bound the window missed) returns a clamped word
// and sets ``outside``; the block then decodes again from device memory,
// so no result depends on the window.  No branch on the read path.
struct HuffmanWindowWords {
  using Index = uint32_t;
  const uint32_t* win;
  int64_t lo;
  uint32_t n;
  bool outside;
  DVDA_HD Index index(int64_t i) {
    const int64_t o = i - lo;
    outside |= (uint64_t)o >= n;
    return (Index)o;
  }
  DVDA_HD int64_t absolute(Index i) const { return lo + i; }
  DVDA_HD uint32_t operator()(Index i) {
    const uint32_t o = (uint32_t)i;
    outside |= o >= n;
    return win[o < n ? o : n - 1];
  }
};

// Words wi, wi+1, wi+2 of the stream and the bit offset b in the first:
// wi = word_base + (pos >> 5), b = pos & 31, in the source's index.
template <class Words>
struct HuffmanBits {
  uint32_t w0, w1, w2, b;
  typename Words::Index wi;
};

template <class Words>
DVDA_HD void huffman_seek(HuffmanBits<Words>& r, Words& W, int64_t word_base,
                          int64_t pos) {
  r.wi = W.index(word_base + (pos >> 5));
  r.b = (uint32_t)(pos & 31);
  r.w0 = W(r.wi);
  r.w1 = W(r.wi + 1);
  r.w2 = W(r.wi + 2);
}

// Advance by adv0 + nb + lbb bits.  ``next`` is word wi + 3, read at the
// symbol's start, off the chain: an advance that passes the offset 32
// shifts it in by selects.  A second word (more than 32 bits) takes a
// branch, and so does an advance of 64 bits or more, or any advance of a
// lane whose tables are outside the parser's ranges (``sane`` false),
// which is summed in 64 bits: a corrupt table's jump either way.
template <class Words>
DVDA_HD void huffman_skip(HuffmanBits<Words>& r, Words& W, int64_t word_base,
                          bool sane, int adv0, int nb, int lbb,
                          uint32_t next) {
  const uint32_t n = (uint32_t)adv0 + (uint32_t)nb + (uint32_t)lbb;
  if (!sane || n >= 64u) {
    huffman_seek(r, W, word_base,
                 (W.absolute(r.wi) - word_base) * 32 + r.b +
                     ((int64_t)adv0 + nb + lbb));
    return;
  }
  r.b += n;
  const bool s1 = r.b >= 32u;
  r.w0 = s1 ? r.w1 : r.w0;
  r.w1 = s1 ? r.w2 : r.w1;
  r.w2 = s1 ? next : r.w2;
  r.wi += s1;
  r.b -= s1 ? 32u : 0u;
  if (r.b >= 32u) {
    r.w0 = r.w1;
    r.w1 = r.w2;
    ++r.wi;
    r.w2 = W(r.wi + 2);
    r.b -= 32u;
  }
}

struct HuffmanArgs {
  int L, nsub, C, S0, k, NB0;
  bool has_burst;
  int64_t word_base;
  const int32_t* __restrict__ bitpos;
  const int32_t* __restrict__ codebook;
  const int32_t* __restrict__ lsb_bits;
  const int32_t* __restrict__ offset;
  const int32_t* __restrict__ quant;
  const int32_t* __restrict__ nbyp;
  const int8_t* __restrict__ bypk;
  const int8_t* __restrict__ bypv;
  int32_t* __restrict__ res;
  int32_t* __restrict__ byp_field;
  int8_t* __restrict__ byp_slots;
};

// The MSB code table: row t (0: no Huffman MSB, 1-3: codebook t, where 3
// stands for any codebook above 2) and 9-bit peek p give
// (length << 8) | (value + 1), the value in [-1, 18] and the length at
// most 10.  kHuffmanCodeRows * 512 entries, built once per thread block.
constexpr int kHuffmanCodeRows = 4;
DVDA_HD uint16_t huffman_code_entry(int t, int p) {
  if (t == 0) return 1;  // value 0, length 0
  int val, len;
  huffman_codebook_decode(t, p, &val, &len);
  return (uint16_t)(len << 8 | (val + 1));
}

// One slot's decode constants, from its codebook, lsb_bits, offset and
// quant: the code table row, and XLA's shift rule (0 for an amount of 32
// or more) as a mask beside each shift.
struct HuffmanSlot {
  uint32_t row;    // code table offset of the slot's codebook
  int32_t lbb;     // LSB field width
  uint32_t lmask;  // the LSB field's mask (0 for lbb <= 0)
  uint32_t lz;     // ~0 where lbb is a shift below 32, else 0
  uint32_t off;
  uint32_t qz;     // ~0 where quant is a shift below 32, else 0
  uint32_t q;
  bool sane;       // 0 <= lbb <= 32: advances stay small
};

DVDA_HD HuffmanSlot huffman_slot(int cb, int lbb, int off, int q) {
  HuffmanSlot t;
  t.row = (uint32_t)(cb <= 0 ? 0 : cb == 1 ? 1 : cb == 2 ? 2 : 3) * 512u;
  t.lbb = lbb;
  t.lmask = lbb <= 0 ? 0u : dvda_shl(1u, (uint32_t)lbb) - 1u;
  t.lz = (uint32_t)lbb < 32u ? ~0u : 0u;
  t.off = (uint32_t)off;
  t.qz = (uint32_t)q < 32u ? ~0u : 0u;
  t.q = (uint32_t)q;
  t.sane = lbb >= 0 && lbb <= 32;
  return t;
}

// A lane's slot constants: in registers for a compile-time width kC, made
// at each symbol for kC == 0 (any C).
template <int kC>
struct HuffmanSlots {
  HuffmanSlot s[kC];
  bool sane;
  DVDA_HD HuffmanSlots(const HuffmanArgs& a, int64_t row) {
    sane = true;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      s[j] = huffman_slot(a.codebook[row + j], a.lsb_bits[row + j],
                          a.offset[row + j], a.quant[row + j]);
      sane = sane && s[j].sane;
    }
  }
  DVDA_HD HuffmanSlot operator[](int j) const { return s[j]; }
};

template <>
struct HuffmanSlots<0> {
  const HuffmanArgs& a;
  int64_t r;
  bool sane = false;  // every advance checked in 64 bits
  DVDA_HD HuffmanSlots(const HuffmanArgs& a_, int64_t row) : a(a_), r(row) {}
  DVDA_HD HuffmanSlot operator[](int j) const {
    return huffman_slot(a.codebook[r + j], a.lsb_bits[r + j],
                        a.offset[r + j], a.quant[r + j]);
  }
};

// Whole chains of a thread block (nb0e blocks of nsub sub-lanes each).
DVDA_HD int huffman_chains_per_block(int nb0e, int nsub) {
  const int per_chain = nb0e * nsub;
  return per_chain >= kHuffmanThreads ? 1 : kHuffmanThreads / per_chain;
}

// Sub-lane q of the block whose first chain is c0 (nc chains): the chain
// fastest, then the block, then the sub-lane u.
DVDA_HD void huffman_block_sublane(int q, int c0, int nc, int nb0e, int* l,
                                   int* u) {
  const int r = q / nc;
  *l = (c0 + q % nc) * nb0e + r % nb0e;
  *u = r / nb0e;
}

// The stream words sub-lane (l, u) reads at most: [*lo, *hi).  False when
// a table lies outside the parser's ranges (nbyp 0-32 with a burst,
// lsb_bits 0-32), where no bound is taken.  Per sample it advances at most
// the burst, then per slot a 10-bit code and its LSB field; the three
// words at the last position and the one read ahead of them end the range.
DVDA_HD bool huffman_sublane_words(const HuffmanArgs& a, int l, int u,
                                   int64_t* lo, int64_t* hi) {
  const int64_t start = a.bitpos[(int64_t)l * a.nsub + u];
  int64_t per = 0;
  if (a.has_burst) {
    const int nb = a.nbyp[l];
    if (nb < 0 || nb > 32) return false;
    per = nb;
  }
  for (int j = 0; j < a.C; ++j) {
    const int lbb = a.lsb_bits[(int64_t)l * a.C + j];
    if (lbb < 0 || lbb > 32) return false;
    per += 10 + lbb;
  }
  int n = a.S0 - u * a.k;
  n = n < 0 ? 0 : n > a.k ? a.k : n;
  *lo = a.word_base + (start >> 5);
  *hi = a.word_base + ((start + per * n) >> 5) + 4;
  return true;
}

template <int kC, class Words>
DVDA_HD void huffman_decode_sublane(int l, int u, const HuffmanArgs& a,
                                    const uint16_t* __restrict__ code,
                                    Words& W) {
  const int C = kC > 0 ? kC : a.C;
  const HuffmanSlots<kC> t(a, (int64_t)l * C);
  const int nb_l = a.nbyp[l];
  const bool sane = t.sane && (!a.has_burst || (nb_l >= 0 && nb_l <= 32));
  const uint32_t nbyp_u = (uint32_t)nb_l;
  // keep bits k < nbyp of the 6-bit burst field (the rest is stream noise)
  const int32_t byp_keep =
      0x3F & ~(int32_t)(dvda_shl(1u, (uint32_t)(6 - nb_l)) - 1u);
  // the slot map: slot m's bit is burst symbol bypk[m] where bypv[m]
  uint32_t sk[6] = {}, sv[6] = {};
  if (a.byp_slots) {
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      sk[m] = (uint32_t)(5 - a.bypk[l * 6 + m]);
      sv[m] = (uint32_t)a.bypv[l * 6 + m];
    }
  }
  const int Bc = a.NB0 > 0 ? a.L / a.NB0 : 0;
  const int64_t CBc = (int64_t)C * Bc;
  // output of (sample s, slot j): res[row + s * s_step + j * j_step]
  const int64_t row = a.NB0 > 0
                          ? (int64_t)(l % a.NB0) * a.S0 * CBc + l / a.NB0
                          : (int64_t)l * a.S0;
  const int64_t s_step = a.NB0 > 0 ? CBc : 1;
  const int64_t j_step = a.NB0 > 0 ? Bc : (int64_t)a.L * a.S0;

  HuffmanBits<Words> r;
  huffman_seek(r, W, a.word_base, a.bitpos[(int64_t)l * a.nsub + u]);
  for (int i = 0; i < a.k; ++i) {
    const int s = u * a.k + i;
    if (s >= a.S0) break;
    int32_t* const out = a.res ? a.res + row + s * s_step : nullptr;
    int32_t packed = 0;
#pragma unroll
    for (int j = 0; j < (kC > 0 ? kC : C); ++j) {
      const uint32_t next = W(r.wi + 3);  // read ahead, off the chain
      const uint32_t b = r.b;
      // the 32 stream bits from pos on
      uint32_t hi = dvda_funnel_l(r.w1, r.w0, b);
      uint32_t ext;  // stream bit pos+32 (after the burst shift in slot 0)
      int adv0 = 0;
      if (j == 0 && a.has_burst) {
        packed = (int32_t)(hi >> 26) & byp_keep;
        const uint32_t hi2 = dvda_funnel_l(r.w2, r.w1, b);
        if (nb_l > 0)
          hi = dvda_shl(hi, nbyp_u) | (hi2 >> ((32u - nbyp_u) & 31u));
        ext = dvda_shr(hi2, 31u - nbyp_u) & 1u;
        adv0 = nb_l;
      } else {
        ext = (r.w1 >> (31u - b)) & 1u;
      }

      const HuffmanSlot c = t[j];
      const uint32_t ce = code[c.row + (hi >> 23)];
      const int msb = (int)(ce & 0xFFu) - 1;
      const int nb = (int)(ce >> 8);
      // LSB field = window bits [nb, nb+lbb), nb+lbb <= 33: the 32-bit
      // window plus the extension bit cover it
      const int e = nb + c.lbb;
      const uint32_t r33 =
          e <= 32 ? hi >> ((uint32_t)(32 - e) & 31u) : (hi << 1) | ext;
      const uint32_t v =
          (((((uint32_t)msb << (c.lbb & 31)) & c.lz) + (r33 & c.lmask) +
            c.off)
           << (c.q & 31u)) &
          c.qz;
      if (out) out[j * j_step] = (int32_t)v;
      huffman_skip(r, W, a.word_base, sane, adv0, nb, c.lbb, next);
    }
    const int64_t ls = (int64_t)l * a.S0 + s;
    if (a.byp_field) a.byp_field[ls] = packed;
    if (a.byp_slots) {
      uint32_t bits = 0;
#pragma unroll
      for (int m = 0; m < 6; ++m)
        bits |= ((dvda_shr((uint32_t)packed, sk[m]) & 1u) & sv[m]) << m;
      a.byp_slots[ls] = (int8_t)bits;
    }
  }
}
