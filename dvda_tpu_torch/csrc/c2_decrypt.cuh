// K7 sector body: CPPM decryption of one 2048-byte AOB sector, in place.
//
// Semantics are the host C2 (host/src/c2.cc, c2_decrypt_sectors, a copy of
// dvda_tpu's) and dvda_tpu/cppm/decrypt.py::CppmDecryptor, after
// cppm_decrypt_block and mpeg2_reset_cci (cppm.c:486-614):
//   1. a pack sector starts 00 00 01 BA; it is scrambled when the PES
//      scrambling control (sec[20] >> 4) & 3 is non-zero;
//   2. the content key is 5 chained c2_g over the big-endian 64-bit fields
//      at offsets 24, 32, 40, 48 and 84, starting from k_au and masked to
//      56 bits after each step;
//   3. D-CBC over the 240 big-endian words of bytes 128..2047: word 0 with
//      the 10-round key schedule, later words with the 2-round one
//      (sk[rnd % 2]); the next word's key is key ^ (((R & 0xFFFFFF) << 32)
//      | L) of the state after the swap of round 5;
//   4. sec[20] &= 0xCD clears the scrambling control;
//   5. unless preserve_cci, every pack sector's CCI walk zeroes the
//      copy-control bytes.  The walk never leaves its sector, so running it
//      right after the sector's own decryption is "after decryption".
//
// The card runs these steps on a block's tile of 32 staged sectors
// (c2_decrypt.cu), a lane a sector; the g++ harness runs them on the same
// tile with the lanes emulated.  A staged sector is a row of
// DVDA_C2_PITCH words: 2,064 bytes, 16-byte aligned for the card's bulk
// copies (the 32 lanes' 8-byte reads of word w of their own rows then meet
// a 2-way bank conflict, off the dependent chain; a 2,056-byte pitch
// would avoid it but takes 8-byte copies, which staged 3.5x slower on the
// H100: PERF.md).  Steps 1-2 read only the sector's first 128
// bytes (c2_sector_kind, c2_content_key), so they can run while the rest
// of the tile is still being copied.  Every byte that changes is written
// twice: to the staged row, which later steps read, and at once to the
// sector in the batch (``out``), so no pass writes the tile back.
//
// The tables are the cipher's SBOX and SBOX_F (uint32 [256] each) in two
// derived forms, built by c2_derive_table: sbox << 4, the schedule's
// addend, and P(SBOX_F[i]) with P(x) = x ^ rotl(x, 9) ^ rotl(x, 22).  P is
// linear over xor, so F(code, key) = P(w) ^ P(SBOX_F[w & 0xFF]) with
// w = code + key: the rotations of w run beside the table load instead of
// after it, two operations fewer on each round's dependent chain.  All
// arithmetic is uint32: L - F wraps, ka is cut to 24 bits before each
// schedule step, and every shift is below 32.
#pragma once

#include "dvda_hd.cuh"

#define DVDA_SECTOR_SIZE 2048
#define DVDA_ENC_OFFSET 128
#define DVDA_ENC_WORDS 240
//: sectors a block stages, one a lane
#define DVDA_C2_LANES 32
//: 32-bit words a staged sector's row takes in shared memory
#define DVDA_C2_PITCH 516
//: bytes of a sector that the first steps read
#define DVDA_C2_HEAD 128

DVDA_HD uint32_t dvda_rotl32(uint32_t x, int s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, s);
#else
  return (x << s) | (x >> (32 - s));
#endif
}

DVDA_HD uint32_t dvda_bswap32(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(v, 0, 0x0123);
#else
  return (v >> 24) | ((v >> 8) & 0xFF00u) | ((v << 8) & 0xFF0000u) |
         (v << 24);
#endif
}

DVDA_HD uint32_t c2_mix(uint32_t x) {
  return x ^ dvda_rotl32(x, 9) ^ dvda_rotl32(x, 22);
}

// Entry i of the derived tables: which 0 is sbox[i] << 4, which 1 is
// P(sbox_f[i]).
DVDA_HD uint32_t c2_derive_table(int which, int i, const uint32_t* sbox,
                                 const uint32_t* sbox_f) {
  return which == 0 ? sbox[i] << 4 : c2_mix(sbox_f[i]);
}

// The two derived tables (in the block's shared memory on the card).
struct C2Tables {
  const uint32_t* key4;  // sbox << 4
  const uint32_t* mixf;  // P(sbox_f)
};

// One decryption round: (L, R) <- (R, L - F(R, k)).
DVDA_HD void c2_round(uint32_t& L, uint32_t& R, uint32_t k,
                      const C2Tables& t) {
  const uint32_t w = R + k;
  const uint32_t nr = L - (c2_mix(w) ^ t.mixf[w & 0xFFu]);
  L = R;
  R = nr;
}

// The 10 subkeys of the 56-bit key (ka: high 24 bits, kb: low 32).
DVDA_HD void c2_schedule10(uint32_t ka, uint32_t kb, uint32_t* sk,
                           const C2Tables& t) {
#pragma unroll
  for (int rnd = 0; rnd < 10; ++rnd) {
    ka &= 0x00FFFFFFu;
    sk[rnd] = kb + t.key4[(ka & 0xFFu) ^ (uint32_t)rnd];
    const uint32_t kc = kb >> 15;
    const uint32_t kd = ka >> 7;
    ka = (ka << 17) | kc;
    kb = (kb << 17) | kd;
  }
}

// The 2 subkeys of a later word.  The second lookup's index,
// ((ka << 17 | kb >> 15) & 0xFF) ^ 1, depends on kb alone, so the two
// loads issue together.
DVDA_HD void c2_schedule2(uint32_t ka, uint32_t kb, uint32_t& s0,
                          uint32_t& s1, const C2Tables& t) {
  s0 = kb + t.key4[ka & 0xFFu];
  s1 = ((kb << 17) | ((ka & 0x00FFFFFFu) >> 7)) +
       t.key4[((kb >> 15) & 0xFFu) ^ 1u];
}

// c2_g(code, key) & 0x00FFFFFFFFFFFFFF: C2 encryption xor the input.
DVDA_HD uint64_t c2_g56(uint64_t code, uint64_t key, const C2Tables& t) {
  uint32_t sk[10];
  c2_schedule10((uint32_t)(key >> 32) & 0x00FFFFFFu, (uint32_t)key, sk, t);
  uint32_t L = (uint32_t)(code >> 32), R = (uint32_t)code;
#pragma unroll
  for (int rnd = 0; rnd < 10; ++rnd) {
    const uint32_t w = R + sk[rnd];
    const uint32_t nr = L + (c2_mix(w) ^ t.mixf[w & 0xFFu]);
    L = R;
    R = nr;
  }
  // final swap: the output is (R, L)
  const uint64_t enc = ((uint64_t)R << 32) | L;
  return (enc ^ code) & 0x00FFFFFFFFFFFFFFull;
}

DVDA_HD uint32_t dvda_be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// Word w of the span: its big-endian halves (L, R), one 8-byte load.
DVDA_HD void c2_load_word(const uint8_t* sec, int w, uint32_t& L,
                          uint32_t& R) {
  const uint8_t* p = sec + DVDA_ENC_OFFSET + 8 * w;
#if defined(__CUDA_ARCH__)
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#else
  struct { uint32_t x, y; } v;
  memcpy(&v, p, 8);
#endif
  L = dvda_bswap32(v.x);
  R = dvda_bswap32(v.y);
}

// The plaintext of word w from the state after round 0 (final swap), to
// the staged row and to the sector in the batch (16-byte aligned).
DVDA_HD void c2_store_word(uint8_t* sec, uint8_t* out, int w, uint32_t L,
                           uint32_t R) {
  const int at = DVDA_ENC_OFFSET + 8 * w;
#if defined(__CUDA_ARCH__)
  const uint2 v = make_uint2(dvda_bswap32(R), dvda_bswap32(L));
  *reinterpret_cast<uint2*>(sec + at) = v;
  *reinterpret_cast<uint2*>(out + at) = v;
#else
  const uint32_t v[2] = {dvda_bswap32(R), dvda_bswap32(L)};
  memcpy(sec + at, v, 8);
  memcpy(out + at, v, 8);
#endif
}

// Rounds 9..5 of word w (subkeys s1, s0, s1, s0, s1) and rounds 4..0 of
// word w-1 (q0, q1, q0, q1, q0), one of each in turn: the card issues a
// warp's instructions in order, so the two independent chains interleave
// only where the code does.
DVDA_HD void c2_rounds_pair(uint32_t& L, uint32_t& R, uint32_t s0,
                            uint32_t s1, uint32_t& pL, uint32_t& pR,
                            uint32_t q0, uint32_t q1, const C2Tables& t) {
  c2_round(L, R, s1, t);
  c2_round(pL, pR, q0, t);
  c2_round(L, R, s0, t);
  c2_round(pL, pR, q1, t);
  c2_round(L, R, s1, t);
  c2_round(pL, pR, q0, t);
  c2_round(L, R, s0, t);
  c2_round(pL, pR, q1, t);
  c2_round(L, R, s1, t);
  c2_round(pL, pR, q0, t);
}

// D-CBC over the span with the content key (key_hi: 24 bits, key_lo).
// Word 0 is peeled with its 10-round schedule; the loop over the later
// words is straight-line and software-pipelined: each pass runs rounds
// 4..0 of word w-1 beside the schedule and rounds 9..5 of word w, the
// only part on the chain from one word's key to the next
// (c2_rounds_pair).  The next word's halves are loaded a pass ahead.
DVDA_HD void c2_dcbc(uint8_t* sec, uint8_t* out, uint32_t key_hi,
                     uint32_t key_lo, const C2Tables& t) {
  uint32_t sk[10];
  c2_schedule10(key_hi, key_lo, sk, t);
  uint32_t pL, pR;  // word w-1 after round 5
  c2_load_word(sec, 0, pL, pR);
#pragma unroll
  for (int rnd = 9; rnd >= 5; --rnd) c2_round(pL, pR, sk[rnd], t);
  uint32_t ka = key_hi ^ (pR & 0x00FFFFFFu), kb = key_lo ^ pL;
  uint32_t nL, nR;  // word w's ciphertext
  c2_load_word(sec, 1, nL, nR);
  uint32_t q0, q1;  // word w-1's subkeys
  {
    uint32_t s0, s1, L = nL, R = nR;
    c2_schedule2(ka, kb, s0, s1, t);
    c2_load_word(sec, 2, nL, nR);
    c2_round(pL, pR, sk[4], t);
    c2_round(L, R, s1, t);
    c2_round(pL, pR, sk[3], t);
    c2_round(L, R, s0, t);
    c2_round(pL, pR, sk[2], t);
    c2_round(L, R, s1, t);
    c2_round(pL, pR, sk[1], t);
    c2_round(L, R, s0, t);
    c2_round(pL, pR, sk[0], t);
    c2_round(L, R, s1, t);
    c2_store_word(sec, out, 0, pL, pR);
    ka = key_hi ^ (R & 0x00FFFFFFu);
    kb = key_lo ^ L;
    pL = L, pR = R, q0 = s0, q1 = s1;
  }
  for (int w = 2; w < DVDA_ENC_WORDS; ++w) {
    uint32_t s0, s1, L = nL, R = nR;
    c2_schedule2(ka, kb, s0, s1, t);
    // past the last word: word w again, unused (a select, not a branch)
    c2_load_word(sec, w + 1 < DVDA_ENC_WORDS ? w + 1 : w, nL, nR);
    c2_rounds_pair(L, R, s0, s1, pL, pR, q0, q1, t);
    c2_store_word(sec, out, w - 1, pL, pR);
    ka = key_hi ^ (R & 0x00FFFFFFu);
    kb = key_lo ^ L;
    pL = L, pR = R, q0 = s0, q1 = s1;
  }
#pragma unroll
  for (int rnd = 4; rnd >= 0; --rnd) c2_round(pL, pR, rnd & 1 ? q1 : q0, t);
  c2_store_word(sec, out, DVDA_ENC_WORDS - 1, pL, pR);
}

// A byte of the sector set in the staged row and in the batch.
DVDA_HD void c2_set_byte(uint8_t* sec, uint8_t* out, int i, uint8_t v) {
  sec[i] = v;
  out[i] = v;
}

// mpeg2_reset_cci (cppm.c:582-614; c2.cc reset_cci) on the staged row
// ``sec``; every byte it zeroes is zeroed in ``out`` too.
DVDA_HD void c2_reset_cci(uint8_t* sec, uint8_t* out) {
  int pos = 14 + (sec[13] & 0x07);
  while (pos + 9 <= DVDA_SECTOR_SIZE) {
    if (!(sec[pos] == 0 && sec[pos + 1] == 0 && sec[pos + 2] == 1)) break;
    const int pes_len = ((int)sec[pos + 4] << 8) | sec[pos + 5];
    if (sec[pos + 3] == 0xBD) {
      const int p = pos + 9 + sec[pos + 8];
      if (p + 13 <= DVDA_SECTOR_SIZE) {
        if (sec[p] == 0xA0 && sec[p + 3] > 8)
          c2_set_byte(sec, out, p + 12, 0);
        else if (sec[p] == 0xA1 && sec[p + 3] > 4)
          c2_set_byte(sec, out, p + 8, 0);
      }
    }
    pos += 6 + pes_len;
  }
}

// What a staged sector is, from its first 128 bytes: 0 not a pack (left
// as it is), 1 a clear pack (the CCI walk only), 2 a scrambled pack.
DVDA_HD int c2_sector_kind(const uint8_t* sec) {
  if (!(sec[0] == 0 && sec[1] == 0 && sec[2] == 1 && sec[3] == 0xBA))
    return 0;
  return ((sec[20] >> 4) & 0x3) != 0 ? 2 : 1;
}

// The content key of a scrambled sector, from its first 128 bytes.
DVDA_HD uint64_t c2_content_key(const uint8_t* sec, uint64_t k_au,
                                const C2Tables& t) {
  const int offs[5] = {24, 32, 40, 48, 84};
  uint64_t key = k_au;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint64_t f = ((uint64_t)dvda_be32(sec + offs[j]) << 32) |
                       dvda_be32(sec + offs[j] + 4);
    key = c2_g56(f, key, t);
  }
  return key;
}

// The rest of a pack sector once its row is staged whole: D-CBC and the
// control reset if it is scrambled (kind 2), then the CCI walk.
DVDA_HD void c2_decrypt_rest(uint8_t* sec, uint8_t* out, int kind,
                             uint64_t key, bool preserve_cci,
                             const C2Tables& t) {
  if (kind == 2) {
    c2_dcbc(sec, out, (uint32_t)(key >> 32), (uint32_t)key, t);
    c2_set_byte(sec, out, 20, sec[20] & 0xCD);
  }
  if (kind != 0 && !preserve_cci) c2_reset_cci(sec, out);
}

// The staged row of sector s of a block's tile.
DVDA_HD uint8_t* c2_tile_row(uint32_t* tile, int s) {
  return reinterpret_cast<uint8_t*>(tile + s * DVDA_C2_PITCH);
}
