// P-256 field, curve and per-signature verify routines shared by the CUDA
// kernels (cuda_comb.cu, cuda_ecdsa.cu) and the g++ host harness
// (host_harness.cc), on top of the modulus-generic 8-word Montgomery field
// of field256.cuh.  Every routine is __host__ __device__ when compiled by
// nvcc and plain inline C++ under g++, so the same arithmetic that runs on
// the card is checked against Python integers on a CPU.
#pragma once

#include "field256.cuh"

#define P256_HD F256_HD
#define P256_UNROLL F256_UNROLL
#define P256_NO_UNROLL F256_NO_UNROLL

namespace p256 {

using f256::Fe;
using f256::Mod;
using f256::add_words;
using f256::comb_digit;
using f256::eq;
using f256::fe_const;
using f256::fe_raw_one;
using f256::fe_zero;
using f256::is_zero;
using f256::load_fe;
using f256::lt;
using f256::mod_add;
using f256::mod_sub;
using f256::mont_mul;
using f256::mont_sqr;
using f256::select;
using f256::sub_words;

struct Pt {
  Fe x, y, z;
};

#define P256_WORDS_P {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, \
                      0x00000000u, 0x00000000u, 0x00000001u, 0xFFFFFFFFu}
#define P256_WORDS_N {0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu, \
                      0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu}

P256_HD Mod mod_p() { return Mod{P256_WORDS_P, 0x00000001u}; }
P256_HD Mod mod_n() { return Mod{P256_WORDS_N, 0xEE00BC4Fu}; }

// R mod p, R mod n: Montgomery 1
P256_HD Fe p_one() {
  return fe_const(0x00000001u, 0x00000000u, 0x00000000u, 0xFFFFFFFFu,
                  0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu, 0x00000000u);
}
P256_HD Fe n_one() {
  return fe_const(0x039CDAAFu, 0x0C46353Du, 0x58E8617Bu, 0x43190552u,
                  0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0x00000000u);
}
// R^2 mod p, R^2 mod n: to_mont(x) = mont_mul(x, R2)
P256_HD Fe p_r2() {
  return fe_const(0x00000003u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFBu,
                  0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFDu, 0x00000004u);
}
P256_HD Fe n_r2() {
  return fe_const(0xBE79EEA2u, 0x83244C95u, 0x49BD6FA6u, 0x4699799Cu,
                  0x2B6BEC59u, 0x2845B239u, 0xF3D95620u, 0x66E12D94u);
}
// curve b, G in Montgomery form
P256_HD Fe b_mont() {
  return fe_const(0x29C4BDDFu, 0xD89CDF62u, 0x78843090u, 0xACF005CDu,
                  0xF7212ED6u, 0xE5A220ABu, 0x04874834u, 0xDC30061Du);
}
P256_HD Fe gx_mont() {
  return fe_const(0x18A9143Cu, 0x79E730D4u, 0x5FEDB601u, 0x75BA95FCu,
                  0x77622510u, 0x79FB732Bu, 0xA53755C6u, 0x18905F76u);
}
P256_HD Fe gy_mont() {
  return fe_const(0xCE95560Au, 0xDDF25357u, 0xBA19E45Cu, 0x8B4AB8E4u,
                  0xDD21F325u, 0xD2E88688u, 0x25885D85u, 0x8571FF18u);
}

// word i of the inversion exponent n - 2 (little-endian); the 4-bit
// digits of the Fermat ladder are read out of it, so they are constants
// of the program and not an operand
P256_HD uint32_t inv_exp_word(int i) {
  switch (i) {
    case 0: return 0xFC63254Fu;
    case 1: return 0xF3B9CAC2u;
    case 2: return 0xA7179E84u;
    case 3: return 0xBCE6FAADu;
    case 4: return 0xFFFFFFFFu;
    case 5: return 0xFFFFFFFFu;
    case 6: return 0x00000000u;
    default: return 0xFFFFFFFFu;
  }
}

// ---------------------------------------------------------------------------
// scalar field: inversion mod n
// ---------------------------------------------------------------------------

// 1/s mod n by Fermat (s^(n-2)) with a 4-bit fixed window; s and the
// result are Montgomery values mod n.  The 16 powers sit in local memory.
P256_HD Fe inv_mod_n(const Fe& s) {
  const Mod m = mod_n();
  Fe pows[16];
  pows[0] = n_one();
  pows[1] = s;
P256_NO_UNROLL
  for (int k = 2; k < 16; ++k) pows[k] = mont_mul(pows[k - 1], s, m);
  Fe acc = pows[(inv_exp_word(7) >> 28) & 15u];
P256_NO_UNROLL
  for (int i = 1; i < 64; ++i) {
    int bit = 4 * (63 - i);
    uint32_t d = (inv_exp_word(bit >> 5) >> (bit & 31)) & 15u;
P256_UNROLL
    for (int k = 0; k < 4; ++k) acc = mont_sqr(acc, m);
    acc = mont_mul(acc, pows[d], m);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// base field: Montgomery products mod p that use p's special form
// ---------------------------------------------------------------------------
//
// p = 2^256 - 2^224 + 2^192 + 2^96 - 1, so -p^-1 mod 2^32 = 1: each
// reduction round takes q = t[i], and adding q * p * 2^(32 i) clears word i
// and adds q at word i + 3, q at i + 6 and q * (2^32 - 1) at words i + 7 and
// i + 8 (lo = -q, hi = q - (q != 0)).  No multiply; the carry out of word
// i + 8 is kept aside and added once at the end, since words from 9 up are
// never read as a later q.  Same contract as mont_mul(a, b, mod_p()): a <
// 2^256, b < p, result fully reduced (< p), R = 2^256.  On the card the
// carry chains are PTX (mad.lo.cc / madc.hi.cc / addc.cc); the portable
// form beside them is what g++ builds for the host harness.

#ifdef __CUDA_ARCH__

// t[0..8] += a * bi (t[8] enters as 0); no carry leaves t[8]
__device__ __forceinline__ void p_row(uint32_t* t, const Fe& a, uint32_t bi) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(bi));
}

// one reduction round on t[3..8] with q = t[0]; returns the carry out of
// t[8]
__device__ __forceinline__ uint32_t p_redc_round(uint32_t* t) {
  uint32_t c;
  asm("{\n\t.reg .u32 lo, hi;\n\t"
      "sub.cc.u32 lo, 0, %7;\n\t"
      "subc.u32 hi, %7, 0;\n\t"
      "add.cc.u32 %0, %0, %7;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, %7;\n\t"
      "addc.cc.u32 %4, %4, lo;\n\t"
      "addc.cc.u32 %5, %5, hi;\n\t"
      "addc.u32 %6, 0, 0;\n\t}"
      : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "=r"(c)
      : "r"(t[0]));
  return c;
}

// t[9..16] += c[0..7] (t[16] enters as 0)
__device__ __forceinline__ void p_add_carries(uint32_t* t, const uint32_t* c) {
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %15, 0;"
      : "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]),
        "+r"(t[14]), "+r"(t[15]), "=r"(t[16])
      : "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(c[5]),
        "r"(c[6]), "r"(c[7]));
}

// t[8..16] (< 2p) -> t - p if t >= p, else t
__device__ __forceinline__ Fe p_final_sub(const uint32_t* t) {
  Fe d;
  uint32_t keep;
  asm("sub.cc.u32 %0, %9, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %1, %10, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %2, %11, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %3, %12, 0;\n\t"
      "subc.cc.u32 %4, %13, 0;\n\t"
      "subc.cc.u32 %5, %14, 0;\n\t"
      "subc.cc.u32 %6, %15, 1;\n\t"
      "subc.cc.u32 %7, %16, 0xFFFFFFFF;\n\t"
      "subc.u32 %8, %17, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(keep)
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]), "r"(t[16]));
  // keep = t[16] - borrow: all ones when t < p, else 0
  Fe out;
P256_UNROLL
  for (int j = 0; j < 8; ++j)
    out.v[j] = (t[8 + j] & keep) | (d.v[j] & ~keep);
  return out;
}

// t (17 words, t[16] = 0) = the 512-bit a * b
__device__ __forceinline__ void p_mul_wide(uint32_t* t, const Fe& a,
                                           const Fe& b) {
P256_UNROLL
  for (int j = 0; j < 17; ++j) t[j] = 0;
P256_UNROLL
  for (int i = 0; i < 8; ++i) p_row(t + i, a, b.v[i]);
}

// t (17 words, t[16] = 0) = the 512-bit a * a: 28 cross products (row i:
// t[2i+1 .. i+8] += a[i+1..7] * a[i]), doubled by a shift, plus the 8
// squares on the diagonal
__device__ __forceinline__ void p_sqr_wide(uint32_t* t, const Fe& a) {
P256_UNROLL
  for (int j = 0; j < 17; ++j) t[j] = 0;
  asm("mad.lo.cc.u32 %0, %9, %8, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %8, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %8, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %8, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %8, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %8, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %8, %6;\n\t"
      "addc.u32 %7, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %8, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %8, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %8, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %8, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %8, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %8, %6;\n\t"
      "madc.hi.u32 %7, %15, %8, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %8, %7, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %7, %2;\n\t"
      "madc.lo.cc.u32 %3, %11, %7, %3;\n\t"
      "madc.lo.cc.u32 %4, %12, %7, %4;\n\t"
      "madc.lo.cc.u32 %5, %13, %7, %5;\n\t"
      "addc.u32 %6, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %8, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %7, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %7, %3;\n\t"
      "madc.hi.cc.u32 %4, %11, %7, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %7, %5;\n\t"
      "madc.hi.u32 %6, %13, %7, %6;"
      : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9])
      : "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %7, %6, %0;\n\t"
      "madc.lo.cc.u32 %1, %8, %6, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %6, %2;\n\t"
      "madc.lo.cc.u32 %3, %10, %6, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %6, %4;\n\t"
      "addc.u32 %5, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %7, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %8, %6, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %6, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %6, %4;\n\t"
      "madc.hi.u32 %5, %11, %6, %5;"
      : "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10])
      : "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]),
        "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %6, %5, %0;\n\t"
      "madc.lo.cc.u32 %1, %7, %5, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %5, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %5, %3;\n\t"
      "addc.u32 %4, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %6, %5, %1;\n\t"
      "madc.hi.cc.u32 %2, %7, %5, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %5, %3;\n\t"
      "madc.hi.u32 %4, %9, %5, %4;"
      : "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11])
      : "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %5, %4, %0;\n\t"
      "madc.lo.cc.u32 %1, %6, %4, %1;\n\t"
      "madc.lo.cc.u32 %2, %7, %4, %2;\n\t"
      "addc.u32 %3, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %5, %4, %1;\n\t"
      "madc.hi.cc.u32 %2, %6, %4, %2;\n\t"
      "madc.hi.u32 %3, %7, %4, %3;"
      : "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %4, %3, %0;\n\t"
      "madc.lo.cc.u32 %1, %5, %3, %1;\n\t"
      "addc.u32 %2, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %4, %3, %1;\n\t"
      "madc.hi.u32 %2, %5, %3, %2;"
      : "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
      : "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %3, %2, %0;\n\t"
      "addc.u32 %1, 0, 0;\n\t"
      "mad.hi.u32 %1, %3, %2, %1;"
      : "+r"(t[13]), "+r"(t[14])
      : "r"(a.v[6]), "r"(a.v[7]));
P256_UNROLL
  for (int j = 15; j > 0; --j) t[j] = __funnelshift_l(t[j - 1], t[j], 1);
  t[0] <<= 1;
  asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
}

#else  // portable C++: the same steps with 64-bit partial sums

P256_HD void p_mul_wide(uint32_t* t, const Fe& a, const Fe& b) {
  for (int j = 0; j < 17; ++j) t[j] = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < 8; ++j) {
      uint64_t uv = (uint64_t)a.v[j] * b.v[i] + t[i + j] + c;
      t[i + j] = (uint32_t)uv;
      c = uv >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
}

P256_HD void p_sqr_wide(uint32_t* t, const Fe& a) {
  for (int j = 0; j < 17; ++j) t[j] = 0;
  for (int i = 0; i < 7; ++i) {
    uint64_t c = 0;
    for (int j = i + 1; j < 8; ++j) {
      uint64_t uv = (uint64_t)a.v[j] * a.v[i] + t[i + j] + c;
      t[i + j] = (uint32_t)uv;
      c = uv >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  for (int j = 15; j > 0; --j) t[j] = (t[j] << 1) | (t[j - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t sq = (uint64_t)a.v[i] * a.v[i];
    uint64_t lo = (uint64_t)t[2 * i] + (uint32_t)sq + c;
    t[2 * i] = (uint32_t)lo;
    uint64_t hi = (uint64_t)t[2 * i + 1] + (sq >> 32) + (lo >> 32);
    t[2 * i + 1] = (uint32_t)hi;
    c = hi >> 32;
  }
}

P256_HD uint32_t p_redc_round(uint32_t* t) {
  const uint32_t q = t[0];
  const uint32_t lo = 0u - q, hi = q - (q != 0u);
  const uint32_t add[6] = {q, 0u, 0u, q, lo, hi};
  uint64_t c = 0;
  for (int j = 0; j < 6; ++j) {
    uint64_t s = (uint64_t)t[3 + j] + add[j] + c;
    t[3 + j] = (uint32_t)s;
    c = s >> 32;
  }
  return (uint32_t)c;
}

P256_HD void p_add_carries(uint32_t* t, const uint32_t* c) {
  uint64_t s = 0;
  for (int j = 0; j < 8; ++j) {
    s = (uint64_t)t[9 + j] + c[j] + (s >> 32);
    t[9 + j] = (uint32_t)s;
  }
}

P256_HD Fe p_final_sub(const uint32_t* t) {
  const uint32_t pw[8] = P256_WORDS_P;
  Fe lo = load_fe(t + 8), d;
  uint32_t borrow = sub_words(d, lo, pw);
  return select(t[16] | (borrow ^ 1u), d, lo);
}

#endif  // __CUDA_ARCH__

// t (17 words, a product below p * 2^256) -> t * 2^-256 mod p
P256_HD Fe p_redc(uint32_t* t) {
  uint32_t c[8];
P256_UNROLL
  for (int i = 0; i < 8; ++i) c[i] = p_redc_round(t + i);
  p_add_carries(t, c);
  return p_final_sub(t);
}

// a * b * 2^-256 mod p: 64 word products, then the shift-and-add reduction
P256_HD Fe p_mul(const Fe& a, const Fe& b) {
  uint32_t t[17];
  p_mul_wide(t, a, b);
  return p_redc(t);
}

// a * a * 2^-256 mod p: 36 word products (28 cross, doubled, + 8 squares)
P256_HD Fe p_sqr(const Fe& a) {
  uint32_t t[17];
  p_sqr_wide(t, a);
  return p_redc(t);
}

#ifdef __CUDA_ARCH__

// a + b mod p, a, b < p: one carry chain, then a - p chain, then a select
__device__ __forceinline__ Fe p_add(const Fe& a, const Fe& b) {
  Fe s, d;
  uint32_t keep;
  asm("{\n\t.reg .u32 cy;\n\t"
      "add.cc.u32 %0, %17, %25;\n\t"
      "addc.cc.u32 %1, %18, %26;\n\t"
      "addc.cc.u32 %2, %19, %27;\n\t"
      "addc.cc.u32 %3, %20, %28;\n\t"
      "addc.cc.u32 %4, %21, %29;\n\t"
      "addc.cc.u32 %5, %22, %30;\n\t"
      "addc.cc.u32 %6, %23, %31;\n\t"
      "addc.cc.u32 %7, %24, %32;\n\t"
      "addc.u32 cy, 0, 0;\n\t"
      "sub.cc.u32 %8, %0, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %9, %1, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %10, %2, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %11, %3, 0;\n\t"
      "subc.cc.u32 %12, %4, 0;\n\t"
      "subc.cc.u32 %13, %5, 0;\n\t"
      "subc.cc.u32 %14, %6, 1;\n\t"
      "subc.cc.u32 %15, %7, 0xFFFFFFFF;\n\t"
      "subc.u32 %16, cy, 0;\n\t"
      "}"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]), "=r"(s.v[4]),
        "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7]), "=r"(d.v[0]), "=r"(d.v[1]),
        "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]),
        "=r"(d.v[7]), "=r"(keep)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  // keep = carry - borrow: all ones when a + b < p, else 0
  Fe out;
P256_UNROLL
  for (int j = 0; j < 8; ++j) out.v[j] = (s.v[j] & keep) | (d.v[j] & ~keep);
  return out;
}

// a - b mod p, a, b < p: a - b, then p added back under the borrow's mask
__device__ __forceinline__ Fe p_sub(const Fe& a, const Fe& b) {
  Fe out;
  asm("{\n\t.reg .u32 w0, w1, w2, w3, w4, w5, w6, w7, mk, mk1;\n\t"
      "sub.cc.u32 w0, %8, %16;\n\t"
      "subc.cc.u32 w1, %9, %17;\n\t"
      "subc.cc.u32 w2, %10, %18;\n\t"
      "subc.cc.u32 w3, %11, %19;\n\t"
      "subc.cc.u32 w4, %12, %20;\n\t"
      "subc.cc.u32 w5, %13, %21;\n\t"
      "subc.cc.u32 w6, %14, %22;\n\t"
      "subc.cc.u32 w7, %15, %23;\n\t"
      "subc.u32 mk, 0, 0;\n\t"
      "and.b32 mk1, mk, 1;\n\t"
      "add.cc.u32 %0, w0, mk;\n\t"
      "addc.cc.u32 %1, w1, mk;\n\t"
      "addc.cc.u32 %2, w2, mk;\n\t"
      "addc.cc.u32 %3, w3, 0;\n\t"
      "addc.cc.u32 %4, w4, 0;\n\t"
      "addc.cc.u32 %5, w5, 0;\n\t"
      "addc.cc.u32 %6, w6, mk1;\n\t"
      "addc.u32 %7, w7, mk;\n\t"
      "}"
      : "=r"(out.v[0]), "=r"(out.v[1]), "=r"(out.v[2]), "=r"(out.v[3]),
        "=r"(out.v[4]), "=r"(out.v[5]), "=r"(out.v[6]), "=r"(out.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return out;
}

#else

P256_HD Fe p_add(const Fe& a, const Fe& b) { return mod_add(a, b, mod_p()); }
P256_HD Fe p_sub(const Fe& a, const Fe& b) { return mod_sub(a, b, mod_p()); }

#endif  // __CUDA_ARCH__

// ---------------------------------------------------------------------------
// curve: homogeneous projective (X : Y : Z), Montgomery coordinates,
// Renes-Costello-Batina 2015 complete formulas for a = -3
// ---------------------------------------------------------------------------

P256_HD Pt pt_inf() { return Pt{fe_zero(), p_one(), fe_zero()}; }

// RCB15 Algorithm 4: complete addition (any inputs, identity included)
P256_HD Pt pt_add(const Pt& p, const Pt& q) {
  const Mod m = mod_p();
  const Fe b = b_mont();
  Fe a1 = mod_add(p.x, p.y, m), a2 = mod_add(q.x, q.y, m);
  Fe a4 = mod_add(p.y, p.z, m), a5 = mod_add(q.y, q.z, m);
  Fe a7 = mod_add(p.x, p.z, m), a8 = mod_add(q.x, q.z, m);
  Fe t0 = mont_mul(p.x, q.x, m), t1 = mont_mul(p.y, q.y, m);
  Fe t2 = mont_mul(p.z, q.z, m), m1 = mont_mul(a1, a2, m);
  Fe m2 = mont_mul(a4, a5, m), m3 = mont_mul(a7, a8, m);
  Fe a3 = mod_add(t0, t1, m), a6 = mod_add(t1, t2, m);
  Fe a9 = mod_add(t0, t2, m), u1 = mod_add(t2, t2, m);
  Fe w1 = mod_add(t0, t0, m);
  Fe t3 = mod_sub(m1, a3, m), t4 = mod_sub(m2, a6, m);
  Fe y3a = mod_sub(m3, a9, m);
  Fe u2 = mod_add(u1, t2, m), w2 = mod_add(w1, t0, m);
  Fe zb = mont_mul(b, t2, m), yb = mont_mul(b, y3a, m);
  Fe x3a = mod_sub(y3a, zb, m), t0b = mod_sub(w2, u2, m);
  Fe y3b = mod_sub(yb, u2, m);
  Fe z3a = mod_add(x3a, x3a, m);
  Fe y3c = mod_sub(y3b, t0, m);
  Fe x3b = mod_add(x3a, z3a, m), v1 = mod_add(y3c, y3c, m);
  Fe x3c = mod_add(t1, x3b, m), y3d = mod_add(v1, y3c, m);
  Fe z3b = mod_sub(t1, x3b, m);
  Fe p1 = mont_mul(t4, y3d, m), p2 = mont_mul(t0b, y3d, m);
  Fe p3 = mont_mul(x3c, z3b, m), p4 = mont_mul(t3, x3c, m);
  Fe p5 = mont_mul(t4, z3b, m), p6 = mont_mul(t3, t0b, m);
  Pt r;
  r.y = mod_add(p3, p2, m);
  r.z = mod_add(p5, p6, m);
  r.x = mod_sub(p4, p1, m);
  return r;
}

// RCB15 Algorithm 6: complete doubling
P256_HD Pt pt_dbl(const Pt& p) {
  const Mod m = mod_p();
  const Fe b = b_mont();
  Fe t0 = mont_sqr(p.x, m), t1 = mont_sqr(p.y, m), t2 = mont_sqr(p.z, m);
  Fe xy = mont_mul(p.x, p.y, m), xz = mont_mul(p.x, p.z, m);
  Fe yz = mont_mul(p.y, p.z, m);
  Fe t3 = mod_add(xy, xy, m), z3a = mod_add(xz, xz, m);
  Fe yz2 = mod_add(yz, yz, m), t2a = mod_add(t2, t2, m);
  Fe t0a = mod_add(t0, t0, m);
  Fe t2_3 = mod_add(t2a, t2, m), t0_3 = mod_add(t0a, t0, m);
  Fe bt2 = mont_mul(b, t2, m), bz3 = mont_mul(b, z3a, m);
  Fe y3a = mod_sub(bt2, z3a, m), z3b = mod_sub(bz3, t2_3, m);
  Fe t0d = mod_sub(t0_3, t2_3, m);
  Fe y3a2 = mod_add(y3a, y3a, m);
  Fe z3c = mod_sub(z3b, t0, m);
  Fe y3b = mod_add(y3a2, y3a, m), z3c2 = mod_add(z3c, z3c, m);
  Fe z3d = mod_add(z3c2, z3c, m), y3c = mod_add(t1, y3b, m);
  Fe x3a = mod_sub(t1, y3b, m);
  Fe y3d = mont_mul(x3a, y3c, m), x3b = mont_mul(x3a, t3, m);
  Fe t0b = mont_mul(t0d, z3d, m), zz = mont_mul(yz2, z3d, m);
  Fe zt = mont_mul(yz2, t1, m);
  Pt r;
  r.y = mod_add(y3d, t0b, m);
  Fe zt2 = mod_add(zt, zt, m);
  r.x = mod_sub(x3b, zz, m);
  r.z = mod_add(zt2, zt2, m);
  return r;
}

// (24,) words -> point: X, Y, Z of one comb-table entry
P256_HD Pt load_pt(const uint32_t* src) {
  Pt p;
P256_UNROLL
  for (int j = 0; j < 8; ++j) {
    p.x.v[j] = src[j];
    p.y.v[j] = src[8 + j];
    p.z.v[j] = src[16 + j];
  }
  return p;
}

// ---------------------------------------------------------------------------
// ECDSA verify, shared prologue and epilogue
// ---------------------------------------------------------------------------

struct Scalars {
  Fe u1, u2;      // e/s and r/s mod n, standard domain
  uint32_t ok;    // 1 <= r < n and 1 <= s < n
};

P256_HD Scalars verify_scalars(const Fe& e, const Fe& r, const Fe& s) {
  const Mod mn = mod_n();
  const uint32_t nw[8] = P256_WORDS_N;
  Scalars out;
  out.ok = (is_zero(r) ^ 1u) & lt(r, nw) & (is_zero(s) ^ 1u) & lt(s, nw);
  Fe d;
  uint32_t e_lt_n = sub_words(d, e, nw);
  Fe e_red = select(e_lt_n, e, d);  // e < 2^256 < 2n: one subtraction
  const Fe r2 = n_r2();
  Fe s_m = mont_mul(s, r2, mn);
  Fe r_m = mont_mul(r, r2, mn);
  Fe e_m = mont_mul(e_red, r2, mn);
  Fe w = inv_mod_n(s_m);
  const Fe one = fe_raw_one();
  out.u1 = mont_mul(mont_mul(e_m, w, mn), one, mn);
  out.u2 = mont_mul(mont_mul(r_m, w, mn), one, mn);
  return out;
}

// x(R) mod n == r, compared projectively: x_aff in {r, r + n} with
// x_aff < p, each candidate c tested as c * Z == X; Z != 0
P256_HD uint32_t verify_final(const Pt& acc, const Fe& r) {
  const Mod mp = mod_p();
  const uint32_t pw[8] = P256_WORDS_P;
  Fe nn = Fe{P256_WORDS_N};
  Fe c;
  uint32_t c_carry = add_words(c, r, nn);
  uint32_t c_ok = (c_carry ^ 1u) & lt(c, pw);
  const Fe r2 = p_r2();
  Fe r_mp = mont_mul(r, r2, mp), c_mp = mont_mul(c, r2, mp);
  Fe mr = mont_mul(r_mp, acc.z, mp), mc = mont_mul(c_mp, acc.z, mp);
  uint32_t match = eq(mr, acc.x) | (c_ok & eq(mc, acc.x));
  return match & (is_zero(acc.z) ^ 1u);
}

// ---------------------------------------------------------------------------
// static-key comb verify (one lane): 32 x (double + G entry + Q entry)
// ---------------------------------------------------------------------------

// gtab: (256, 3, 8) words; qtab: this lane's key table, (256, 3, 8) words,
// or null for a key index outside the stack (the lane then fails)
P256_HD uint32_t comb_verify_lane(const uint32_t* e8, const uint32_t* r8,
                                  const uint32_t* s8, const uint32_t* gtab,
                                  const uint32_t* qtab) {
  if (qtab == 0) return 0u;
  const Fe r = load_fe(r8);
  Scalars sc = verify_scalars(load_fe(e8), r, load_fe(s8));
  Pt acc = pt_inf();
P256_NO_UNROLL
  for (int k = 0; k < 32; ++k) {
    int c = 31 - k;
    acc = pt_dbl(acc);
    acc = pt_add(acc, load_pt(gtab + 24 * comb_digit(sc.u1, c)));
    acc = pt_add(acc, load_pt(qtab + 24 * comb_digit(sc.u2, c)));
  }
  return verify_final(acc, r) & sc.ok;
}

// ---------------------------------------------------------------------------
// generic verify (one lane): on-curve check, joint table {iG + jQ},
// 128-digit 2-bit Strauss-Shamir scan.  The kernel runs the group program
// of p256_group.cuh instead; the host harness keeps this one-thread lane
// as a second reference for it.
// ---------------------------------------------------------------------------

P256_HD uint32_t two_bit_digit(const Fe& u, int k) {
  int bit = 2 * (127 - k);
  return (u.v[bit >> 5] >> (bit & 31)) & 3u;
}

P256_HD uint32_t ecdsa_verify_lane(const uint32_t* e8, const uint32_t* r8,
                                   const uint32_t* s8, const uint32_t* qx8,
                                   const uint32_t* qy8) {
  const Mod mp = mod_p();
  const Fe r = load_fe(r8);
  Scalars sc = verify_scalars(load_fe(e8), r, load_fe(s8));
  const Fe r2 = p_r2();
  Fe xm = mont_mul(load_fe(qx8), r2, mp);
  Fe ym = mont_mul(load_fe(qy8), r2, mp);
  // y^2 == x^3 - 3x + b
  Fe yy = mont_sqr(ym, mp), xx = mont_sqr(xm, mp);
  Fe x3 = mont_mul(xx, xm, mp);
  Fe threex = mod_add(mod_add(xm, xm, mp), xm, mp);
  uint32_t oncurve = eq(yy, mod_add(mod_sub(x3, threex, mp), b_mont(), mp));

  const Pt inf = pt_inf();
  const Pt g = Pt{gx_mont(), gy_mont(), p_one()};
  const Pt q = Pt{xm, ym, p_one()};
  Pt gs[4], qs[4];
  gs[0] = inf; gs[1] = g; gs[2] = pt_dbl(g); gs[3] = pt_add(gs[2], g);
  qs[0] = inf; qs[1] = q; qs[2] = pt_dbl(q); qs[3] = pt_add(qs[2], q);
  Pt table[16];
P256_NO_UNROLL
  for (int i = 0; i < 16; ++i) table[i] = pt_add(gs[i >> 2], qs[i & 3]);

  Pt acc = inf;
P256_NO_UNROLL
  for (int k = 0; k < 128; ++k) {
    acc = pt_dbl(pt_dbl(acc));
    acc = pt_add(acc, table[4 * two_bit_digit(sc.u1, k) +
                            two_bit_digit(sc.u2, k)]);
  }
  return verify_final(acc, r) & sc.ok & oncurve;
}

}  // namespace p256
