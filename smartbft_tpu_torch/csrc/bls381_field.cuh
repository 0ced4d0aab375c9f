// BLS12-381 base field and its tower.  The Fp layer (fp_mont, fp_add,
// fp_sub, fp_add_nr) is what the CUDA pairing kernel runs (cuda_bls.cu,
// through bls381_group.cuh's stage program); the tower over it and
// bls381_pairing.cuh are the one-thread lane that the g++ host harness
// (host_harness.cc) holds the stage program to.  The Fp routines are
// __host__ __device__: PTX carry chains on the card, portable C++ under g++
// and in nvcc's host pass, so the arithmetic that runs on the card is
// checked against Python integers on a CPU first (the chains themselves on
// the PTX emulator of tests/test_torch_ptx_chains.py).
//
// Fp: p = 0x1a0111ea...ffffaaab (381 bits) as 12 little-endian 32-bit
// words, Montgomery form with R = 2^384 (the same R as the JAX package's
// 24 x 16-bit limbs, so every Montgomery value and table entry is the same
// number in both).  Products are CIOS Montgomery multiplication; they take
// operands below 4p (a sum of up to four reduced values, fp_add_nr) and
// return a fully reduced value, and every stored value is fully reduced
// below p, so equality is word equality.
// Tower, as crypto/bls12381.py: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 -
// (u+1)), Fp12 = Fp6[w]/(w^2 - v); the Frobenius reads its gamma constants
// from the caller; inversion is Fermat's in Fp under the norm tower.  The
// tower routines are host code (B381_CALL): no kernel calls them.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define B381_HD __host__ __device__ __forceinline__
#define B381_UNROLL _Pragma("unroll")
#define B381_NO_UNROLL _Pragma("unroll 1")
#else
#define B381_HD inline
#define B381_UNROLL
#define B381_NO_UNROLL
#endif
// the tower: host code only
#define B381_CALL inline

// the host harness counts Fp products and squarings (the bound's work,
// cuda_bls.mont_ops); the card counts nothing
#if defined(B381_COUNT_OPS) && !defined(__CUDA_ARCH__)
namespace b381 {
struct OpCount {
  unsigned long long mul, sqr;
};
inline OpCount& op_count() {
  static OpCount c{0, 0};
  return c;
}
}  // namespace b381
#define B381_COUNT(field) (++::b381::op_count().field)
#else
#define B381_COUNT(field) ((void)0)
#endif

namespace b381 {

constexpr int kWords = 12;

struct Fp {
  uint32_t v[kWords];
};
struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c0, c1, c2;
};
struct Fp12 {
  Fp6 c0, c1;
};

#define B381_WORDS_P                                                     \
  {0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu, 0xF6B0F624u,       \
   0x6730D2A0u, 0xF38512BFu, 0x64774B84u, 0x434BACD7u, 0x4B1BA7B6u,       \
   0x397FE69Au, 0x1A0111EAu}
// R mod p: 1 in Montgomery form
#define B381_WORDS_ONE                                                   \
  {0x0002FFFDu, 0x76090000u, 0xC40C0002u, 0xEBF4000Bu, 0x53C758BAu,       \
   0x5F489857u, 0x70525745u, 0x77CE5853u, 0xA256EC6Du, 0x5C071A97u,       \
   0xFA80E493u, 0x15F65EC3u}
// p - 2, the Fermat exponent
#define B381_WORDS_P_MINUS_2                                             \
  {0xFFFFAAA9u, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu, 0xF6B0F624u,       \
   0x6730D2A0u, 0xF38512BFu, 0x64774B84u, 0x434BACD7u, 0x4B1BA7B6u,       \
   0x397FE69Au, 0x1A0111EAu}
// -p^-1 mod 2^32
constexpr uint32_t kN0Inv = 0xFFFCFFFDu;

// ---------------------------------------------------------------------------
// Fp
// ---------------------------------------------------------------------------

B381_HD Fp fp_zero() {
  Fp a;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) a.v[j] = 0;
  return a;
}

B381_HD Fp fp_one() { return Fp{B381_WORDS_ONE}; }

B381_HD Fp load_fp(const uint32_t* src) {
  Fp a;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) a.v[j] = src[j];
  return a;
}

B381_HD void store_fp(uint32_t* dst, const Fp& a) {
B381_UNROLL
  for (int j = 0; j < kWords; ++j) dst[j] = a.v[j];
}

B381_HD bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t d = 0;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) d |= a.v[j] ^ b.v[j];
  return d == 0;
}

#ifdef __CUDA_ARCH__

// The card's Fp: PTX carry chains.  A 12-word CIOS product is 12 rounds of
// a row t += a * b[i] and a reduction row t += m * p (m = t[0] * -p^-1,
// which clears t[0]), then a shift by one word; t stays below 5p < 2^384
// between rounds for a, b < 4p, so t[12] enters every row as 0.

// t[0..12] += a * bi (t[12] enters as 0); no carry leaves t[12]
__device__ __forceinline__ void b_row(uint32_t* t, const Fp& a, uint32_t bi) {
  asm("mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
      "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
      "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
      "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
      "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
      "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
      "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
      "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
      "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
      "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
      "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
      "addc.u32 %12, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %13, %25, %1;\n\t"
      "madc.hi.cc.u32 %2, %14, %25, %2;\n\t"
      "madc.hi.cc.u32 %3, %15, %25, %3;\n\t"
      "madc.hi.cc.u32 %4, %16, %25, %4;\n\t"
      "madc.hi.cc.u32 %5, %17, %25, %5;\n\t"
      "madc.hi.cc.u32 %6, %18, %25, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %25, %7;\n\t"
      "madc.hi.cc.u32 %8, %20, %25, %8;\n\t"
      "madc.hi.cc.u32 %9, %21, %25, %9;\n\t"
      "madc.hi.cc.u32 %10, %22, %25, %10;\n\t"
      "madc.hi.cc.u32 %11, %23, %25, %11;\n\t"
      "madc.hi.u32 %12, %24, %25, %12;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[8]), "r"(a.v[9]),
        "r"(a.v[10]), "r"(a.v[11]), "r"(bi));
}

// t[0..12] += m * p, with the words of p in p[0..11]
__device__ __forceinline__ void b_redc_row(uint32_t* t, const uint32_t* p,
                                           uint32_t m) {
  asm("mad.lo.cc.u32 %0, %25, %13, %0;\n\t"
      "madc.lo.cc.u32 %1, %25, %14, %1;\n\t"
      "madc.lo.cc.u32 %2, %25, %15, %2;\n\t"
      "madc.lo.cc.u32 %3, %25, %16, %3;\n\t"
      "madc.lo.cc.u32 %4, %25, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %25, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %25, %19, %6;\n\t"
      "madc.lo.cc.u32 %7, %25, %20, %7;\n\t"
      "madc.lo.cc.u32 %8, %25, %21, %8;\n\t"
      "madc.lo.cc.u32 %9, %25, %22, %9;\n\t"
      "madc.lo.cc.u32 %10, %25, %23, %10;\n\t"
      "madc.lo.cc.u32 %11, %25, %24, %11;\n\t"
      "addc.u32 %12, %12, 0;\n\t"
      "mad.hi.cc.u32 %1, %25, %13, %1;\n\t"
      "madc.hi.cc.u32 %2, %25, %14, %2;\n\t"
      "madc.hi.cc.u32 %3, %25, %15, %3;\n\t"
      "madc.hi.cc.u32 %4, %25, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %25, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %25, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %25, %19, %7;\n\t"
      "madc.hi.cc.u32 %8, %25, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %25, %21, %9;\n\t"
      "madc.hi.cc.u32 %10, %25, %22, %10;\n\t"
      "madc.hi.cc.u32 %11, %25, %23, %11;\n\t"
      "madc.hi.u32 %12, %25, %24, %12;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]),
        "r"(p[6]), "r"(p[7]), "r"(p[8]), "r"(p[9]), "r"(p[10]), "r"(p[11]),
        "r"(m));
}

// t[0..11] + t[12] 2^384 (< 2p, t[12] = 0) -> t - p if t >= p, else t
__device__ __forceinline__ Fp b_final_sub(const uint32_t* t) {
  Fp d;
  uint32_t keep;
  asm("sub.cc.u32 %0, %13, 0xFFFFAAAB;\n\t"
      "subc.cc.u32 %1, %14, 0xB9FEFFFF;\n\t"
      "subc.cc.u32 %2, %15, 0xB153FFFF;\n\t"
      "subc.cc.u32 %3, %16, 0x1EABFFFE;\n\t"
      "subc.cc.u32 %4, %17, 0xF6B0F624;\n\t"
      "subc.cc.u32 %5, %18, 0x6730D2A0;\n\t"
      "subc.cc.u32 %6, %19, 0xF38512BF;\n\t"
      "subc.cc.u32 %7, %20, 0x64774B84;\n\t"
      "subc.cc.u32 %8, %21, 0x434BACD7;\n\t"
      "subc.cc.u32 %9, %22, 0x4B1BA7B6;\n\t"
      "subc.cc.u32 %10, %23, 0x397FE69A;\n\t"
      "subc.cc.u32 %11, %24, 0x1A0111EA;\n\t"
      "subc.u32 %12, %25, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]),
        "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(d.v[8]), "=r"(d.v[9]),
        "=r"(d.v[10]), "=r"(d.v[11]), "=r"(keep)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]),
        "r"(t[12]));
  // keep = t[12] - borrow: all ones when t < p, else 0
  Fp r;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) r.v[j] = (t[j] & keep) | (d.v[j] & ~keep);
  return r;
}

// a + b mod 2^384, no reduction: a product's pre-summed operand (< 4p)
// and the first half of fp_add
__device__ __forceinline__ Fp fp_add_nr(const Fp& a, const Fp& b) {
  Fp s = a;
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(s.v[0]), "+r"(s.v[1]), "+r"(s.v[2]), "+r"(s.v[3]), "+r"(s.v[4]),
        "+r"(s.v[5]), "+r"(s.v[6]), "+r"(s.v[7]), "+r"(s.v[8]), "+r"(s.v[9]),
        "+r"(s.v[10]), "+r"(s.v[11])
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
        "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]), "r"(b.v[9]),
        "r"(b.v[10]), "r"(b.v[11]));
  return s;
}

// a - b mod 2^384, and mask = all ones when it borrowed
__device__ __forceinline__ Fp b_sub(const Fp& a, const Fp& b,
                                    uint32_t& mask) {
  Fp d = a;
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]), "+r"(d.v[4]),
        "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7]), "+r"(d.v[8]), "+r"(d.v[9]),
        "+r"(d.v[10]), "+r"(d.v[11]), "=r"(mask)
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
        "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]), "r"(b.v[9]),
        "r"(b.v[10]), "r"(b.v[11]));
  return d;
}

// a + b mod p, a, b < p
__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  const Fp s = fp_add_nr(a, b);
  uint32_t t[kWords + 1];
B381_UNROLL
  for (int j = 0; j < kWords; ++j) t[j] = s.v[j];
  t[kWords] = 0;
  return b_final_sub(t);
}

// a - b mod p, a, b < p: a - b, then p added back under the borrow's mask
__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  const uint32_t p[kWords] = B381_WORDS_P;
  uint32_t mask;
  const Fp d = b_sub(a, b, mask);
  Fp pm;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) pm.v[j] = p[j] & mask;
  return fp_add_nr(d, pm);
}

// a * b * R^-1 mod p for a, b < 4p: below (16p / R + 1) p < 2.7p before
// two final subtractions, fully reduced after them
__device__ __forceinline__ Fp fp_mont(const Fp& a, const Fp& b) {
  const uint32_t p[kWords] = B381_WORDS_P;
  uint32_t t[kWords + 1];
B381_UNROLL
  for (int j = 0; j <= kWords; ++j) t[j] = 0;
B381_UNROLL
  for (int i = 0; i < kWords; ++i) {
    b_row(t, a, b.v[i]);
    b_redc_row(t, p, t[0] * kN0Inv);
B381_UNROLL
    for (int j = 0; j < kWords; ++j) t[j] = t[j + 1];
    t[kWords] = 0;
  }
  const Fp r = b_final_sub(t);
B381_UNROLL
  for (int j = 0; j < kWords; ++j) t[j] = r.v[j];
  return b_final_sub(t);
}

#else

// t[0..11] + t12 * 2^384, a value below 2p, reduced below p
B381_HD Fp reduce_once(const uint32_t* t, uint32_t t12) {
  const uint32_t p[kWords] = B381_WORDS_P;
  Fp d;
  uint32_t borrow = 0;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) {
    uint64_t x = (uint64_t)t[j] - p[j] - borrow;
    d.v[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  // t >= p unless the subtraction borrowed out of a value below 2^384
  const uint32_t keep = (t12 == 0 && borrow) ? 0xFFFFFFFFu : 0u;
  Fp r;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) r.v[j] = (t[j] & keep) | (d.v[j] & ~keep);
  return r;
}

B381_HD Fp fp_add_nr(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)a.v[j] + b.v[j];
    s.v[j] = (uint32_t)c;
    c >>= 32;
  }
  return s;
}

B381_HD Fp fp_add(const Fp& a, const Fp& b) {
  uint32_t t[kWords];
  uint64_t c = 0;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)a.v[j] + b.v[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  return reduce_once(t, (uint32_t)c);
}

B381_HD Fp fp_sub(const Fp& a, const Fp& b) {
  const uint32_t p[kWords] = B381_WORDS_P;
  uint32_t d[kWords];
  uint32_t borrow = 0;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) {
    uint64_t x = (uint64_t)a.v[j] - b.v[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  // a < b: add p back (mod 2^384)
  const uint32_t mask = 0u - borrow;
  Fp r;
  uint64_t c = 0;
B381_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)d[j] + (p[j] & mask);
    r.v[j] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// a * b * R^-1 mod p for a, b < 4p, CIOS: one row of a * b[i] and one
// reduction row a word, 144 + 144 wide products, then two final
// subtractions
B381_HD Fp fp_mont(const Fp& a, const Fp& b) {
  const uint32_t p[kWords] = B381_WORDS_P;
  uint32_t t[kWords + 2];
B381_UNROLL
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
B381_UNROLL
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
B381_UNROLL
    for (int j = 0; j < kWords; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    uint64_t s = (uint64_t)t[kWords] + c;
    t[kWords] = (uint32_t)s;
    t[kWords + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kN0Inv;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
B381_UNROLL
    for (int j = 1; j < kWords; ++j) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    s = (uint64_t)t[kWords] + c;
    t[kWords - 1] = (uint32_t)s;
    t[kWords] = t[kWords + 1] + (uint32_t)(s >> 32);
  }
  const Fp r = reduce_once(t, t[kWords]);
  return reduce_once(r.v, 0);
}

#endif  // __CUDA_ARCH__

B381_HD Fp fp_neg(const Fp& a) { return fp_sub(fp_zero(), a); }

// the product and the square (the same code; the host harness counts them
// apart, as the bound does)
B381_HD Fp fp_mul(const Fp& a, const Fp& b) {
  B381_COUNT(mul);
  return fp_mont(a, b);
}

B381_HD Fp fp_sqr(const Fp& a) {
  B381_COUNT(sqr);
  return fp_mont(a, a);
}

// a^(p-2) = a^-1 (0 for 0), left-to-right square-and-multiply over the 380
// bits below the top one
B381_CALL Fp fp_inv(const Fp& a) {
  const uint32_t e[kWords] = B381_WORDS_P_MINUS_2;
  Fp acc = a;
B381_NO_UNROLL
  for (int bit = 379; bit >= 0; --bit) {
    acc = fp_sqr(acc);
    if ((e[bit >> 5] >> (bit & 31)) & 1u) acc = fp_mul(acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

B381_HD Fp2 fp2_zero() { return Fp2{fp_zero(), fp_zero()}; }
B381_HD Fp2 fp2_one() { return Fp2{fp_one(), fp_zero()}; }

B381_HD Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return Fp2{fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
B381_HD Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return Fp2{fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
B381_HD Fp2 fp2_neg(const Fp2& a) { return Fp2{fp_neg(a.c0), fp_neg(a.c1)}; }
B381_HD Fp2 fp2_conj(const Fp2& a) { return Fp2{a.c0, fp_neg(a.c1)}; }
B381_HD Fp2 fp2_dbl(const Fp2& a) { return fp2_add(a, a); }
B381_HD bool fp2_eq(const Fp2& a, const Fp2& b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

// Karatsuba: 3 products
B381_CALL Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
  const Fp t0 = fp_mul(a.c0, b.c0);
  const Fp t1 = fp_mul(a.c1, b.c1);
  const Fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return Fp2{fp_sub(t0, t1), fp_sub(t2, fp_add(t0, t1))};
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 products
B381_CALL Fp2 fp2_sqr(const Fp2& a) {
  const Fp t0 = fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1));
  const Fp t1 = fp_mul(a.c0, a.c1);
  return Fp2{t0, fp_add(t1, t1)};
}

B381_HD Fp2 fp2_mul_fp(const Fp2& a, const Fp& s) {
  return Fp2{fp_mul(a.c0, s), fp_mul(a.c1, s)};
}

// times xi = 1 + u
B381_HD Fp2 fp2_mul_xi(const Fp2& a) {
  return Fp2{fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}

B381_HD Fp2 fp2_inv(const Fp2& a) {
  const Fp d = fp_inv(fp_add(fp_sqr(a.c0), fp_sqr(a.c1)));
  return Fp2{fp_mul(a.c0, d), fp_neg(fp_mul(a.c1, d))};
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

B381_HD Fp6 fp6_add(const Fp6& a, const Fp6& b) {
  return Fp6{fp2_add(a.c0, b.c0), fp2_add(a.c1, b.c1), fp2_add(a.c2, b.c2)};
}
B381_HD Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
  return Fp6{fp2_sub(a.c0, b.c0), fp2_sub(a.c1, b.c1), fp2_sub(a.c2, b.c2)};
}
B381_HD Fp6 fp6_neg(const Fp6& a) {
  return Fp6{fp2_neg(a.c0), fp2_neg(a.c1), fp2_neg(a.c2)};
}

// 6 Fp2 products (the host tower's formula)
B381_CALL Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
  const Fp2 t0 = fp2_mul(a.c0, b.c0);
  const Fp2 t1 = fp2_mul(a.c1, b.c1);
  const Fp2 t2 = fp2_mul(a.c2, b.c2);
  Fp2 s = fp2_mul(fp2_add(a.c1, a.c2), fp2_add(b.c1, b.c2));
  const Fp2 c0 = fp2_add(t0, fp2_mul_xi(fp2_sub(fp2_sub(s, t1), t2)));
  s = fp2_mul(fp2_add(a.c0, a.c1), fp2_add(b.c0, b.c1));
  const Fp2 c1 = fp2_add(fp2_sub(fp2_sub(s, t0), t1), fp2_mul_xi(t2));
  s = fp2_mul(fp2_add(a.c0, a.c2), fp2_add(b.c0, b.c2));
  const Fp2 c2 = fp2_add(fp2_sub(fp2_sub(s, t0), t2), t1);
  return Fp6{c0, c1, c2};
}

// v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
B381_HD Fp6 fp6_mul_v(const Fp6& a) {
  return Fp6{fp2_mul_xi(a.c2), a.c0, a.c1};
}

// a * (b0 + b1 v): 5 Fp2 products
B381_CALL Fp6 fp6_mul_by_01(const Fp6& a, const Fp2& b0, const Fp2& b1) {
  const Fp2 t0 = fp2_mul(a.c0, b0);
  const Fp2 t1 = fp2_mul(a.c1, b1);
  const Fp2 c0 = fp2_add(t0, fp2_mul_xi(fp2_mul(a.c2, b1)));
  const Fp2 c1 = fp2_sub(
      fp2_sub(fp2_mul(fp2_add(a.c0, a.c1), fp2_add(b0, b1)), t0), t1);
  const Fp2 c2 = fp2_add(t1, fp2_mul(a.c2, b0));
  return Fp6{c0, c1, c2};
}

// a * (b1 v): 3 Fp2 products
B381_HD Fp6 fp6_mul_by_1(const Fp6& a, const Fp2& b1) {
  return Fp6{fp2_mul_xi(fp2_mul(a.c2, b1)), fp2_mul(a.c0, b1),
             fp2_mul(a.c1, b1)};
}

B381_HD Fp6 fp6_inv(const Fp6& a) {
  const Fp2 c0 = fp2_sub(fp2_sqr(a.c0), fp2_mul_xi(fp2_mul(a.c1, a.c2)));
  const Fp2 c1 = fp2_sub(fp2_mul_xi(fp2_sqr(a.c2)), fp2_mul(a.c0, a.c1));
  const Fp2 c2 = fp2_sub(fp2_sqr(a.c1), fp2_mul(a.c0, a.c2));
  const Fp2 t = fp2_add(
      fp2_mul_xi(fp2_add(fp2_mul(a.c2, c1), fp2_mul(a.c1, c2))),
      fp2_mul(a.c0, c0));
  const Fp2 ti = fp2_inv(t);
  return Fp6{fp2_mul(c0, ti), fp2_mul(c1, ti), fp2_mul(c2, ti)};
}

// ---------------------------------------------------------------------------
// Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

B381_HD Fp12 fp12_one() {
  return Fp12{Fp6{fp2_one(), fp2_zero(), fp2_zero()},
              Fp6{fp2_zero(), fp2_zero(), fp2_zero()}};
}

// (a0 + a1 w)(b0 + b1 w) = a0 b0 + v a1 b1 + ((a0+a1)(b0+b1) - a0 b0 -
// a1 b1) w: 3 Fp6 products
B381_CALL Fp12 fp12_mul(const Fp12& a, const Fp12& b) {
  const Fp6 t0 = fp6_mul(a.c0, b.c0);
  const Fp6 t1 = fp6_mul(a.c1, b.c1);
  const Fp6 t2 = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(b.c0, b.c1));
  return Fp12{fp6_add(t0, fp6_mul_v(t1)), fp6_sub(fp6_sub(t2, t0), t1)};
}

// (a0 + a1 w)^2 = (a0 + a1)(a0 + v a1) - t - v t + 2 t w, t = a0 a1: 2 Fp6
// products
B381_CALL Fp12 fp12_sqr(const Fp12& a) {
  const Fp6 t = fp6_mul(a.c0, a.c1);
  const Fp6 s = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(a.c0, fp6_mul_v(a.c1)));
  return Fp12{fp6_sub(fp6_sub(s, t), fp6_mul_v(t)), fp6_add(t, t)};
}

// (a + b y)^2 = a^2 + xi b^2 + 2 a b y in Fp4 = Fp2[y]/(y^2 - xi), with
// a^2 + xi b^2 = (a + b)(a + xi b) - a b - xi a b: 2 Fp2 products
B381_HD void fp4_sqr(const Fp2& a, const Fp2& b, Fp2& t0, Fp2& t1) {
  const Fp2 ab = fp2_mul(a, b);
  t0 = fp2_sub(fp2_mul(fp2_add(a, b), fp2_add(a, fp2_mul_xi(b))),
               fp2_add(ab, fp2_mul_xi(ab)));
  t1 = fp2_dbl(ab);
}

// 3 t - 2 z and 3 t + 2 z
B381_HD Fp2 gs_minus(const Fp2& t, const Fp2& z) {
  return fp2_add(fp2_dbl(fp2_sub(t, z)), t);
}
B381_HD Fp2 gs_plus(const Fp2& t, const Fp2& z) {
  return fp2_add(fp2_dbl(fp2_add(t, z)), t);
}

// the square of an element of the cyclotomic subgroup (norm 1 down to
// Fp6 and Fp4), Granger and Scott, "Faster squaring in the cyclotomic
// subgroup of sixth degree extensions": three Fp4 squares over the pairs
// (c0.c0, c1.c1), (c1.c0, c0.c2), (c0.c1, c1.c2), 6 Fp2 products against
// fp12_sqr's 12.  Wrong for any other element.
B381_CALL Fp12 fp12_cyclo_sqr(const Fp12& a) {
  Fp2 t0, t1, t2, t3, t4, t5;
  fp4_sqr(a.c0.c0, a.c1.c1, t0, t1);
  fp4_sqr(a.c1.c0, a.c0.c2, t2, t3);
  fp4_sqr(a.c0.c1, a.c1.c2, t4, t5);
  return Fp12{Fp6{gs_minus(t0, a.c0.c0), gs_minus(t2, a.c0.c1),
                  gs_minus(t4, a.c0.c2)},
              Fp6{gs_plus(fp2_mul_xi(t5), a.c1.c0), gs_plus(t1, a.c1.c1),
                  gs_plus(t3, a.c1.c2)}};
}

// a0 - a1 w: the p^6 Frobenius, the inverse on the cyclotomic subgroup
B381_HD Fp12 fp12_conj(const Fp12& a) { return Fp12{a.c0, fp6_neg(a.c1)}; }

B381_CALL Fp12 fp12_inv(const Fp12& a) {
  const Fp6 t = fp6_inv(
      fp6_sub(fp6_mul(a.c0, a.c0), fp6_mul_v(fp6_mul(a.c1, a.c1))));
  return Fp12{fp6_mul(a.c0, t), fp6_neg(fp6_mul(a.c1, t))};
}

// the p-power Frobenius; g holds the gammas of a1, a2, b0, b1, b2 (xi^(k
// (p-1)/6) for k = 2, 4, 1, 3, 5) in Montgomery form
B381_CALL Fp12 fp12_frob(const Fp12& a, const Fp2* g) {
  return Fp12{
      Fp6{fp2_conj(a.c0.c0), fp2_mul(fp2_conj(a.c0.c1), g[0]),
          fp2_mul(fp2_conj(a.c0.c2), g[1])},
      Fp6{fp2_mul(fp2_conj(a.c1.c0), g[2]), fp2_mul(fp2_conj(a.c1.c1), g[3]),
          fp2_mul(fp2_conj(a.c1.c2), g[4])}};
}

B381_HD bool fp12_is_one(const Fp12& a) {
  const Fp2 z = fp2_zero();
  return fp2_eq(a.c0.c0, fp2_one()) && fp2_eq(a.c0.c1, z) &&
         fp2_eq(a.c0.c2, z) && fp2_eq(a.c1.c0, z) && fp2_eq(a.c1.c1, z) &&
         fp2_eq(a.c1.c2, z);
}

}  // namespace b381
