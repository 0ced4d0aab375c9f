// Generic Ed25519 verify scheduled over a group of G threads per
// signature, shared by the CUDA kernel (cuda_eddsa.cu, G = 2 or 4) and the
// g++ host harness (host_harness.cc, G = 1, 2 or 4).
//
// Field: p = 2^255 - 19 in plain (not Montgomery) form, 8 little-endian
// 32-bit words, any value below 2^256 standing for itself mod p ("partly
// reduced").  e_mul / e_sqr are an 8 x 8 word schoolbook product into 16
// words (p256::p_mul_wide / p_sqr_wide) and a fold of words 8..15 times 38
// (2^256 = 38 mod p) into the low half, then two small folds of the carry;
// e_add / e_sub fold their carry or borrow the same way.  On the card the
// folds are PTX carry chains; the portable C++ beside them is what g++
// builds for the host harness.  Values are made canonical (< p) by
// e_canon before any comparison.
//
// The verify is a flat program of kStages stages.  Each stage is a
// function of (stage id, rank, the signature's shared block, its inputs);
// the kernel runs every stage on all G ranks of a group and then
// __syncwarp(group mask).  Within a stage no rank reads what another rank
// of the same stage writes, so running ranks 0..G-1 of a stage one after
// another, then the next stage, is a faithful serialisation: that is what
// the host harness does.  Rank r computes products r, r + G, ... of a
// stage, all on the same code path (the operands differ, the instructions
// do not), so no stage makes the warp diverge.
//
//   stages 0..3   the curve checks of R and A, -2A = 2(-A) and
//                 -3A = -2A + (-A), as product stages of 6, 7, 6 and 4
//                 products; rank 0 sets the verdict flag (ok, S < L, both
//                 points on the curve) in stage 3
//   stage 4       the joint table {iB + j(-A)} in cached form: 12 jobs of
//                 one addition and one product each (j(-A) for i = 0, the
//                 nine iB + j(-A) with i, j >= 1), r, r + G, ... on rank r;
//                 the iB column is constant
//   stages 5..    127 digits x (2 doublings + 1 addition), each point
//                 operation 2 stages of 4 independent products:
//                   doubling  {X^2, Y^2, Z^2, (X + Y)^2} -> {EF, GH, FG, EH}
//                   addition  {(Y-X) c0, (Y+X) c1, T c2, Z c3} -> the same
//                 with c = (Y2 - X2, Y2 + X2, 2d T2, 2 Z2) the table entry
//   last stage    rank 0 compares the accumulator with R projectively.
//
// The formulas are those of ed25519_field.cuh (add-2008-hwcd-3 and
// dbl-2008-hwcd, a = -1); products mod p are exact, so T1 (2d T2) is the
// same field element as (T1 2d) T2 and the accumulator holds the same
// points as eddsa_verify_lane's.  Between the two stages of an operation
// every rank forms E, F, G and H (4 or 5 additions): that is the union of
// what the four products read, and a rank-specific subset would make the
// warp run each rank's subset in turn.
#pragma once

#include "ed25519_field.cuh"
#include "p256_field.cuh"

namespace edg {

using f256::Fe;
using f256::fe_const;
using f256::fe_zero;
using f256::load_fe;
using f256::select;

// ---------------------------------------------------------------------------
// the field: folds by 38
// ---------------------------------------------------------------------------

#ifdef __CUDA_ARCH__

// t[0..15] (a 512-bit product) -> t[0..7] + 38 t[8..15] mod p, < 2^256:
// the high half times 38 into the low half (two carry chains, as p_row),
// then the carry word times 38 into word 0, twice
__device__ __forceinline__ Fe e_fold(const uint32_t* t) {
  Fe r;
  const uint32_t k = 38u;
  asm("{\n\t.reg .u32 c;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %8;\n\t"
      "madc.lo.cc.u32 %1, %17, %24, %9;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %10;\n\t"
      "madc.lo.cc.u32 %3, %19, %24, %11;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %12;\n\t"
      "madc.lo.cc.u32 %5, %21, %24, %13;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %14;\n\t"
      "madc.lo.cc.u32 %7, %23, %24, %15;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.hi.cc.u32 %2, %17, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.hi.cc.u32 %4, %19, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.hi.cc.u32 %6, %21, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "madc.hi.u32 c, %23, %24, c;\n\t"
      "mad.lo.cc.u32 %0, c, %24, %0;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.cc.u32 %0, c, %24, %0;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "}"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]),
        "r"(t[12]), "r"(t[13]), "r"(t[14]), "r"(t[15]), "r"(k));
  return r;
}

// a + b mod p, a, b < 2^256: the carry out of 2^256 comes back as 38, twice
__device__ __forceinline__ Fe e_add(const Fe& a, const Fe& b) {
  Fe r;
  asm("{\n\t.reg .u32 m;\n\t"
      "add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.cc.u32 %7, %15, %23;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "sub.u32 m, 0, m;\n\t"
      "and.b32 m, m, 38;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "sub.u32 m, 0, m;\n\t"
      "and.b32 m, m, 38;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "}"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return r;
}

// a - b mod p, a, b < 2^256: a borrow out of 2^256 takes 38 off, twice
__device__ __forceinline__ Fe e_sub(const Fe& a, const Fe& b) {
  Fe r;
  asm("{\n\t.reg .u32 m;\n\t"
      "sub.cc.u32 %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.cc.u32 %7, %15, %23;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "and.b32 m, m, 38;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "and.b32 m, m, 38;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.u32 %7, %7, 0;\n\t"
      "}"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return r;
}

#else  // portable C++: the same folds with 64-bit partial sums

F256_HD void fold_carry(Fe& r, uint64_t c) {
  for (int round = 0; round < 2; ++round) {
    c *= 38u;
    for (int j = 0; j < 8; ++j) {
      c += r.v[j];
      r.v[j] = (uint32_t)c;
      c >>= 32;
    }
  }
}

F256_HD Fe e_fold(const uint32_t* t) {
  Fe r;
  uint64_t c = 0;
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)t[8 + j] * 38u + t[j];
    r.v[j] = (uint32_t)c;
    c >>= 32;
  }
  fold_carry(r, c);
  return r;
}

F256_HD Fe e_add(const Fe& a, const Fe& b) {
  Fe r;
  fold_carry(r, f256::add_words(r, a, b));
  return r;
}

F256_HD Fe e_sub(const Fe& a, const Fe& b) {
  Fe r;
  uint32_t borrow = f256::sub_words(r, a, b.v);
  for (int round = 0; round < 2; ++round) {
    const uint32_t m[8] = {borrow ? 38u : 0u, 0, 0, 0, 0, 0, 0, 0};
    borrow = f256::sub_words(r, r, m);
  }
  return r;
}

#endif  // __CUDA_ARCH__

// a * b mod p, any a, b < 2^256; the result is below 2^256
F256_HD Fe e_mul(const Fe& a, const Fe& b) {
  uint32_t t[17];
  p256::p_mul_wide(t, a, b);
  return e_fold(t);
}

// a * a mod p: 36 word products (28 cross, doubled, + 8 squares)
F256_HD Fe e_sqr(const Fe& a) {
  uint32_t t[17];
  p256::p_sqr_wide(t, a);
  return e_fold(t);
}

// the canonical representative (< p) of a < 2^256: bit 255 folds back as
// 19, leaving a value below p + 38, then p is taken off once if it fits
F256_HD Fe e_canon(const Fe& a) {
  const uint32_t pw[8] = ED_WORDS_P;
  Fe b = a;
  b.v[7] &= 0x7FFFFFFFu;
  uint64_t c = (uint64_t)(a.v[7] >> 31) * 19u;
F256_UNROLL
  for (int j = 0; j < 8; ++j) {
    c += b.v[j];
    b.v[j] = (uint32_t)c;
    c >>= 32;
  }
  Fe d;
  uint32_t borrow = f256::sub_words(d, b, pw);
  return select(borrow, b, d);
}

F256_HD uint32_t e_eq(const Fe& a, const Fe& b) {
  return f256::eq(e_canon(a), e_canon(b));
}

// ---------------------------------------------------------------------------
// constants, plain form
// ---------------------------------------------------------------------------

F256_HD Fe e_small(uint32_t v) { return fe_const(v, 0, 0, 0, 0, 0, 0, 0); }

F256_HD Fe d_plain() {
  return fe_const(0x135978A3u, 0x75EB4DCAu, 0x4141D8ABu, 0x00700A4Du,
                  0x7779E898u, 0x8CC74079u, 0x2B6FFE73u, 0x52036CEEu);
}

F256_HD Fe d2_plain() {
  return fe_const(0x26B2F159u, 0xEBD69B94u, 0x8283B156u, 0x00E0149Au,
                  0xEEF3D130u, 0x198E80F2u, 0x56DFFCE7u, 0x2406D9DCu);
}

// coordinate c of iB in cached form (Y - X, Y + X, 2d T, 2 Z), i = 0..3
// (i = 0: the identity, (1, 1, 0, 2))
F256_HD Fe base_cached(int i, int c) {
  if (c == 3) return e_small(2);
  switch (4 * i + c) {
    case 4:
      return fe_const(0xD740913Eu, 0x9D103905u, 0xD140BEB3u, 0xFD399F05u,
                      0x688F8A09u, 0xA5C18434u, 0x98F81267u, 0x44FD2F92u);
    case 5:
      return fe_const(0xF58C3B85u, 0x2FBC93C6u, 0xFB8C0E19u, 0xCF932DC6u,
                      0x643D42C2u, 0x270B4898u, 0x33D4BA65u, 0x07CF9D3Au);
    case 6:
      return fe_const(0x877AAA68u, 0xABC91205u, 0xCCAAC49Eu, 0x26D9E823u,
                      0xDD43598Cu, 0x5A1B7DCBu, 0x9F0C65A8u, 0x6F117B68u);
    case 8:
      return fe_const(0x42B4D5A8u, 0x8A99A560u, 0x4E60ACF6u, 0x8F2B810Cu,
                      0xB16E37AAu, 0xE09E236Bu, 0x69C92555u, 0x6BB595A6u);
    case 9:
      return fe_const(0x933C71D7u, 0x9224E7FCu, 0x7A0FF5B5u, 0x9F469D96u,
                      0xE1D60702u, 0x5AA69A65u, 0xA87D2E2Eu, 0x590C063Fu);
    case 10:
      return fe_const(0xA59B7A5Fu, 0x43FAA8B3u, 0x5D9ACF78u, 0x36C16BDDu,
                      0x0B3D6A31u, 0x500FA084u, 0x3EA50B73u, 0x701AF5B1u);
    case 12:
      return fe_const(0xA4FCD265u, 0x56611FE8u, 0xE5C1BA7Du, 0x3BD353FDu,
                      0x214BD6BDu, 0x8131F31Au, 0x555BDA62u, 0x2AB91587u);
    case 13:
      return fe_const(0x4CEE9730u, 0xAF25B0A8u, 0xE8864B8Au, 0x025A8430u,
                      0x9F016732u, 0xC11B5002u, 0x9A80F8F4u, 0x7A164E1Bu);
    case 14:
      return fe_const(0x0DD0D889u, 0x14AE933Fu, 0x1C35DA62u, 0x58942322u,
                      0x8CF2DB4Cu, 0xD170E545u, 0x12B9B4C6u, 0x5A2826AFu);
    case 2:
      return fe_zero();
    default:  // Y - X and Y + X of the identity
      return e_small(1);
  }
}

// ---------------------------------------------------------------------------
// the products of a point operation (a point: X, Y, Z, T)
// ---------------------------------------------------------------------------

F256_HD Fe pick4(int k, const Fe& a, const Fe& b, const Fe& c, const Fe& d) {
  return select(k == 0, a, select(k == 1, b, select(k == 2, c, d)));
}

// doubling, first stage: product k of {X^2, Y^2, Z^2, (X + Y)^2}
F256_HD Fe dbl_prod(int k, const Fe* p) {
  const Fe sum = e_add(p[0], p[1]);
  return e_sqr(select(k == 3, sum, p[k == 3 ? 0 : k]));
}

// addition, first stage: product k of {(Y - X) c0, (Y + X) c1, T c2, Z c3}
// with ck = coordinate k of the cached addend
F256_HD Fe add_prod(int k, const Fe* p, const Fe& ck) {
  const Fe ymx = e_sub(p[1], p[0]), ypx = e_add(p[1], p[0]);
  return e_mul(pick4(k, ymx, ypx, p[3], p[2]), ck);
}

// E, F, G, H of a doubling from q = {X^2, Y^2, Z^2, (X + Y)^2}
F256_HD void dbl_efgh(const Fe* q, Fe* o) {
  o[3] = e_add(q[0], q[1]);              // H = a + b
  o[2] = e_sub(q[1], q[0]);              // G = b - a
  o[0] = e_sub(q[3], o[3]);              // E = s - a - b
  o[1] = e_sub(e_add(q[2], q[2]), o[2]); // F = 2 zz - G
}

// E, F, G, H of an addition from q = {A, B, C, D}
F256_HD void add_efgh(const Fe* q, Fe* o) {
  o[0] = e_sub(q[1], q[0]);  // E = B - A
  o[1] = e_sub(q[3], q[2]);  // F = D - C
  o[2] = e_add(q[3], q[2]);  // G = D + C
  o[3] = e_add(q[1], q[0]);  // H = B + A
}

// second stage: product k of {EF, GH, FG, EH} = (X3, Y3, Z3, T3)
F256_HD Fe finish_prod(int k, const Fe* o) {
  return e_mul(select(k == 0 || k == 3, o[0], select(k == 1, o[2], o[1])),
               select(k == 0, o[1], select(k == 2, o[2], o[3])));
}

// one thread's addition p + c (c cached) into cached form, 9 products:
// the table entries of stage 4
F256_HD void add_to_cached(Fe* dst, const Fe* p, const Fe* c) {
  Fe q[4], o[4], r[4];
F256_UNROLL
  for (int k = 0; k < 4; ++k) q[k] = add_prod(k, p, c[k]);
  add_efgh(q, o);
F256_UNROLL
  for (int k = 0; k < 4; ++k) r[k] = finish_prod(k, o);
  dst[0] = e_sub(r[1], r[0]);
  dst[1] = e_add(r[1], r[0]);
  dst[2] = e_mul(r[3], d2_plain());
  dst[3] = e_add(r[2], r[2]);
}

// ---------------------------------------------------------------------------
// the program
// ---------------------------------------------------------------------------

// signatures a block (the kernel) or a batch of the serialisation (the
// host harness) holds: G x 16 threads, 16 shared blocks of 2,884 bytes
constexpr int kSigsPerBlock = 16;
constexpr int kDigits = 127;
constexpr int kPrologue = 5;
constexpr int kStages = kPrologue + 6 * kDigits + 1;

// one signature's shared block: 721 words, an odd stride, so the
// signatures of a warp that read the same word of their own blocks hit
// distinct banks
struct Shared {
  Fe tab[16][4];  // entry 4 i + j = iB + j(-A), cached (Y-X, Y+X, 2d T, 2Z)
  // prologue products; in the scan w[0..3] are the stage products and
  // w[4..7] the accumulator (X, Y, Z, T).  The prologue's:
  //   w0..w4 rx^2, ry^2, ax^2, ay^2, (ay - ax)^2   w15 ax ay
  //   w5, w6 rx^2 ry^2, ax^2 ay^2   w7 -2d ax ay    w16..19 -2A
  //   w8, w9 d rx^2 ry^2, d ax^2 ay^2   w10..13 the products of -2A + (-A)
  //   w20..23 -3A
  Fe w[24];
  Fe s, h;        // the scalars, read digit by digit
  uint32_t flag;  // ok, S < L, R and A on the curve
};

// one signature's inputs, 8 words each, and the host's ok
struct In {
  const uint32_t *s, *h, *rx, *ry, *ax, *ay;
  int32_t ok;
};

F256_HD int entry_of(const Shared& sh, int k) {
  return (int)(4u * ed25519::two_bit_digit(sh.s, k) +
               ed25519::two_bit_digit(sh.h, k));
}

// stage `id` on rank r of a group of G.  Returns the verdict at the last
// stage on rank 0, else 0.
template <int G>
F256_HD uint32_t stage(int id, int r, Shared& sh, const In& in) {
  Fe* w = sh.w;
  if (id >= kPrologue && id < kStages - 1) {
    const int t = id - kPrologue, u = t % 6;
    Fe* q = w;
    Fe* acc = w + 4;
    Fe o[4];
    if (u == 0 || u == 2) {  // doubling, first stage
      for (int k = r; k < 4; k += G) q[k] = dbl_prod(k, acc);
    } else if (u == 4) {  // addition of the digit's table entry
      const Fe* c = sh.tab[entry_of(sh, t / 6)];
      for (int k = r; k < 4; k += G) q[k] = add_prod(k, acc, c[k]);
    } else {  // second stage of a doubling (u = 1, 3) or the addition
      if (u == 5)
        add_efgh(q, o);
      else
        dbl_efgh(q, o);
      for (int k = r; k < 4; k += G) acc[k] = finish_prod(k, o);
    }
    return 0u;
  }
  const Fe ax = load_fe(in.ax), ay = load_fe(in.ay);
  switch (id) {
    case 0: {
      const Fe rx = load_fe(in.rx), ry = load_fe(in.ry);
      const Fe amx = e_sub(ay, ax);
      for (int m = r; m < 6; m += G) {
        const Fe a = m < 4 ? pick4(m, rx, ry, ax, ay) : select(m == 4, amx, ax);
        const Fe b = m < 4 ? a : select(m == 4, amx, ay);
        w[m < 5 ? m : 15] = e_mul(a, b);
      }
      if (r == 0) {
        sh.s = load_fe(in.s);
        sh.h = load_fe(in.h);
      }
      return 0u;
    }
    case 1: {  // x^2 y^2 of R and A, 2d T of -A, and -2A = 2(-A)
      const Fe q[4] = {w[2], w[3], e_small(1), w[4]};
      Fe o[4];
      dbl_efgh(q, o);
      for (int m = r; m < 7; m += G) {
        if (m < 3) {
          const Fe a = pick4(m, w[0], w[2], e_sub(fe_zero(), w[15]), w[0]);
          const Fe b = pick4(m, w[1], w[3], d2_plain(), w[1]);
          w[5 + m] = e_mul(a, b);
        } else {
          w[13 + m] = finish_prod(m - 3, o);
        }
      }
      return 0u;
    }
    case 2: {  // d x^2 y^2 of R and A; the products of -2A + (-A)
      const Fe* na2 = w + 16;
      for (int m = r; m < 6; m += G) {
        if (m < 2) {
          w[8 + m] = e_mul(w[5 + m], d_plain());
        } else {
          const int k = m - 2;  // -A cached: (ay + ax, ay - ax, 2d T, 2)
          const Fe ck = pick4(k, e_add(ay, ax), e_sub(ay, ax), w[7],
                              e_small(2));
          w[8 + m] = add_prod(k, na2, ck);
        }
      }
      return 0u;
    }
    case 3: {  // -3A; the flag: ok, S < L, -x^2 + y^2 = 1 + d x^2 y^2
      Fe o[4];
      add_efgh(w + 10, o);
      for (int m = r; m < 4; m += G) w[20 + m] = finish_prod(m, o);
      if (r == 0) {
        const uint32_t lw[8] = ED_WORDS_L;
        const Fe one = e_small(1);
        sh.flag = (uint32_t)(in.ok != 0) & f256::lt(sh.s, lw) &
                  e_eq(e_sub(w[1], w[0]), e_add(one, w[8])) &
                  e_eq(e_sub(w[3], w[2]), e_add(one, w[9]));
      }
      return 0u;
    }
    case 4: {  // the table: job m < 3 is j(-A) (i = 0), then iB + j(-A)
      const Fe na1[4] = {e_sub(fe_zero(), ax), ay, e_small(1),
                         e_sub(fe_zero(), w[15])};
      for (int m = r; m < 12; m += G) {
        const int i = m < 3 ? 0 : (m - 3) / 3 + 1;
        const int j = m < 3 ? m + 1 : (m - 3) % 3 + 1;
        Fe p[4], c[4];
F256_UNROLL
        for (int k = 0; k < 4; ++k) {
          p[k] = select(j == 1, na1[k], select(j == 2, w[16 + k], w[20 + k]));
          c[k] = base_cached(i, k);
        }
        add_to_cached(sh.tab[4 * i + j], p, c);
      }
      if (r == 0) {
F256_UNROLL
        for (int k = 0; k < 4; ++k) {
          for (int i = 0; i < 4; ++i) sh.tab[4 * i][k] = base_cached(i, k);
          w[4 + k] = e_small(k == 1 || k == 2);  // the identity (0 : 1 : 1 : 0)
        }
      }
      return 0u;
    }
    default: {  // [S]B + [h](-A) == R: X = rx Z, Y = ry Z, Z != 0
      if (r != 0) return 0u;
      const Fe* acc = w + 4;
      const uint32_t match =
          e_eq(e_mul(load_fe(in.rx), acc[2]), acc[0]) &
          e_eq(e_mul(load_fe(in.ry), acc[2]), acc[1]);
      return match & (f256::is_zero(e_canon(acc[2])) ^ 1u) & sh.flag;
    }
  }
}

}  // namespace edg
