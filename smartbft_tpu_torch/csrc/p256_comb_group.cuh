// Static-key comb P-256 ECDSA verify scheduled over a group of G threads
// per signature, shared by the CUDA kernel (cuda_comb.cu, G = 4 or 8) and
// the g++ host harness (host_harness.cc, G = 1, 4 or 8).
//
// The verify has two parts.
//
//   prologue   one thread per signature, before the first stage: the
//              range checks, u1 = e/s and u2 = r/s mod n, and the 32 comb
//              digit pairs read out of u1 and u2 once.  The kernel runs it
//              on threads 0 .. kSigsPerBlock-1 of a block (all 32 lanes of
//              warp 0), then __syncthreads().  Its chain is the Fermat
//              inversion (~330 products mod n, each waiting on the one
//              before), so the products mod n here are n_mul / n_sqr: the
//              wide products of p256_field.cuh on PTX carry chains and a
//              CIOS reduction round of q = t0 * n' and a row of n, since n
//              has no special form.
//   stages     kStages - 1 = 32 digits x (1 doubling + 2 additions), each
//              point operation 3 stages of independent products mod p over
//              the ranks (p256_group.cuh's dbl1..3 / add1..3, the slots
//              double-buffered as there), then the compare on rank 0.
//              Digit k's two table entries, gtab[d1] and qtab[kidx][d2]
//              (96 bytes each, resident in L2), are loaded in the digit's
//              dbl2 stage, each rank its own words, and stored into the
//              signature's shared block after the stage's product, so the
//              L2 latency is off the chain; the additions read them from
//              there.
//
// The stage rule of p256_group.cuh holds: within a stage no rank reads what
// another rank of the same stage writes, so running the ranks of a stage
// one after another, then the next stage, is a faithful serialisation
// (what the host harness does).  Every value is fully reduced and the
// formulas are pt_dbl / pt_add's, so the accumulator holds the same field
// elements as comb_verify_lane's; u1 and u2 equal verify_scalars'.
#pragma once

#include "p256_group.cuh"

namespace p256c {

using p256::Fe;
using p256::Pt;

constexpr int kDigits = 32;                 // comb columns (the stride)
constexpr int kEntryWords = 24;             // X, Y, Z of one table entry
constexpr int kKeyWords = 256 * kEntryWords;  // one key's table
// signatures a block (the kernel) or a batch of the serialisation (the host
// harness): one warp's lanes for the prologue
constexpr int kSigsPerBlock = 32;
constexpr int kStages = 9 * kDigits + 1;
constexpr uint32_t kN0Inv = 0xEE00BC4Fu;    // -n^-1 mod 2^32

// one signature's shared block: 179 words, an odd stride, so the
// signatures of a warp that touch the same word of their own blocks hit
// distinct banks
struct Shared {
  Fe s[p256g::kSlots];      // stage products
  Fe ent[2][3];             // digit k's entries: gtab[d1], qtab[key][d2]
  uint8_t dig[kDigits][2];  // comb digit pairs (u1, u2), MSB column first
  int32_t key;              // qtab index, or -1 outside the stack
  uint32_t ok;              // 1 <= r, s < n and the key in the stack
  uint32_t pad;
};

// the tables and this signature's r, 8 words
struct In {
  const uint32_t *gtab, *qtab, *r;
};

// ---------------------------------------------------------------------------
// products mod n: the 512-bit product of p256_field.cuh, then 8 CIOS rounds
// ---------------------------------------------------------------------------
//
// Round i adds q n (q = t[i] n' mod 2^32) to t[i .. i+8], which clears word
// i; the carry out of word i + 8 is kept aside and added once at the end,
// as p_redc's are, since words from 9 up are never read as a later q.  Same
// contract as mont_mul(a, b, mod_n()): a < 2^256, b < n (n_sqr: a < n),
// result fully reduced (< n), R = 2^256.

#ifdef __CUDA_ARCH__

// t[0..8] += q * n with q = t[0] * n' (t[0] becomes 0); returns the carry
// out of t[8]
__device__ __forceinline__ uint32_t n_redc_round(uint32_t* t) {
  const uint32_t nw[8] = P256_WORDS_N;
  const uint32_t q = t[0] * kN0Inv;
  uint32_t c;
  asm("{\n\t.reg .u32 cy;\n\t"
      "mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 cy, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32 %9, cy, 0;\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "=r"(c)
      : "r"(nw[0]), "r"(nw[1]), "r"(nw[2]), "r"(nw[3]), "r"(nw[4]),
        "r"(nw[5]), "r"(nw[6]), "r"(nw[7]), "r"(q));
  return c;
}

// t[8..16] (< 2n) -> t - n if t >= n, else t
__device__ __forceinline__ Fe n_final_sub(const uint32_t* t) {
  Fe d;
  uint32_t keep;
  asm("sub.cc.u32 %0, %9, 0xFC632551;\n\t"
      "subc.cc.u32 %1, %10, 0xF3B9CAC2;\n\t"
      "subc.cc.u32 %2, %11, 0xA7179E84;\n\t"
      "subc.cc.u32 %3, %12, 0xBCE6FAAD;\n\t"
      "subc.cc.u32 %4, %13, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %5, %14, 0xFFFFFFFF;\n\t"
      "subc.cc.u32 %6, %15, 0;\n\t"
      "subc.cc.u32 %7, %16, 0xFFFFFFFF;\n\t"
      "subc.u32 %8, %17, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(keep)
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]), "r"(t[16]));
  // keep = t[16] - borrow: all ones when t < n, else 0
  Fe out;
P256_UNROLL
  for (int j = 0; j < 8; ++j)
    out.v[j] = (t[8 + j] & keep) | (d.v[j] & ~keep);
  return out;
}

#else  // portable C++: the same steps with 64-bit partial sums

P256_HD uint32_t n_redc_round(uint32_t* t) {
  const uint32_t nw[8] = P256_WORDS_N;
  const uint32_t q = t[0] * kN0Inv;
  uint64_t c = 0;
  for (int j = 0; j < 8; ++j) {
    uint64_t uv = (uint64_t)q * nw[j] + t[j] + c;
    t[j] = (uint32_t)uv;
    c = uv >> 32;
  }
  uint64_t s = (uint64_t)t[8] + c;
  t[8] = (uint32_t)s;
  return (uint32_t)(s >> 32);
}

P256_HD Fe n_final_sub(const uint32_t* t) {
  const uint32_t nw[8] = P256_WORDS_N;
  Fe lo = p256::load_fe(t + 8), d;
  uint32_t borrow = p256::sub_words(d, lo, nw);
  return p256::select(t[16] | (borrow ^ 1u), d, lo);
}

#endif  // __CUDA_ARCH__

// t (17 words, a product below n * 2^256, t[16] = 0) -> t * 2^-256 mod n
P256_HD Fe n_redc(uint32_t* t) {
  uint32_t c[8];
P256_UNROLL
  for (int i = 0; i < 8; ++i) c[i] = n_redc_round(t + i);
  p256::p_add_carries(t, c);
  return n_final_sub(t);
}

// a * b * 2^-256 mod n: 64 word products, then 8 rounds of 8
P256_HD Fe n_mul(const Fe& a, const Fe& b) {
  uint32_t t[17];
  p256::p_mul_wide(t, a, b);
  return n_redc(t);
}

// a * a * 2^-256 mod n: 36 word products (28 cross, doubled, + 8 squares)
P256_HD Fe n_sqr(const Fe& a) {
  uint32_t t[17];
  p256::p_sqr_wide(t, a);
  return n_redc(t);
}

// 1/s mod n, Montgomery in and out: inv_mod_n's Fermat ladder (s^(n-2),
// the same 4-bit window and digits) on n_mul / n_sqr
P256_HD Fe n_inv(const Fe& s) {
  Fe pows[16];
  pows[0] = p256::n_one();
  pows[1] = s;
P256_NO_UNROLL
  for (int k = 2; k < 16; ++k) pows[k] = n_mul(pows[k - 1], s);
  Fe acc = pows[(p256::inv_exp_word(7) >> 28) & 15u];
P256_NO_UNROLL
  for (int i = 1; i < 64; ++i) {
    int bit = 4 * (63 - i);
    uint32_t d = (p256::inv_exp_word(bit >> 5) >> (bit & 31)) & 15u;
P256_UNROLL
    for (int k = 0; k < 4; ++k) acc = n_sqr(acc);
    acc = n_mul(acc, pows[d]);
  }
  return acc;
}

// verify_scalars on n_mul: the same u1, u2 and range checks
P256_HD p256::Scalars scalars(const Fe& e, const Fe& r, const Fe& s) {
  const uint32_t nw[8] = P256_WORDS_N;
  p256::Scalars out;
  out.ok = (p256::is_zero(r) ^ 1u) & p256::lt(r, nw) &
           (p256::is_zero(s) ^ 1u) & p256::lt(s, nw);
  Fe d;
  uint32_t e_lt_n = p256::sub_words(d, e, nw);
  Fe e_red = p256::select(e_lt_n, e, d);  // e < 2^256 < 2n
  const Fe r2 = p256::n_r2();
  const Fe w = n_inv(n_mul(s, r2));
  const Fe one = p256::fe_raw_one();
  out.u1 = n_mul(n_mul(n_mul(e_red, r2), w), one);
  out.u2 = n_mul(n_mul(n_mul(r, r2), w), one);
  return out;
}

// ---------------------------------------------------------------------------
// the prologue: one thread per signature
// ---------------------------------------------------------------------------

P256_HD void prologue(Shared& sh, const uint32_t* e8, const uint32_t* r8,
                      const uint32_t* s8, int32_t kidx, int nkeys) {
  const p256::Scalars sc =
      scalars(p256::load_fe(e8), p256::load_fe(r8), p256::load_fe(s8));
  const uint32_t in_stack = kidx >= 0 && kidx < nkeys;
  sh.ok = sc.ok & in_stack;
  sh.key = in_stack ? kidx : -1;
P256_NO_UNROLL
  for (int k = 0; k < kDigits; ++k) {
    sh.dig[k][0] = (uint8_t)p256::comb_digit(sc.u1, kDigits - 1 - k);
    sh.dig[k][1] = (uint8_t)p256::comb_digit(sc.u2, kDigits - 1 - k);
  }
}

// ---------------------------------------------------------------------------
// the stages
// ---------------------------------------------------------------------------

// table words a rank loads for one digit: 2 entries of 24 over G ranks
template <int G>
constexpr int kLoadWords = 2 * kEntryWords / G;

// word j of digit k's two entries: gtab[d1] (j < 24), then qtab[key][d2];
// a lane outside the stack reads the G table instead (it fails anyway)
P256_HD const uint32_t* entry_word(int j, int k, const Shared& sh,
                                   const In& in) {
  const uint32_t* q =
      sh.key >= 0 ? in.qtab + (size_t)sh.key * kKeyWords : in.gtab;
  return j < kEntryWords
             ? in.gtab + kEntryWords * sh.dig[k][0] + j
             : q + kEntryWords * sh.dig[k][1] + (j - kEntryWords);
}

// stage `id` on rank r of a group of G; acc is the rank's accumulator (the
// same in every rank).  Returns the verdict at the last stage on rank 0,
// else 0.
template <int G>
P256_HD uint32_t stage(int id, int r, Pt& acc, Shared& sh, const In& in) {
  if (id == kStages - 1) {
    acc = p256g::add_finish(sh.s);
    return r == 0 ? p256g::final_check(acc, in.r) & sh.ok : 0u;
  }
  const int k = id / 9;
  switch (id % 9) {
    case 0:  // digit k's doubling, after digit k - 1's Q addition
      acc = k > 0 ? p256g::add_finish(sh.s) : p256::pt_inf();
      p256g::dbl1<G>(r, acc, sh.s);
      break;
    case 1: {  // and digit k's entries on their way to shared memory
      static_assert(2 * kEntryWords % G == 0, "G must divide 48");
      uint32_t w[kLoadWords<G>];
P256_UNROLL
      for (int i = 0; i < kLoadWords<G>; ++i)
        w[i] = *entry_word(r + G * i, k, sh, in);
      p256g::dbl2<G>(r, sh.s);
P256_UNROLL
      for (int i = 0; i < kLoadWords<G>; ++i) {
        const int j = r + G * i;
        sh.ent[j / kEntryWords][j % kEntryWords / 8].v[j % 8] = w[i];
      }
      break;
    }
    case 2:
      p256g::dbl3<G>(r, sh.s);
      break;
    case 3:  // + gtab[d1]
      acc = p256g::dbl_finish(sh.s);
      p256g::add1<G>(r, acc, sh.ent[0], sh.s);
      break;
    case 6:  // + qtab[key][d2]
      acc = p256g::add_finish(sh.s);
      p256g::add1<G>(r, acc, sh.ent[1], sh.s);
      break;
    case 4: case 7:
      p256g::add2<G>(r, sh.s);
      break;
    default:
      p256g::add3<G>(r, sh.s);
      break;
  }
  return 0u;
}

}  // namespace p256c
