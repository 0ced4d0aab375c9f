// Modulus-generic 256-bit field arithmetic shared by the curve headers
// (p256_field.cuh, ed25519_field.cuh), and through them by every CUDA
// kernel and the g++ host harness (host_harness.cc).  Every routine is
// __host__ __device__ when compiled by nvcc and plain inline C++ under g++,
// so the arithmetic that runs on the card is checked against Python
// integers on a CPU.
//
// Layout: a field element is 8 little-endian 32-bit words.  Montgomery form
// uses R = 2^256, the same R as the JAX package's 16 x 16-bit limbs, so a
// Montgomery value or comb-table entry is the same number in both.
// Products are CIOS Montgomery multiplication with 64-bit partial products
// for any odd modulus below 2^256, given with its -N^-1 mod 2^32.  The code
// is portable C++ (no PTX carry asm): nvcc maps the 64-bit multiply-adds
// onto IMAD.WIDE; hand-scheduled carry chains are later work.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define F256_HD __host__ __device__ __forceinline__
#define F256_UNROLL _Pragma("unroll")
#define F256_NO_UNROLL _Pragma("unroll 1")
#else
#define F256_HD inline
#define F256_UNROLL
#define F256_NO_UNROLL
#endif

namespace f256 {

struct Fe {
  uint32_t v[8];
};

// a modulus with its Montgomery constant -N^-1 mod 2^32
struct Mod {
  uint32_t n[8];
  uint32_t n0inv;
};

F256_HD Fe fe_const(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                    uint32_t a4, uint32_t a5, uint32_t a6, uint32_t a7) {
  return Fe{{a0, a1, a2, a3, a4, a5, a6, a7}};
}

F256_HD Fe fe_zero() { return fe_const(0, 0, 0, 0, 0, 0, 0, 0); }
F256_HD Fe fe_raw_one() { return fe_const(1, 0, 0, 0, 0, 0, 0, 0); }

F256_HD Fe load_fe(const uint32_t* src) {
  Fe a;
F256_UNROLL
  for (int j = 0; j < 8; ++j) a.v[j] = src[j];
  return a;
}

// ---------------------------------------------------------------------------
// multi-word helpers
// ---------------------------------------------------------------------------

// a + b over 8 words; returns the carry out
F256_HD uint32_t add_words(Fe& out, const Fe& a, const Fe& b) {
  uint64_t c = 0;
F256_UNROLL
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)a.v[j] + b.v[j] + c;
    out.v[j] = (uint32_t)s;
    c = s >> 32;
  }
  return (uint32_t)c;
}

// a - b over 8 words; returns the borrow out (1 when a < b)
F256_HD uint32_t sub_words(Fe& out, const Fe& a, const uint32_t* b) {
  uint32_t borrow = 0;
F256_UNROLL
  for (int j = 0; j < 8; ++j) {
    uint64_t d = (uint64_t)a.v[j] - b[j] - borrow;
    out.v[j] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

F256_HD Fe select(uint32_t take_a, const Fe& a, const Fe& b) {
  uint32_t ma = 0u - (take_a & 1u);
  Fe out;
F256_UNROLL
  for (int j = 0; j < 8; ++j) out.v[j] = (a.v[j] & ma) | (b.v[j] & ~ma);
  return out;
}

F256_HD uint32_t is_zero(const Fe& a) {
  uint32_t acc = 0;
F256_UNROLL
  for (int j = 0; j < 8; ++j) acc |= a.v[j];
  return acc == 0 ? 1u : 0u;
}

F256_HD uint32_t eq(const Fe& a, const Fe& b) {
  uint32_t acc = 0;
F256_UNROLL
  for (int j = 0; j < 8; ++j) acc |= a.v[j] ^ b.v[j];
  return acc == 0 ? 1u : 0u;
}

// a < b as 256-bit integers
F256_HD uint32_t lt(const Fe& a, const uint32_t* b) {
  Fe d;
  return sub_words(d, a, b);
}

// ---------------------------------------------------------------------------
// Montgomery field
// ---------------------------------------------------------------------------

// a * b * 2^-256 mod N, CIOS.  Needs a * b < N * 2^256 (any a < 2^256 times
// any b < N); the result is fully reduced (< N).
F256_HD Fe mont_mul(const Fe& a, const Fe& b, const Mod& m) {
  uint32_t t[10];
F256_UNROLL
  for (int j = 0; j < 10; ++j) t[j] = 0;
F256_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
F256_UNROLL
    for (int j = 0; j < 8; ++j) {
      uint64_t uv = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)uv;
      c = uv >> 32;
    }
    uint64_t uv = (uint64_t)t[8] + c;
    t[8] = (uint32_t)uv;
    t[9] = (uint32_t)(uv >> 32);
    uint32_t q = t[0] * m.n0inv;
    uv = (uint64_t)q * m.n[0] + t[0];
    c = uv >> 32;
F256_UNROLL
    for (int j = 1; j < 8; ++j) {
      uv = (uint64_t)q * m.n[j] + t[j] + c;
      t[j - 1] = (uint32_t)uv;
      c = uv >> 32;
    }
    uv = (uint64_t)t[8] + c;
    t[7] = (uint32_t)uv;
    t[8] = t[9] + (uint32_t)(uv >> 32);
  }
  Fe lo, d;
F256_UNROLL
  for (int j = 0; j < 8; ++j) lo.v[j] = t[j];
  uint32_t borrow = sub_words(d, lo, m.n);
  // t < 2N < 2^257: subtract N when t >= N
  return select(t[8] | (borrow ^ 1u), d, lo);
}

F256_HD Fe mont_sqr(const Fe& a, const Mod& m) { return mont_mul(a, a, m); }

F256_HD Fe mod_add(const Fe& a, const Fe& b, const Mod& m) {
  Fe s, d;
  uint32_t carry = add_words(s, a, b);
  uint32_t borrow = sub_words(d, s, m.n);
  return select(carry | (borrow ^ 1u), d, s);
}

F256_HD Fe mod_sub(const Fe& a, const Fe& b, const Mod& m) {
  Fe d, w;
  uint32_t borrow = sub_words(d, a, b.v);
  Fe nn;
F256_UNROLL
  for (int j = 0; j < 8; ++j) nn.v[j] = m.n[j];
  add_words(w, d, nn);
  return select(borrow, w, d);
}

// ---------------------------------------------------------------------------
// scalar digits
// ---------------------------------------------------------------------------

// Lim-Lee comb index (8 teeth, stride 32) for column c: bit c of each
// 32-bit word t is tooth t
F256_HD uint32_t comb_digit(const Fe& u, int c) {
  uint32_t idx = 0;
F256_UNROLL
  for (int t = 0; t < 8; ++t) idx |= ((u.v[t] >> c) & 1u) << t;
  return idx;
}

}  // namespace f256
