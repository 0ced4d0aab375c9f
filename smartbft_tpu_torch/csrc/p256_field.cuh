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
// 128-digit 2-bit Strauss-Shamir scan
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
