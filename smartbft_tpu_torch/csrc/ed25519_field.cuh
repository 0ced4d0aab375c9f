// Ed25519 field, curve and per-signature verify routines shared by the
// CUDA kernels (cuda_ed25519.cu, cuda_eddsa.cu) and the g++ host harness
// (host_harness.cc), on top of the modulus-generic 8-word Montgomery field
// of field256.cuh.
//
// Field: p = 2^255 - 19, Montgomery with R = 2^256 (so every value and
// table entry is the same number as in the JAX package), n0inv =
// -p^-1 mod 2^32 = 0x286BCA1B, R mod p = 38, R^2 mod p = 1444.
// Curve: twisted Edwards -x^2 + y^2 = 1 + d x^2 y^2 (a = -1) in extended
// coordinates (X : Y : Z : T), x = X/Z, y = Y/Z, x y = T/Z.  The unified
// addition add-2008-hwcd-3 and the doubling dbl-2008-hwcd (both output
// halves negated, the same projective point) are complete on this curve,
// so no lane branches on its data.
#pragma once

#include "field256.cuh"

namespace ed25519 {

using f256::Fe;
using f256::Mod;
using f256::comb_digit;
using f256::eq;
using f256::fe_const;
using f256::fe_zero;
using f256::is_zero;
using f256::load_fe;
using f256::lt;
using f256::mod_add;
using f256::mod_sub;
using f256::mont_mul;
using f256::mont_sqr;

// extended point, Montgomery coordinates
struct Ept {
  Fe x, y, z, t;
};

#define ED_WORDS_P {0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, \
                    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu}
// the group order L = 2^252 + 27742317777372353535851937790883648493
#define ED_WORDS_L {0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu, \
                    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u}

F256_HD Mod mod_p() { return Mod{ED_WORDS_P, 0x286BCA1Bu}; }

// R mod p (Montgomery 1) and R^2 mod p: to_mont(x) = mont_mul(x, R2)
F256_HD Fe p_one() { return fe_const(38u, 0, 0, 0, 0, 0, 0, 0); }
F256_HD Fe p_r2() { return fe_const(1444u, 0, 0, 0, 0, 0, 0, 0); }
// d and 2d in Montgomery form
F256_HD Fe d_mont() {
  return fe_const(0xDF47E9FAu, 0x80ED8BFEu, 0xAFC62973u, 0x10A18777u,
                  0xBC188690u, 0xE5939207u, 0x729FC526u, 0x2C822B5Au);
}
F256_HD Fe d2_mont() {
  return fe_const(0xBE8FD3F4u, 0x01DB17FDu, 0x5F8C52E7u, 0x21430EEFu,
                  0x78310D20u, 0xCB27240Fu, 0xE53F8A4Du, 0x590456B4u);
}

F256_HD Ept pt_ident() { return Ept{fe_zero(), p_one(), p_one(), fe_zero()}; }

// B, 2B, 3B of the RFC 8032 base point as extended (X : Y : 1 : XY)
F256_HD Ept base_multiple(int i) {
  Ept p;
  p.z = p_one();
  switch (i) {
    case 1:
      p.x = fe_const(0x3F9DA287u, 0xE2CABC55u, 0x2396E489u, 0x9CA59856u,
                     0xADE4B5B7u, 0x9879936Bu, 0x7E6077D0u, 0x759E2370u);
      p.y = fe_const(0x3333334Au, 0x33333333u, 0x33333333u, 0x33333333u,
                     0x33333333u, 0x33333333u, 0x33333333u, 0x33333333u);
      p.t = fe_const(0x994AE86Cu, 0x4F0896AAu, 0xB612506Eu, 0xE3B7AD11u,
                     0xF183C492u, 0x46C7A922u, 0xFEB3930Du, 0x5E181C59u);
      return p;
    case 2:
      p.x = fe_const(0xFA109744u, 0x8F55F199u, 0x3E02662Du, 0x32031E41u,
                     0x97B46389u, 0x0EA0D491u, 0xA75CA811u, 0x1D6A5B5Fu);
      p.y = fe_const(0xE0E85094u, 0x22247DE3u, 0xE05C12C6u, 0x72784614u,
                     0xEE10A6DAu, 0x661A168Du, 0x5B3832D0u, 0x1A5E9213u);
      p.t = fe_const(0x3DB0B8E4u, 0x2DE566AEu, 0xCAAF5867u, 0xE00FA5F2u,
                     0x128CBADFu, 0x700C1B41u, 0xA90990ACu, 0x6EA8DDBFu);
      return p;
    case 3:
      p.x = fe_const(0x76F19BE2u, 0x9696BE39u, 0x3496C3FDu, 0xBC0893C9u,
                     0x5479B8AAu, 0xBE51E541u, 0x21C144DAu, 0x63EB3301u);
      p.y = fe_const(0xF478D7D7u, 0x69017AC1u, 0x4F587298u, 0x9D670B79u,
                     0x45BB98C1u, 0xEBBBFB22u, 0xCD63AF79u, 0x3B646517u);
      p.t = fe_const(0xEAAA5CC0u, 0x92F7552Du, 0x4569731Au, 0xADD1F2C7u,
                     0xC97923D7u, 0x05823D8Bu, 0x66E42083u, 0x476E59C2u);
      return p;
    default:
      return pt_ident();
  }
}

// ---------------------------------------------------------------------------
// curve
// ---------------------------------------------------------------------------

// unified addition add-2008-hwcd-3 (a = -1): 8 products and one by 2d
F256_HD Ept pt_add(const Ept& p, const Ept& q) {
  const Mod m = mod_p();
  Fe s1 = mod_sub(p.y, p.x, m), s2 = mod_sub(q.y, q.x, m);
  Fe a1 = mod_add(p.y, p.x, m), a2 = mod_add(q.y, q.x, m);
  Fe z1d = mod_add(p.z, p.z, m);
  Fe a = mont_mul(s1, s2, m), b = mont_mul(a1, a2, m);
  Fe c1 = mont_mul(p.t, d2_mont(), m), d = mont_mul(z1d, q.z, m);
  Fe c = mont_mul(c1, q.t, m);
  Fe e = mod_sub(b, a, m), f = mod_sub(d, c, m);
  Fe g = mod_add(d, c, m), h = mod_add(b, a, m);
  Ept r;
  r.x = mont_mul(e, f, m);
  r.y = mont_mul(g, h, m);
  r.t = mont_mul(e, h, m);
  r.z = mont_mul(f, g, m);
  return r;
}

// doubling dbl-2008-hwcd with both halves negated (a = -1): 4 squarings +
// 4 products; T of the input is not read
F256_HD Ept pt_dbl(const Ept& p) {
  const Mod m = mod_p();
  Fe xy = mod_add(p.x, p.y, m);
  Fe a = mont_sqr(p.x, m), b = mont_sqr(p.y, m);
  Fe zz = mont_sqr(p.z, m), s = mont_sqr(xy, m);
  Fe c = mod_add(zz, zz, m), h = mod_add(a, b, m);
  Fe g = mod_sub(b, a, m), e1 = mod_sub(s, a, m);
  Fe e = mod_sub(e1, b, m);
  Fe f = mod_sub(c, g, m);
  Ept r;
  r.x = mont_mul(e, f, m);
  r.y = mont_mul(g, h, m);
  r.z = mont_mul(f, g, m);
  r.t = mont_mul(e, h, m);
  return r;
}

// -x^2 + y^2 == 1 + d x^2 y^2 for Montgomery affine coordinates
F256_HD uint32_t on_curve(const Fe& xm, const Fe& ym) {
  const Mod m = mod_p();
  Fe xx = mont_sqr(xm, m), yy = mont_sqr(ym, m);
  Fe lhs = mod_sub(yy, xx, m);
  Fe rhs = mod_add(p_one(), mont_mul(d_mont(), mont_mul(xx, yy, m), m), m);
  return eq(lhs, rhs);
}

// (24,) words -> affine table entry X, Y, T with Z = 1
F256_HD Ept load_aff(const uint32_t* src) {
  Ept p;
  p.x = load_fe(src);
  p.y = load_fe(src + 8);
  p.t = load_fe(src + 16);
  p.z = p_one();
  return p;
}

// ---------------------------------------------------------------------------
// static-key comb verify (one lane): [S]B + [h](-A) == R with Lim-Lee comb
// tables (8 teeth, stride 32), 32 x (1 doubling + 2 additions)
// ---------------------------------------------------------------------------

// btab: (256, 3, 8) words; qtab: this lane's negated-key table, (256, 3, 8)
// words, or null for a key index outside the stack (the lane then fails);
// ok: the host pre-check (R decodes, S < L)
F256_HD uint32_t comb_verify_lane(const uint32_t* s8, const uint32_t* h8,
                                  const uint32_t* rx8, const uint32_t* ry8,
                                  int32_t ok, const uint32_t* btab,
                                  const uint32_t* qtab) {
  if (qtab == 0 || ok == 0) return 0u;
  const Mod m = mod_p();
  const Fe s = load_fe(s8), h = load_fe(h8);
  const Fe rxm = mont_mul(load_fe(rx8), p_r2(), m);
  const Fe rym = mont_mul(load_fe(ry8), p_r2(), m);
  uint32_t r_on = on_curve(rxm, rym);
  Ept acc = pt_ident();
F256_NO_UNROLL
  for (int k = 0; k < 32; ++k) {
    int c = 31 - k;
    acc = pt_dbl(acc);
    acc = pt_add(acc, load_aff(btab + 24 * comb_digit(s, c)));
    acc = pt_add(acc, load_aff(qtab + 24 * comb_digit(h, c)));
  }
  // Z != 0: a zero (padding) table entry drives the accumulator to the
  // all-zero point, which the projective comparison would match on every
  // lane
  uint32_t not_zero = is_zero(acc.z) ^ 1u;
  uint32_t match = eq(mont_mul(rxm, acc.z, m), acc.x) &
                   eq(mont_mul(rym, acc.z, m), acc.y);
  return match & not_zero & r_on;
}

// ---------------------------------------------------------------------------
// generic verify (one lane): S < L, on-curve R and A, joint table
// {iB + j(-A) : i, j < 4}, 127 two-bit digits x (2 doublings + 1 addition)
// ---------------------------------------------------------------------------

// digit k (MSB first) of a scalar below 2^254: bits 253 - 2k, 252 - 2k
F256_HD uint32_t two_bit_digit(const Fe& u, int k) {
  int bit = 252 - 2 * k;
  return (u.v[bit >> 5] >> (bit & 31)) & 3u;
}

F256_HD uint32_t eddsa_verify_lane(const uint32_t* s8, const uint32_t* h8,
                                   const uint32_t* rx8, const uint32_t* ry8,
                                   const uint32_t* ax8, const uint32_t* ay8,
                                   int32_t ok) {
  if (ok == 0) return 0u;
  const Mod m = mod_p();
  const uint32_t lw[8] = ED_WORDS_L;
  const Fe s = load_fe(s8), h = load_fe(h8);
  uint32_t s_ok = lt(s, lw);
  const Fe r2 = p_r2();
  const Fe rxm = mont_mul(load_fe(rx8), r2, m);
  const Fe rym = mont_mul(load_fe(ry8), r2, m);
  const Fe axm = mont_mul(load_fe(ax8), r2, m);
  const Fe aym = mont_mul(load_fe(ay8), r2, m);
  uint32_t oncurve = on_curve(rxm, rym) & on_curve(axm, aym);

  // -A = (-X : Y : 1 : -XY)
  Ept na;
  na.x = mod_sub(fe_zero(), axm, m);
  na.y = aym;
  na.z = p_one();
  na.t = mod_sub(fe_zero(), mont_mul(axm, aym, m), m);
  Ept nas[4];  // j(-A)
  nas[0] = pt_ident();
  nas[1] = na;
  nas[2] = pt_add(na, na);
  nas[3] = pt_add(nas[2], na);
  Ept table[16];
F256_NO_UNROLL
  for (int i = 0; i < 16; ++i) table[i] = pt_add(base_multiple(i >> 2), nas[i & 3]);

  Ept acc = pt_ident();
F256_NO_UNROLL
  for (int k = 0; k < 127; ++k) {
    acc = pt_dbl(pt_dbl(acc));
    acc = pt_add(acc, table[4 * two_bit_digit(s, k) + two_bit_digit(h, k)]);
  }
  uint32_t match = eq(mont_mul(rxm, acc.z, m), acc.x) &
                   eq(mont_mul(rym, acc.z, m), acc.y);
  return match & s_ok & oncurve;
}

}  // namespace ed25519
