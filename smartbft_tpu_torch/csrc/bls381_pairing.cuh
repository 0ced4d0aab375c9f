// The BLS12-381 pairing check of one lane, e(sig, -g2) * e(H(m), pk) == 1,
// on one thread, over the tower of bls381_field.cuh: the first pairing
// kernel's lane, kept as host code for the g++ host harness
// (host_harness.cc), which holds the kernel's stage program
// (bls381_group.cuh, crypto/bls_stages.py: the same formulas, spread over
// a group of threads) to it value for value.
//
// The formulas are crypto/bls12381.py's: Miller doubling and mixed
// addition on the M-twist in Jacobian coordinates over Fp2 (dbl-2007-b
// with its line l00 = 3X^3 - 2Y^2, lx = -3X^2 Z^2, ly = 2YZ^3; the
// addition's l00 = r xq - HZ yq, lx = -r, ly = HZ), each line evaluated
// at the G1 point as l00 + (lx xP) v + (ly yP) v w and multiplied into the
// accumulator by a sparse product (13 Fp2 products in place of 54 Fp
// products of a full Fp12 product).  The loop over the 63 bits of |x|
// below the top one is fused: the variable side e(H(m), pk) and the fixed
// side e(sig, -g2), whose line coefficients are precomputed on the host,
// share one accumulator and one squaring a step.  |x| has 5 of those bits
// set, so 5 addition steps; the bits are constants, the same in every lane.
// Then conj (x < 0), the final exponentiation f^(3 (p^12 - 1) / r) by the
// JAX package's chain (easy part by conjugation, one inversion and the
// p^2 Frobenius; hard part by five exponentiations by |x| or |x| + 1) and
// the comparison with 1.
#pragma once

#include "bls381_field.cuh"

namespace b381 {

// |x|; the BLS parameter x is -kXAbs
constexpr uint64_t kXAbs = 0xD201000000010000ull;
constexpr int kMillerSteps = 63;
constexpr int kAddSteps = 5;

// The constant table: per doubling step and per addition step the fixed
// side's raw line coefficients (l00, lx, ly) at -g2, then the Frobenius
// gammas (fp12_frob).  Layout as crypto/cuda_bls.py::const_table.
struct Consts {
  Fp2 dbl[kMillerSteps][3];
  Fp2 add[kAddSteps][3];
  Fp2 frob[5];
};
static_assert(sizeof(Consts) == 418 * kWords * 4, "constant table layout");

// Jacobian point on the twist: x = X/Z^2, y = Y/Z^3
struct G2J {
  Fp2 x, y, z;
};

// T <- 2T, and the raw coefficients of the tangent line at T
B381_CALL void dbl_step(G2J& T, Fp2* line) {
  const Fp2 X2 = fp2_sqr(T.x);
  const Fp2 Y2 = fp2_sqr(T.y);
  const Fp2 Z2 = fp2_sqr(T.z);
  const Fp2 X2_3 = fp2_add(fp2_dbl(X2), X2);
  line[0] = fp2_sub(fp2_mul(X2_3, T.x), fp2_dbl(Y2));
  line[1] = fp2_neg(fp2_mul(X2_3, Z2));
  const Fp2 YZ2 = fp2_dbl(fp2_mul(T.y, T.z));
  line[2] = fp2_mul(YZ2, Z2);
  const Fp2 C = fp2_sqr(Y2);
  Fp2 D = fp2_sub(fp2_sqr(fp2_add(T.x, Y2)), fp2_add(X2, C));
  D = fp2_dbl(D);
  const Fp2 X3 = fp2_sub(fp2_sqr(X2_3), fp2_dbl(D));
  const Fp2 C8 = fp2_dbl(fp2_dbl(fp2_dbl(C)));
  T.y = fp2_sub(fp2_mul(X2_3, fp2_sub(D, X3)), C8);
  T.x = X3;
  T.z = YZ2;
}

// T <- T + Q (Q affine), and the raw coefficients of the line through them
B381_CALL void add_step(G2J& T, const Fp2& xq, const Fp2& yq, Fp2* line) {
  const Fp2 Z2 = fp2_sqr(T.z);
  const Fp2 Z3 = fp2_mul(Z2, T.z);
  const Fp2 H = fp2_sub(fp2_mul(xq, Z2), T.x);
  const Fp2 R = fp2_sub(fp2_mul(yq, Z3), T.y);
  const Fp2 HZ = fp2_mul(H, T.z);
  line[0] = fp2_sub(fp2_mul(R, xq), fp2_mul(HZ, yq));
  line[1] = fp2_neg(R);
  line[2] = HZ;
  const Fp2 H2 = fp2_sqr(H);
  const Fp2 H3 = fp2_mul(H2, H);
  const Fp2 UH2 = fp2_mul(T.x, H2);
  const Fp2 X3 = fp2_sub(fp2_sub(fp2_sqr(R), H3), fp2_dbl(UH2));
  T.y = fp2_sub(fp2_mul(R, fp2_sub(UH2, X3)), fp2_mul(T.y, H3));
  T.x = X3;
  T.z = HZ;
}

// f <- f * (l00 + (lx xp) v + (ly yp) v w), the line's element being
// L0 + L1 w with L0 = l00 + lx' v, L1 = ly' v
B381_CALL void mul_line(Fp12& f, const Fp2* line, const Fp& xp,
                        const Fp& yp) {
  const Fp2 lx = fp2_mul_fp(line[1], xp);
  const Fp2 ly = fp2_mul_fp(line[2], yp);
  const Fp6 t0 = fp6_mul_by_01(f.c0, line[0], lx);
  const Fp6 t1 = fp6_mul_by_1(f.c1, ly);
  const Fp6 s = fp6_mul_by_01(fp6_add(f.c0, f.c1), line[0], fp2_add(lx, ly));
  f.c0 = fp6_add(t0, fp6_mul_v(t1));
  f.c1 = fp6_sub(fp6_sub(s, t0), t1);
}

// the fused dual Miller loop, conjugated (x < 0); K's lines are read a row
// at a time into the caller's frame
template <class Table>
B381_CALL Fp12 miller(const Table& K, const Fp& sx, const Fp& sy,
                      const Fp& hx, const Fp& hy, const Fp2& qx,
                      const Fp2& qy) {
  Fp12 f = fp12_one();
  G2J T{qx, qy, fp2_one()};
  Fp2 line[3];
  int k = 0;
B381_NO_UNROLL
  for (int i = 0; i < kMillerSteps; ++i) {
    f = fp12_sqr(f);
    dbl_step(T, line);
    mul_line(f, line, hx, hy);
    line[0] = K.dbl[i][0];
    line[1] = K.dbl[i][1];
    line[2] = K.dbl[i][2];
    mul_line(f, line, sx, sy);
    if ((kXAbs >> (kMillerSteps - 1 - i)) & 1u) {
      add_step(T, qx, qy, line);
      mul_line(f, line, hx, hy);
      line[0] = K.add[k][0];
      line[1] = K.add[k][1];
      line[2] = K.add[k][2];
      mul_line(f, line, sx, sy);
      ++k;
    }
  }
  return fp12_conj(f);
}

// m^e for a 64-bit e with its top bit set (|x| and |x| + 1) and m in the
// cyclotomic subgroup, as every value after the easy part is
B381_CALL Fp12 fp12_pow_x(const Fp12& m, uint64_t e) {
  Fp12 acc = m;
B381_NO_UNROLL
  for (int bit = 62; bit >= 0; --bit) {
    acc = fp12_cyclo_sqr(acc);
    if ((e >> bit) & 1u) acc = fp12_mul(acc, m);
  }
  return acc;
}

// f^(3 (p^12 - 1) / r): crypto/bls12381.py::host_final_exp's chain; g as
// for fp12_frob
B381_CALL Fp12 final_exp(const Fp12& f0, const Fp2* g) {
  Fp12 f = fp12_mul(fp12_conj(f0), fp12_inv(f0));
  f = fp12_mul(fp12_frob(fp12_frob(f, g), g), f);
  const Fp12 m = f;
  Fp12 a = fp12_conj(fp12_pow_x(m, kXAbs + 1));   // m^(x-1)
  a = fp12_conj(fp12_pow_x(a, kXAbs + 1));        // m^((x-1)^2)
  const Fp12 b = fp12_conj(fp12_pow_x(a, kXAbs));  // a^x
  a = fp12_mul(b, fp12_frob(a, g));                // a^(x+p)
  const Fp12 c = fp12_pow_x(fp12_pow_x(a, kXAbs), kXAbs);  // a^(x^2)
  a = fp12_mul(fp12_mul(c, fp12_frob(fp12_frob(a, g), g)), fp12_conj(a));
  const Fp12 m3 = fp12_mul(fp12_cyclo_sqr(m), m);
  return fp12_mul(a, m3);
}

// the lane's verdict: 1 when e(sig, -g2) e(H(m), pk) == 1
template <class Table>
B381_CALL uint32_t verify_lane(const Table& K, const Fp& sx, const Fp& sy,
                               const Fp& hx, const Fp& hy, const Fp2& qx,
                               const Fp2& qy) {
  const Fp12 f = miller(K, sx, sy, hx, hy, qx, qy);
  Fp2 g[5];
B381_UNROLL
  for (int j = 0; j < 5; ++j) g[j] = K.frob[j];
  return fp12_is_one(final_exp(f, g)) ? 1u : 0u;
}

}  // namespace b381
