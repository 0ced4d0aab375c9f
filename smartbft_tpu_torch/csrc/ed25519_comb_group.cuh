// Static-key comb Ed25519 verify scheduled over a group of G threads per
// signature, shared by the CUDA kernel (cuda_ed25519.cu, G = 2 or 4) and
// the g++ host harness (host_harness.cc, G = 1, 2 or 4).
//
// The check is [S]B + [h](-A) == R over the Lim-Lee comb tables (8 teeth,
// stride 32) of B and of the signer's negated key: 32 digits x (one
// doubling + two unified additions), the formulas of ed25519_field.cuh on
// the fold field of ed25519_group.cuh (plain form mod 2^255 - 19, values
// partly reduced, e_canon before every comparison).
//
// The tables are read as they are stored.  An entry holds the Montgomery
// words X = x R, Y = y R, T = x y R mod p (R = 2^256), the JAX package's
// tables word for word.  Read as plain numbers they are the extended point
// (x R : y R : R : x y R) with Z = R mod p = 38, since T Z = X Y: the same
// point, so no product converts it.  Its cached form is (Y - X, Y + X,
// 2d T, 2 Z = 76); an addition's D = 76 Z1 is a fold of 2 Z1 by 38 (the
// existing e_fold chain, no new one).  R's coordinates arrive in plain
// form, so R's curve check runs on d_plain and the match is X = rx Z,
// Y = ry Z.  A zero-padded stack slot (X = Y = T = 0) drives Z to 0 at the
// next doubling, and the Z != 0 guard rejects it.
//
// The verify is a flat program of kStages stages, as ed25519_group.cuh's:
// the kernel runs every stage on all G ranks of a group, then
// __syncwarp(group mask); within a stage no rank reads what another rank
// of the same stage writes, so running ranks 0..G-1 of a stage one after
// another, then the next stage, is a faithful serialisation (what the host
// harness does).  A stage holds at most 4 products, job j on rank j mod G,
// all on one code path.
//
//   stage 0       the 32 comb digit pairs of S and h into shared memory
//                 (rank r: columns r, r + G, ...); rx^2, ry^2; the
//                 accumulator set to the identity (0 : 1 : 1 : 0)
//   stage 1       digit 0's two entries loaded (each rank its words);
//                 rx^2 ry^2
//   stage 2       2d T of digit 0's B entry; d rx^2 ry^2
//   stages 3..    per digit k, 6 stages (23 products):
//     u = 0  doubling: X^2, Y^2, Z^2, (X + Y)^2
//     u = 1  EF, GH, FG, EH of the doubling
//     u = 2  + btab[d1]: (Y1 - X1)(Y2 - X2), (Y1 + X1)(Y2 + X2), T1 c_B;
//            c_Q = 2d T of the key entry qtab[key][d2]
//     u = 3  EF, GH, FG, EH of that addition (D = 76 Z1 formed by every
//            rank); digit k + 1's B entry loaded, each rank its words,
//            stored after the product, so the L2 latency is off the chain
//     u = 4  + qtab[key][d2]: the same three products with c_Q
//     u = 5  EF, GH, FG (no T: the next doubling does not read it) and
//            c_B = 2d T of digit k + 1's B entry; digit k + 1's key entry
//            loaded the same way
//   last stage    rank 0: R on the curve, X = rx Z, Y = ry Z, Z != 0, the
//                 host's ok and the key index inside the stack.
//
// The accumulator is double-buffered by point operation (operation o reads
// acc[o & 1] and its second stage writes acc[(o + 1) & 1]), so an
// addition's second stage can read Z1 while it writes the new point.  An
// entry's buffer is rewritten only after the stage that last reads it.
#pragma once

#include "ed25519_group.cuh"

namespace edc {

using f256::Fe;
using f256::load_fe;
using f256::select;

constexpr int kDigits = 32;                   // comb columns (the stride)
constexpr int kEntryWords = 24;               // X, Y, T of one table entry
constexpr int kKeyWords = 256 * kEntryWords;  // one key's table
// signatures a block (the kernel) or a batch of the serialisation (the host
// harness)
constexpr int kSigsPerBlock = 16;
constexpr int kPrologue = 3;
constexpr int kStages = kPrologue + 6 * kDigits + 1;

// one signature's shared block: 209 words, an odd stride, so the
// signatures of a warp that touch the same word of their own blocks hit
// distinct banks
struct Shared {
  Fe q[4];                  // stage products
  Fe acc[2][4];             // the accumulator (X, Y, Z, T), double-buffered
  Fe ent[2][3];             // the digit's entries: btab[d1], qtab[key][d2]
  Fe c[2];                  // 2d T of each entry
  Fe rc[4];                 // rx^2, ry^2, rx^2 ry^2, d rx^2 ry^2
  uint8_t dig[kDigits][2];  // comb digit pairs (S, h), MSB column first
  uint32_t pad;
};

// one signature's inputs: its words, the base table and its key's table
// (the base table for a key index outside the stack), and the host's ok
// with the key inside the stack
struct In {
  const uint32_t *s, *h, *rx, *ry, *btab, *qtab;
  uint32_t live;
};

// s, h, rx, ry: this signature's 8 words each; qtab: (nkeys, 256, 3, 8)
F256_HD In lane_in(const uint32_t* s, const uint32_t* h, const uint32_t* rx,
                   const uint32_t* ry, int32_t ok, int32_t kidx,
                   const uint32_t* btab, const uint32_t* qtab, int nkeys) {
  const bool in_stack = kidx >= 0 && kidx < nkeys;
  return In{s, h, rx, ry, btab,
            in_stack ? qtab + (size_t)kidx * kKeyWords : btab,
            (uint32_t)(ok != 0 && in_stack)};
}

// 76 z mod p (< 2^256): 2 z folded by 38, the D of an addition whose
// addend has Z2 = 38
F256_HD Fe e_mul76(const Fe& z) {
  const Fe z2 = edg::e_add(z, z);
  uint32_t t[16] = {};
F256_UNROLL
  for (int j = 0; j < 8; ++j) t[8 + j] = z2.v[j];
  return edg::e_fold(t);
}

// first stage of an addition, job j of {(Y1 - X1)(Y2 - X2),
// (Y1 + X1)(Y2 + X2), T1 c, 2d tn}: p the accumulator, e the entry as
// stored (X, Y, T), c its 2d T, tn the T whose 2d T job 3 forms
F256_HD Fe add_job(int j, const Fe* p, const Fe* e, const Fe& c,
                   const Fe& tn) {
  const Fe a = edg::pick4(j, edg::e_sub(p[1], p[0]), edg::e_add(p[1], p[0]),
                          p[3], tn);
  const Fe b = edg::pick4(j, edg::e_sub(e[1], e[0]), edg::e_add(e[1], e[0]),
                          c, edg::d2_plain());
  return edg::e_mul(a, b);
}

// words a rank loads of one entry: 24 over G ranks
template <int G>
constexpr int kLoadWords = kEntryWords / G;

// entry w (0: the B entry, 1: the key entry) of digit k
F256_HD const uint32_t* entry(int w, int k, const Shared& sh, const In& in) {
  return (w ? in.qtab : in.btab) + kEntryWords * sh.dig[k][w];
}

// stage `id` on rank r of a group of G.  Returns the verdict at the last
// stage on rank 0, else 0.
template <int G>
F256_HD uint32_t stage(int id, int r, Shared& sh, const In& in) {
  static_assert(kEntryWords % G == 0, "G must divide 24");
  if (id >= kPrologue && id < kStages - 1) {
    const int t = id - kPrologue, k = t / 6, u = t % 6;
    const int op = 3 * k + u / 2;
    const Fe* a = sh.acc[op & 1];
    Fe* nxt = sh.acc[(op + 1) & 1];
    if (u == 0) {
      for (int j = r; j < 4; j += G) sh.q[j] = edg::dbl_prod(j, a);
    } else if (u == 1) {
      Fe o[4];
      edg::dbl_efgh(sh.q, o);
      for (int j = r; j < 4; j += G) nxt[j] = edg::finish_prod(j, o);
    } else if (u == 2 || u == 4) {
      const int w = u == 4;
      for (int j = r; j < 4 - w; j += G) {
        const Fe v = add_job(j, a, sh.ent[w], sh.c[w], sh.ent[1][2]);
        if (j < 3)
          sh.q[j] = v;
        else
          sh.c[1] = v;
      }
    } else {  // u = 3, 5: the addition's second stage and a load
      const int w = u == 5, kn = k + 1 < kDigits ? k + 1 : k;
      const uint32_t* src = entry(w, kn, sh, in);
      uint32_t ld[kLoadWords<G>];
F256_UNROLL
      for (int i = 0; i < kLoadWords<G>; ++i) ld[i] = src[r + G * i];
      const Fe q[4] = {sh.q[0], sh.q[1], sh.q[2], e_mul76(a[2])};
      Fe o[4];
      edg::add_efgh(q, o);
      for (int j = r; j < 4; j += G) {
        if (j < 3 || w == 0)
          nxt[j] = edg::finish_prod(j, o);
        else
          sh.c[0] = edg::e_mul(sh.ent[0][2], edg::d2_plain());
      }
F256_UNROLL
      for (int i = 0; i < kLoadWords<G>; ++i) {
        const int j = r + G * i;
        sh.ent[w][j / 8].v[j % 8] = ld[i];
      }
    }
    return 0u;
  }
  switch (id) {
    case 0: {  // digits, rx^2 and ry^2, the identity
      const Fe s = load_fe(in.s), h = load_fe(in.h);
      for (int c = r; c < kDigits; c += G) {
        sh.dig[c][0] = (uint8_t)f256::comb_digit(s, kDigits - 1 - c);
        sh.dig[c][1] = (uint8_t)f256::comb_digit(h, kDigits - 1 - c);
      }
      const Fe rx = load_fe(in.rx), ry = load_fe(in.ry);
      for (int j = r; j < 2; j += G) sh.rc[j] = edg::e_sqr(select(j == 0, rx, ry));
      for (int j = r; j < 4; j += G) sh.acc[0][j] = edg::e_small(j == 1 || j == 2);
      return 0u;
    }
    case 1: {  // digit 0's entries; rx^2 ry^2
      for (int j = r; j < 2 * kEntryWords; j += G) {
        const int w = j / kEntryWords, i = j % kEntryWords;
        sh.ent[w][i / 8].v[i % 8] = entry(w, 0, sh, in)[i];
      }
      if (r == 0) sh.rc[2] = edg::e_mul(sh.rc[0], sh.rc[1]);
      return 0u;
    }
    case 2:  // c_B of digit 0; d rx^2 ry^2
      for (int j = r; j < 2; j += G)
        *(j == 0 ? &sh.c[0] : &sh.rc[3]) =
            edg::e_mul(select(j == 0, sh.ent[0][2], sh.rc[2]),
                       select(j == 0, edg::d2_plain(), edg::d_plain()));
      return 0u;
    default: {  // [S]B + [h](-A) == R: X = rx Z, Y = ry Z, Z != 0
      if (r != 0) return 0u;
      const Fe* a = sh.acc[(3 * kDigits) & 1];
      const Fe one = edg::e_small(1);
      const uint32_t on = edg::e_eq(edg::e_sub(sh.rc[1], sh.rc[0]),
                                    edg::e_add(one, sh.rc[3]));
      const uint32_t match = edg::e_eq(edg::e_mul(load_fe(in.rx), a[2]), a[0]) &
                             edg::e_eq(edg::e_mul(load_fe(in.ry), a[2]), a[1]);
      return match & (f256::is_zero(edg::e_canon(a[2])) ^ 1u) & on & in.live;
    }
  }
}

}  // namespace edc
