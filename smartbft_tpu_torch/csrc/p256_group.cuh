// Generic P-256 ECDSA verify scheduled over a group of G threads per
// signature, shared by the CUDA kernel (cuda_ecdsa.cu, G = 4 or 8) and
// the g++ host harness (host_harness.cc, G = 1, 4 or 8).
//
// The verify is a flat program of kStages stages.  Each stage is a
// function of (stage id, rank, the rank's registers, the signature's shared
// block); the kernel runs every stage on all G ranks of a group and then
// __syncwarp(group mask).  Within a stage no rank reads what another rank
// of the same stage writes, so running ranks 0..G-1 of a stage one after
// another, then the next stage, is a faithful serialisation: that is what
// the host harness does, and how this schedule is checked on a CPU.
//
//   stage 0          prologue: rank 0 runs verify_scalars (the mod-n
//                    Fermat inversion, the long serial chain); the other
//                    ranks (rank 0 too when G = 1) check that Q is on the
//                    curve and build the joint table {iG + jQ} into shared
//                    memory.  iG are constants; 2Q, 3Q and the nine
//                    iG + jQ with i, j >= 1 are split over the ranks.
//                    On the card the two branches diverge within the
//                    warp and run one after the other.
//   stages 1..1152   128 digits x (2 doublings + 1 addition), each point
//                    operation 3 stages of independent products mod p:
//                      addition  {t0, t1, t2, m1, m2, m3} -> {b t2, b y3a}
//                                -> {p1 .. p6}
//                      doubling  {x^2, y^2, z^2, xy, xz, yz} -> {b t2,
//                                b z3a} -> {y3d, x3b, t0b, zz, zt}
//                    rank r runs products r, r + G, ... of a stage and
//                    writes them to the signature's product slots; every
//                    rank computes the cheap additions and subtractions
//                    between stages itself, from the slots.
//   stage 1153       rank 0 compares x(R) with r.
//
// The formulas are those of pt_add / pt_dbl (RCB15, p256_field.cuh) with
// every product mod p on p_mul, and all values fully reduced, so the
// accumulator holds the same field elements as ecdsa_verify_lane's.
// Product slots are double-buffered so that a stage never overwrites a
// slot that another rank of the same stage still reads: the first two
// stages of an operation write slots 0..7, the third 8..13, and an
// operation's result is read out of 8..13 at the start of the next one.
#pragma once

#include "p256_field.cuh"

namespace p256g {

using p256::Fe;
using p256::Pt;

constexpr int kSlots = 14;
// signatures a block (the kernel) or a batch of the serialisation (the
// host harness) holds: G x 16 threads, 16 shared blocks of 2,060 bytes
constexpr int kSigsPerBlock = 16;
constexpr int kDigits = 128;
constexpr int kStages = 2 + 9 * kDigits;

// one signature's shared block: 515 words, an odd stride, so the
// signatures of a warp that read the same word of their own blocks hit
// distinct banks, and the three coordinates of one table entry, read by
// different ranks at the same word, do too (they lie 8 words apart)
struct Shared {
  Fe tab[16][3];    // joint table, entry 4 i + j = iG + jQ, (X, Y, Z)
  Fe s[kSlots];     // stage products
  Fe u1, u2;        // e/s and r/s mod n, from rank 0
  uint32_t ok;      // 1 <= r, s < n
  uint32_t oncurve;
  uint32_t pad;
};

// one signature's inputs, 8 words each
struct In {
  const uint32_t *e, *r, *s, *qx, *qy;
};

P256_HD Fe fadd(const Fe& a, const Fe& b) { return p256::p_add(a, b); }
P256_HD Fe fsub(const Fe& a, const Fe& b) { return p256::p_sub(a, b); }
P256_HD Fe pick3(int i, const Fe& x, const Fe& y, const Fe& z) {
  return p256::select(i == 0, x, p256::select(i == 1, y, z));
}

// G multiples, affine and Montgomery: the table's column j = 0
P256_HD Pt g_multiple(int i) {
  using p256::fe_const;
  const Pt g2 = {
      fe_const(0x10DDD64Du, 0x850046D4u, 0xA433827Du, 0xAA6AE3C1u,
               0x8D1490D9u, 0x73220503u, 0x3DCF3A3Bu, 0xF6BB32E4u),
      fe_const(0x61BEE1A5u, 0x2F3648D3u, 0xEB236FF8u, 0x152CD7CBu,
               0x92042DBEu, 0x19A8FB0Eu, 0x0A5B8A3Bu, 0x78C57751u),
      p256::p_one()};
  const Pt g3 = {
      fe_const(0x4EEBC127u, 0xFFAC3F90u, 0x087D81FBu, 0xB027F84Au,
               0x87CBBC98u, 0x66AD77DDu, 0xB6FF747Eu, 0x26936A3Fu),
      fe_const(0xC983A7EBu, 0xB04C5C1Fu, 0x0861FE1Au, 0x583E47ADu,
               0x1A2EE98Eu, 0x78820831u, 0xE587CC07u, 0xD5F06A29u),
      p256::p_one()};
  if (i == 0) return p256::pt_inf();
  if (i == 1) return Pt{p256::gx_mont(), p256::gy_mont(), p256::p_one()};
  return i == 2 ? g2 : g3;
}

// ---------------------------------------------------------------------------
// the three stages of an addition acc + q (q: X, Y, Z of a table entry)
// ---------------------------------------------------------------------------

template <int G>
P256_HD void add1(int r, const Pt& acc, const Fe* q, Fe* s) {
  const Fe zero = p256::fe_zero();
  for (int k = r; k < 6; k += G) {
    // t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, then (X1+Y1)(X2+Y2),
    // (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
    const int i0 = k < 3 ? k : (k == 4 ? 1 : 0);
    const int i1 = k == 3 ? 1 : 2;
    const uint32_t sum = k >= 3;
    Fe a = fadd(pick3(i0, acc.x, acc.y, acc.z),
                p256::select(sum, pick3(i1, acc.x, acc.y, acc.z), zero));
    Fe b = fadd(q[i0], p256::select(sum, q[i1], zero));
    s[k] = p256::p_mul(a, b);
  }
}

template <int G>
P256_HD void add2(int r, Fe* s) {
  for (int k = r; k < 2; k += G) {
    Fe y3a = fsub(s[5], fadd(s[0], s[2]));  // m3 - (t0 + t2)
    s[6 + k] = p256::p_mul(p256::b_mont(), p256::select(k == 0, s[2], y3a));
  }
}

template <int G>
P256_HD void add3(int r, Fe* s) {
  if (r >= 6) return;
  const Fe t0 = s[0], t1 = s[1], t2 = s[2], m1 = s[3], m2 = s[4], m3 = s[5];
  const Fe zb = s[6], yb = s[7];
  Fe t3 = fsub(m1, fadd(t0, t1)), t4 = fsub(m2, fadd(t1, t2));
  Fe y3a = fsub(m3, fadd(t0, t2));
  Fe u2 = fadd(fadd(t2, t2), t2), w2 = fadd(fadd(t0, t0), t0);
  Fe x3a = fsub(y3a, zb), t0b = fsub(w2, u2);
  Fe y3c = fsub(fsub(yb, u2), t0);
  Fe x3b = fadd(x3a, fadd(x3a, x3a));
  Fe x3c = fadd(t1, x3b), y3d = fadd(fadd(y3c, y3c), y3c);
  Fe z3b = fsub(t1, x3b);
  for (int k = r; k < 6; k += G) {
    // p1 = t4 y3d, p2 = t0b y3d, p3 = x3c z3b, p4 = t3 x3c, p5 = t4 z3b,
    // p6 = t3 t0b
    Fe a = (k == 0 || k == 4) ? t4 : k == 1 ? t0b : k == 2 ? x3c : t3;
    Fe b = k < 2 ? y3d : (k == 2 || k == 4) ? z3b : k == 3 ? x3c : t0b;
    s[8 + k] = p256::p_mul(a, b);
  }
}

P256_HD Pt add_finish(const Fe* s) {
  Pt out;
  out.x = fsub(s[11], s[8]);   // p4 - p1
  out.y = fadd(s[10], s[9]);   // p3 + p2
  out.z = fadd(s[12], s[13]);  // p5 + p6
  return out;
}

// ---------------------------------------------------------------------------
// the three stages of a doubling.  A rank squares with p_mul, not p_sqr:
// the ranks of a warp run one code path, and a rank on p_sqr beside one
// on p_mul would make the warp run both.
// ---------------------------------------------------------------------------

template <int G>
P256_HD void dbl1(int r, const Pt& acc, Fe* s) {
  for (int k = r; k < 6; k += G) {
    // x^2, y^2, z^2, xy, xz, yz
    const int i0 = k < 3 ? k : (k == 5 ? 1 : 0);
    const int i1 = k < 3 ? k : (k == 3 ? 1 : 2);
    s[k] = p256::p_mul(pick3(i0, acc.x, acc.y, acc.z),
                       pick3(i1, acc.x, acc.y, acc.z));
  }
}

template <int G>
P256_HD void dbl2(int r, Fe* s) {
  for (int k = r; k < 2; k += G)  // b t2, b z3a (z3a = 2 xz)
    s[6 + k] = p256::p_mul(p256::b_mont(),
                           p256::select(k == 0, s[2], fadd(s[4], s[4])));
}

template <int G>
P256_HD void dbl3(int r, Fe* s) {
  if (r >= 5) return;
  const Fe t0 = s[0], t1 = s[1], t2 = s[2], xy = s[3], xz = s[4], yz = s[5];
  const Fe bt2 = s[6], bz3 = s[7];
  Fe t3 = fadd(xy, xy), z3a = fadd(xz, xz), yz2 = fadd(yz, yz);
  Fe t2_3 = fadd(fadd(t2, t2), t2), t0_3 = fadd(fadd(t0, t0), t0);
  Fe y3a = fsub(bt2, z3a), z3c = fsub(fsub(bz3, t2_3), t0);
  Fe t0d = fsub(t0_3, t2_3);
  Fe y3b = fadd(fadd(y3a, y3a), y3a), z3d = fadd(fadd(z3c, z3c), z3c);
  Fe y3c = fadd(t1, y3b), x3a = fsub(t1, y3b);
  for (int k = r; k < 5; k += G) {
    // y3d = x3a y3c, x3b = x3a t3, t0b = t0d z3d, zz = yz2 z3d, zt = yz2 t1
    Fe a = k < 2 ? x3a : k == 2 ? t0d : yz2;
    Fe b = k == 0 ? y3c : k == 1 ? t3 : k == 4 ? t1 : z3d;
    s[8 + k] = p256::p_mul(a, b);
  }
}

P256_HD Pt dbl_finish(const Fe* s) {
  Pt out;
  out.y = fadd(s[8], s[10]);   // y3d + t0b
  out.x = fsub(s[9], s[11]);   // x3b - zz
  Fe zt2 = fadd(s[12], s[12]);
  out.z = fadd(zt2, zt2);      // 4 zt
  return out;
}

// ---------------------------------------------------------------------------
// one thread's point operations (G = 1, the slots in its own memory)
// ---------------------------------------------------------------------------

P256_HD Pt pt_dbl_1(const Pt& p, Fe* s) {
  dbl1<1>(0, p, s);
  dbl2<1>(0, s);
  dbl3<1>(0, s);
  return dbl_finish(s);
}

P256_HD Pt pt_add_1(const Pt& p, const Pt& q, Fe* s) {
  const Fe qv[3] = {q.x, q.y, q.z};
  add1<1>(0, p, qv, s);
  add2<1>(0, s);
  add3<1>(0, s);
  return add_finish(s);
}

// ---------------------------------------------------------------------------
// prologue and epilogue
// ---------------------------------------------------------------------------

P256_HD void put_entry(Shared& sh, int e, const Pt& p) {
  sh.tab[e][0] = p.x;
  sh.tab[e][1] = p.y;
  sh.tab[e][2] = p.z;
}

// worker w of nw (ranks 1..G-1, or rank 0 alone when G = 1): Q into
// Montgomery form, the curve check (worker 0), and table entries w, w + nw,
// ... (entry 4 i + j: iG for j = 0, jQ for i = 0, else iG + jQ)
P256_HD void build_table(int w, int nw, Shared& sh, const In& in) {
  const Fe r2 = p256::p_r2();
  const Fe xm = p256::p_mul(p256::load_fe(in.qx), r2);
  const Fe ym = p256::p_mul(p256::load_fe(in.qy), r2);
  if (w == 0) {  // y^2 == x^3 - 3x + b
    Fe yy = p256::p_sqr(ym), x3 = p256::p_mul(p256::p_sqr(xm), xm);
    Fe threex = fadd(fadd(xm, xm), xm);
    sh.oncurve = p256::eq(yy, fadd(fsub(x3, threex), p256::b_mont()));
  }
  Fe s[kSlots];
  const Pt q1 = Pt{xm, ym, p256::p_one()};
  const Pt q2 = pt_dbl_1(q1, s);
  const Pt q3 = pt_add_1(q2, q1, s);
P256_NO_UNROLL
  for (int e = w; e < 16; e += nw) {
    const int i = e >> 2, j = e & 3;
    const Pt qj = j == 1 ? q1 : j == 2 ? q2 : q3;
    Pt v;
    if (j == 0)
      v = g_multiple(i);
    else if (i == 0)
      v = qj;
    else
      v = pt_add_1(g_multiple(i), qj, s);
    put_entry(sh, e, v);
  }
}

// x(R) mod n == r, as verify_final, with the products mod p on p_mul
P256_HD uint32_t final_check(const Pt& acc, const uint32_t* r8) {
  const uint32_t pw[8] = P256_WORDS_P;
  const Fe r = p256::load_fe(r8), nn = Fe{P256_WORDS_N};
  Fe c;
  uint32_t c_carry = p256::add_words(c, r, nn);
  uint32_t c_ok = (c_carry ^ 1u) & p256::lt(c, pw);
  const Fe r2 = p256::p_r2();
  Fe mr = p256::p_mul(p256::p_mul(r, r2), acc.z);
  Fe mc = p256::p_mul(p256::p_mul(c, r2), acc.z);
  uint32_t match = p256::eq(mr, acc.x) | (c_ok & p256::eq(mc, acc.x));
  return match & (p256::is_zero(acc.z) ^ 1u);
}

// table entry of digit k: 4 * (2-bit digit of u1) + (2-bit digit of u2)
P256_HD int entry_of(const Shared& sh, int k) {
  const int bit = 2 * (kDigits - 1 - k);
  return (int)(4u * ((sh.u1.v[bit >> 5] >> (bit & 31)) & 3u) +
               ((sh.u2.v[bit >> 5] >> (bit & 31)) & 3u));
}

// ---------------------------------------------------------------------------
// the program: stage `id` on rank r of a group of G; acc is the rank's
// accumulator (the same in every rank).  Returns the verdict at the last
// stage on rank 0, else 0.
// ---------------------------------------------------------------------------

template <int G>
P256_HD uint32_t stage(int id, int r, Pt& acc, Shared& sh, const In& in) {
  if (id == 0) {
    if (r == 0) {
      p256::Scalars sc = p256::verify_scalars(
          p256::load_fe(in.e), p256::load_fe(in.r), p256::load_fe(in.s));
      sh.u1 = sc.u1;
      sh.u2 = sc.u2;
      sh.ok = sc.ok;
    }
    if (G == 1 || r > 0)
      build_table(G == 1 ? 0 : r - 1, G == 1 ? 1 : G - 1, sh, in);
    acc = p256::pt_inf();
    return 0u;
  }
  if (id == kStages - 1) {
    acc = add_finish(sh.s);
    return r == 0 ? final_check(acc, in.r) & sh.ok & sh.oncurve : 0u;
  }
  const int k = (id - 1) / 9;
  switch ((id - 1) % 9) {
    case 0:  // first doubling of digit k, after digit k - 1's addition
      if (k > 0) acc = add_finish(sh.s);
      dbl1<G>(r, acc, sh.s);
      break;
    case 3:  // second doubling
      acc = dbl_finish(sh.s);
      dbl1<G>(r, acc, sh.s);
      break;
    case 1: case 4:
      dbl2<G>(r, sh.s);
      break;
    case 2: case 5:
      dbl3<G>(r, sh.s);
      break;
    case 6:  // the addition of table entry (digit of u1, digit of u2)
      acc = dbl_finish(sh.s);
      add1<G>(r, acc, sh.tab[entry_of(sh, k)], sh.s);
      break;
    case 7:
      add2<G>(r, sh.s);
      break;
    default:
      add3<G>(r, sh.s);
      break;
  }
  return 0u;
}

}  // namespace p256g
