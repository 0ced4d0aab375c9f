// The BLS12-381 pairing check of one lane run as a flat stage program
// over a group of G threads, shared by the CUDA kernel (cuda_bls.cu, G = 6
// or 12) and the g++ host harness (host_harness.cc, G = 1, 3, 6, 12).
//
// The program is crypto/bls_stages.py's, uploaded as one uint32 array:
// one lane's verify written out as Fp jobs on numbered slots of the lane's
// slice of shared memory (12 words a slot), cut into stages.  A job is a
// product or a squaring of two operands that are each the unreduced sum of
// one to four slots (the Karatsuba pre-sums, below 4p), a signed sum of
// slots (recombinations, xi and v, negations), or a load of a constant row
// (the fixed side's line coefficients at -g2, the Frobenius gammas).  The
// kernel runs every stage on the G ranks of a group, rank r taking jobs r,
// r + G, ..., then __syncwarp(group mask).  No job of a stage reads a slot
// that another job of the same stage writes, and no two write the same
// slot, so running the ranks of a stage one after another, then the next
// stage, is a faithful serialisation: that is what the host harness does.
// Every rank runs the products on one code path (operands differ, the
// instructions do not); sums of different lengths or signs diverge, and
// cost a fraction of a product.
//
// Layout of the program words (bls_stages.HEADER words of header):
//   [0] stages, [1] jobs, [2] slots, [3] stages of the Miller loop,
//   [4..15] the slots of the result, [16..27] the slots of the Miller
//   loop's value, [28] word offset of the jobs; then the stages' job
//   offsets (stages + 1) and the jobs, 4 words each from a multiple of 4.
// A job's first word is op << 29 | dst << 20 | a << 10; the other three
// hold three 10-bit fields each: for a product the 4 slots of each operand
// (unused ones the zero slot), for a sum its a <= 9 terms (slot | sign <<
// 9, the first positive); a load reads row a of the constant table.
// Slots 0..7 hold the lane's inputs (sig x, y; H(m) x, y; pk x0, x1, y0,
// y1), 8 zero and 9 one (Montgomery); the prologue writes them.
#pragma once

#include "bls381_field.cuh"

namespace b381g {

using b381::Fp;
using b381::kWords;

constexpr int kHeader = 29;
// job kinds: 0 a product, 1 a squaring, 2 a sum, 3 a constant load
constexpr uint32_t kJobSqr = 1, kJobSum = 2;
// slots 0..7 the inputs, 8 zero, 9 one
constexpr int kFixedSlots = 10, kOne = 9;

// one warp a block; a warp holds 32 / G lanes, its last 32 % G threads
// take no lane
template <int G>
struct Grid {
  static_assert(G >= 1 && G <= 32, "group size");
  static constexpr int kThreads = 32;
  static constexpr int kLanes = 32 / G;
};

// words between two lanes' slots: 12 a slot, padded to an odd number of
// 16-byte chunks so the lanes of a warp start on different bank quads
B381_HD int lane_stride(int nslots) {
  const int w = nslots * kWords;
  return ((w / 4) & 1) ? w : w + 4;
}

// thread t of a block: its lane within the block and its rank, or false
// for a thread outside every group
template <int G>
B381_HD bool place(int t, int& loc, int& rank) {
  const int g = (t & 31) / G;
  if (g >= Grid<G>::kLanes) return false;
  loc = (t >> 5) * Grid<G>::kLanes + g;
  rank = (t & 31) % G;
  return true;
}

// program words: through the read-only cache on the card
B381_HD uint32_t rd(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// a slot of shared memory (16-byte aligned): three 16-byte loads on the
// card
B381_HD Fp ld(const uint32_t* s) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(s);
  const uint4 x = q[0], y = q[1], z = q[2];
  return Fp{{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y, z.z, z.w}};
#else
  return b381::load_fp(s);
#endif
}

B381_HD void st(uint32_t* s, const Fp& a) {
#ifdef __CUDA_ARCH__
  uint4* q = reinterpret_cast<uint4*>(s);
  q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
  q[2] = make_uint4(a.v[8], a.v[9], a.v[10], a.v[11]);
#else
  b381::store_fp(s, a);
#endif
}

// a row of the constant table (global memory, 16-byte aligned)
B381_HD Fp ld_row(const uint32_t* table, uint32_t row) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(table + kWords * row);
  const uint4 x = __ldg(q), y = __ldg(q + 1), z = __ldg(q + 2);
  return Fp{{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y, z.z, z.w}};
#else
  return b381::load_fp(table + kWords * row);
#endif
}

B381_HD const uint32_t* slot(const uint32_t* S, uint32_t k) {
  return S + kWords * k;
}

// a job's 4 words (16-byte aligned): one 16-byte load on the card
struct Job {
  uint32_t w0, w1, w2, w3;
};

B381_HD Job job_at(const uint32_t* prog, int j) {
  const uint32_t* q = prog + rd(prog + kHeader - 1) + 4 * j;
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
  return Job{v.x, v.y, v.z, v.w};
#else
  return Job{q[0], q[1], q[2], q[3]};
#endif
}

// field k (0..8) of the 10-bit fields packed three a word in w1..w3
B381_HD uint32_t field(const Job& jb, int k) {
  const uint32_t w = k < 3 ? jb.w1 : (k < 6 ? jb.w2 : jb.w3);
  return (w >> (10 * (k % 3))) & 1023u;
}

// a product's operand: the unreduced sum of its 4 slots (below 4p; unused
// slots are the zero slot), fields k..k+3
B381_HD Fp operand(const Job& jb, int k, const uint32_t* S) {
  Fp x = ld(slot(S, field(jb, k)));
B381_UNROLL
  for (int i = k + 1; i < k + 4; ++i)
    x = b381::fp_add_nr(x, ld(slot(S, field(jb, i))));
  return x;
}

// one job of the program on the lane's slots S
B381_HD void run_job(const Job& jb, uint32_t* S, const uint32_t* table) {
  const uint32_t op = jb.w0 >> 29, a = (jb.w0 >> 10) & 1023u;
  uint32_t* dst = S + kWords * ((jb.w0 >> 20) & 511u);
  if (op <= kJobSqr) {
    const Fp x = operand(jb, 0, S), y = operand(jb, 4, S);
#ifdef __CUDA_ARCH__
    st(dst, b381::fp_mont(x, y));
#else
    st(dst, op == kJobSqr ? b381::fp_sqr(x) : b381::fp_mul(x, y));
#endif
  } else if (op == kJobSum) {
    // a terms, slot | sign << 9, the first one positive
    Fp acc = ld(slot(S, field(jb, 0) & 511u));
    for (int k = 1; k < (int)a; ++k) {
      const uint32_t term = field(jb, k);
      const Fp x = ld(slot(S, term & 511u));
      acc = (term >> 9) ? b381::fp_sub(acc, x) : b381::fp_add(acc, x);
    }
    st(dst, acc);
  } else {
    st(dst, ld_row(table, a));
  }
}

// rank's jobs of stage s
template <int G>
B381_HD void run_stage(const uint32_t* prog, int s, int rank, uint32_t* S,
                       const uint32_t* table) {
  const int j1 = (int)rd(prog + kHeader + s + 1);
  for (int j = (int)rd(prog + kHeader + s) + rank; j < j1; j += G)
    run_job(job_at(prog, j), S, table);
}

// rank's part of the prologue: the fixed slots of lane i; in[k] is the
// (n, 12) word array of input k
template <int G>
B381_HD void prologue(int rank, uint32_t* S, const uint32_t* const* in,
                      size_t i) {
  const Fp one{B381_WORDS_ONE};
  for (int k = rank; k < kFixedSlots; k += G) {
    Fp v = b381::fp_zero();
    if (k < 8) v = b381::load_fp(in[k] + kWords * i);
    if (k == kOne) v = one;
    st(S + kWords * k, v);
  }
}

// 1 when the 12 slots listed at prog[at..at+11] hold the Fp12 one
B381_HD uint32_t is_one(const uint32_t* prog, int at, const uint32_t* S) {
  const uint32_t one[kWords] = B381_WORDS_ONE;
  uint32_t d = 0;
  for (int c = 0; c < 12; ++c) {
    const uint32_t* v = slot(S, rd(prog + at + c));
    for (int j = 0; j < kWords; ++j) d |= v[j] ^ (c == 0 ? one[j] : 0u);
  }
  return d == 0 ? 1u : 0u;
}

}  // namespace b381g
