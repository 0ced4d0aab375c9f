// Host build of the kernels' headers for the CPU tests: g++ compiles the
// same field, curve and per-lane verify routines that the CUDA kernels run
// (p256_field.cuh, p256_group.cuh, p256_comb_group.cuh, ed25519_field.cuh,
// ed25519_group.cuh, ed25519_comb_group.cuh, over field256.cuh, and
// bls381_field.cuh, bls381_group.cuh, bls381_pairing.cuh, with their Fp
// operations counted),
// and exposes them through a C interface so Python can hold them against
// integer arithmetic before any time is spent on the card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libkernels_host.so host_harness.cc
#include <cstring>
#include <vector>

#define B381_COUNT_OPS 1
#include "bls381_group.cuh"
#include "bls381_pairing.cuh"
#include "ed25519_comb_group.cuh"
#include "ed25519_field.cuh"
#include "ed25519_group.cuh"
#include "p256_comb_group.cuh"
#include "p256_field.cuh"
#include "p256_group.cuh"

using p256::Fe;
using p256::Pt;

namespace {

Fe get(const uint32_t* src) { return p256::load_fe(src); }

void put(uint32_t* dst, const Fe& a) {
  for (int j = 0; j < 8; ++j) dst[j] = a.v[j];
}

void put_pt(uint32_t* dst, const Pt& p) {
  put(dst, p.x);
  put(dst + 8, p.y);
  put(dst + 16, p.z);
}

p256::Mod pick(int which) { return which ? p256::mod_n() : p256::mod_p(); }

ed25519::Ept get_ept(const uint32_t* src) {
  return ed25519::Ept{get(src), get(src + 8), get(src + 16), get(src + 24)};
}

void put_ept(uint32_t* dst, const ed25519::Ept& p) {
  put(dst, p.x);
  put(dst + 8, p.y);
  put(dst + 16, p.z);
  put(dst + 24, p.t);
}

template <int G>
void verify_group(int n, const uint32_t* e, const uint32_t* r,
                  const uint32_t* s, const uint32_t* qx, const uint32_t* qy,
                  uint32_t* out) {
  constexpr int kSigs = p256g::kSigsPerBlock;
  std::vector<p256g::Shared> sh(kSigs);
  for (int base = 0; base < n; base += kSigs) {
    p256g::In in[kSigs];
    Pt acc[kSigs][G];
    uint32_t res[kSigs] = {};
    for (int loc = 0; loc < kSigs; ++loc) {
      size_t off = 8 * (size_t)(base + loc < n ? base + loc : n - 1);
      in[loc] = p256g::In{e + off, r + off, s + off, qx + off, qy + off};
    }
    for (int id = 0; id < p256g::kStages; ++id)
      for (int loc = 0; loc < kSigs; ++loc)
        for (int rank = 0; rank < G; ++rank)
          res[loc] |= p256g::stage<G>(id, rank, acc[loc][rank], sh[loc],
                                      in[loc]);
    for (int loc = 0; loc < kSigs && base + loc < n; ++loc)
      out[base + loc] = res[loc];
  }
}

template <int G>
void comb_group(int n, const uint32_t* e, const uint32_t* r,
                const uint32_t* s, const int32_t* kidx, const uint32_t* gtab,
                const uint32_t* qtab, int nkeys, uint32_t* out) {
  constexpr int kSigs = p256c::kSigsPerBlock;
  std::vector<p256c::Shared> sh(kSigs);
  std::vector<Pt> acc(kSigs * G);
  for (int base = 0; base < n; base += kSigs) {
    p256c::In in[kSigs];
    uint32_t res[kSigs] = {};
    for (int loc = 0; loc < kSigs; ++loc) {
      int src = base + loc < n ? base + loc : n - 1;
      size_t off = 8 * (size_t)src;
      p256c::prologue(sh[loc], e + off, r + off, s + off, kidx[src], nkeys);
      in[loc] = p256c::In{gtab, qtab, r + off};
    }
    for (int id = 0; id < p256c::kStages; ++id)
      for (int loc = 0; loc < kSigs; ++loc)
        for (int rank = 0; rank < G; ++rank)
          res[loc] |= p256c::stage<G>(id, rank, acc[loc * G + rank], sh[loc],
                                      in[loc]);
    for (int loc = 0; loc < kSigs && base + loc < n; ++loc)
      out[base + loc] = res[loc];
  }
}

template <int G>
void ed_verify_group(int n, const uint32_t* s, const uint32_t* h,
                     const uint32_t* rx, const uint32_t* ry,
                     const uint32_t* ax, const uint32_t* ay,
                     const int32_t* ok, uint32_t* out) {
  constexpr int kSigs = edg::kSigsPerBlock;
  std::vector<edg::Shared> sh(kSigs);
  for (int base = 0; base < n; base += kSigs) {
    edg::In in[kSigs];
    uint32_t res[kSigs] = {};
    for (int loc = 0; loc < kSigs; ++loc) {
      int src = base + loc < n ? base + loc : n - 1;
      size_t off = 8 * (size_t)src;
      in[loc] = edg::In{s + off,  h + off,  rx + off, ry + off,
                        ax + off, ay + off, ok[src]};
    }
    for (int id = 0; id < edg::kStages; ++id)
      for (int loc = 0; loc < kSigs; ++loc)
        for (int rank = 0; rank < G; ++rank)
          res[loc] |= edg::stage<G>(id, rank, sh[loc], in[loc]);
    for (int loc = 0; loc < kSigs && base + loc < n; ++loc)
      out[base + loc] = res[loc];
  }
}

template <int G>
void ed_comb_group(int n, const uint32_t* s, const uint32_t* h,
                   const uint32_t* rx, const uint32_t* ry, const int32_t* ok,
                   const int32_t* kidx, const uint32_t* btab,
                   const uint32_t* qtab, int nkeys, uint32_t* out) {
  constexpr int kSigs = edc::kSigsPerBlock;
  std::vector<edc::Shared> sh(kSigs);
  for (int base = 0; base < n; base += kSigs) {
    edc::In in[kSigs];
    uint32_t res[kSigs] = {};
    for (int loc = 0; loc < kSigs; ++loc) {
      int src = base + loc < n ? base + loc : n - 1;
      size_t off = 8 * (size_t)src;
      in[loc] = edc::lane_in(s + off, h + off, rx + off, ry + off, ok[src],
                             kidx[src], btab, qtab, nkeys);
    }
    for (int id = 0; id < edc::kStages; ++id)
      for (int loc = 0; loc < kSigs; ++loc)
        for (int rank = 0; rank < G; ++rank)
          res[loc] |= edc::stage<G>(id, rank, sh[loc], in[loc]);
    for (int loc = 0; loc < kSigs && base + loc < n; ++loc)
      out[base + loc] = res[loc];
  }
}

b381::Fp12 get12(const uint32_t* src) {
  b381::Fp12 f;
  std::memcpy(&f, src, sizeof f);
  return f;
}

void put12(uint32_t* dst, const b381::Fp12& f) {
  std::memcpy(dst, &f, sizeof f);
}

b381::Fp getb(const uint32_t* src) { return b381::load_fp(src); }

void putb(uint32_t* dst, const b381::Fp& a) { b381::store_fp(dst, a); }

const b381::Consts& consts(const uint32_t* table) {
  return *reinterpret_cast<const b381::Consts*>(table);
}

// the pairing kernel's grid, serialised: block by block, the threads of a
// block placed as the kernel places them, then each stage on every thread
// in turn (the ranks of a group one after another)
template <int G>
void bls_verify_group(int n, const uint32_t* prog, const uint32_t* table,
                      const uint32_t* const* in, const int32_t* ok,
                      uint32_t* out) {
  using Shape = b381g::Grid<G>;
  const int stride = b381g::lane_stride((int)prog[2]);
  std::vector<uint32_t> smem((size_t)Shape::kLanes * stride);
  struct Thread {
    int lane, loc, rank;
  };
  for (int base = 0; base < n; base += Shape::kLanes) {
    std::vector<Thread> live;
    for (int t = 0; t < Shape::kThreads; ++t) {
      int loc, rank;
      if (!b381g::place<G>(t, loc, rank)) continue;
      const int i = base + loc;
      if (i >= n) continue;
      if (ok[i] == 0) {
        if (rank == 0) out[i] = 0;
        continue;
      }
      live.push_back(Thread{i, loc, rank});
    }
    for (const Thread& th : live)
      b381g::prologue<G>(th.rank, smem.data() + (size_t)th.loc * stride, in,
                         (size_t)th.lane);
    for (int s = 0; s < (int)prog[0]; ++s)
      for (const Thread& th : live)
        b381g::run_stage<G>(prog, s, th.rank,
                            smem.data() + (size_t)th.loc * stride, table);
    for (const Thread& th : live)
      if (th.rank == 0)
        out[th.lane] =
            b381g::is_one(prog, 4, smem.data() + (size_t)th.loc * stride);
  }
}

// one lane's slots after the first `stages` stages, ranks in turn
template <int G>
void bls_lane_slots(const uint32_t* prog, const uint32_t* table,
                    const uint32_t* const* in, int stages, uint32_t* slots) {
  for (int rank = 0; rank < G; ++rank)
    b381g::prologue<G>(rank, slots, in, 0);
  for (int s = 0; s < stages; ++s)
    for (int rank = 0; rank < G; ++rank)
      b381g::run_stage<G>(prog, s, rank, slots, table);
}

}  // namespace

extern "C" {

void p256h_mont_mul(const uint32_t* a, const uint32_t* b, int which,
                    uint32_t* out) {
  put(out, p256::mont_mul(get(a), get(b), pick(which)));
}

void p256h_mont_sqr(const uint32_t* a, int which, uint32_t* out) {
  put(out, p256::mont_sqr(get(a), pick(which)));
}

void p256h_p_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, p256::p_mul(get(a), get(b)));
}

void p256h_p_sqr(const uint32_t* a, uint32_t* out) {
  put(out, p256::p_sqr(get(a)));
}

void p256h_inv_n(const uint32_t* a, uint32_t* out) {
  put(out, p256::inv_mod_n(get(a)));
}

void p256h_mod_add(const uint32_t* a, const uint32_t* b, int which,
                   uint32_t* out) {
  put(out, p256::mod_add(get(a), get(b), pick(which)));
}

void p256h_mod_sub(const uint32_t* a, const uint32_t* b, int which,
                   uint32_t* out) {
  put(out, p256::mod_sub(get(a), get(b), pick(which)));
}

void p256h_pt_dbl(const uint32_t* p, uint32_t* out) {
  put_pt(out, p256::pt_dbl(p256::load_pt(p)));
}

void p256h_pt_add(const uint32_t* p, const uint32_t* q, uint32_t* out) {
  put_pt(out, p256::pt_add(p256::load_pt(p), p256::load_pt(q)));
}

// the comb kernel's lane loop, run sequentially
void p256h_comb_verify(int n, const uint32_t* e, const uint32_t* r,
                       const uint32_t* s, const int32_t* kidx,
                       const uint32_t* gtab, const uint32_t* qtab, int nkeys,
                       uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    int k = kidx[i];
    const uint32_t* q =
        (k >= 0 && k < nkeys) ? qtab + (size_t)k * 256 * 24 : nullptr;
    out[i] = p256::comb_verify_lane(e + 8 * i, r + 8 * i, s + 8 * i, gtab, q);
  }
}

// the comb group kernel's program (p256_comb_group.cuh) for a group of g =
// 1, 4 or 8 ranks, serialised: per batch of kSigsPerBlock signatures, the
// prologue on each signature, then each stage on every signature and rank
// in turn.  Signatures past n re-run the last one and store nothing, as
// the kernel's do.
void p256h_comb_verify_group(int g, int n, const uint32_t* e,
                             const uint32_t* r, const uint32_t* s,
                             const int32_t* kidx, const uint32_t* gtab,
                             const uint32_t* qtab, int nkeys, uint32_t* out) {
  switch (g) {
    case 1: comb_group<1>(n, e, r, s, kidx, gtab, qtab, nkeys, out); break;
    case 4: comb_group<4>(n, e, r, s, kidx, gtab, qtab, nkeys, out); break;
    case 8: comb_group<8>(n, e, r, s, kidx, gtab, qtab, nkeys, out); break;
    default: break;
  }
}

// the comb prologue's products mod n (PTX carry chains on the card)
void p256h_n_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, p256c::n_mul(get(a), get(b)));
}

void p256h_n_sqr(const uint32_t* a, uint32_t* out) {
  put(out, p256c::n_sqr(get(a)));
}

void p256h_n_inv(const uint32_t* a, uint32_t* out) {
  put(out, p256c::n_inv(get(a)));
}

// the generic kernel's lane loop, run sequentially
void p256h_ecdsa_verify(int n, const uint32_t* e, const uint32_t* r,
                        const uint32_t* s, const uint32_t* qx,
                        const uint32_t* qy, uint32_t* out) {
  for (int i = 0; i < n; ++i)
    out[i] = p256::ecdsa_verify_lane(e + 8 * i, r + 8 * i, s + 8 * i,
                                     qx + 8 * i, qy + 8 * i);
}

// the group kernel's program (p256_group.cuh) for a group of g = 1, 4 or 8
// ranks, serialised: per batch of kSigsPerBlock signatures, each stage on
// every signature and rank in turn, then the next stage.  Signatures past
// n re-run the last one and store nothing, as the kernel's do.
void p256h_ecdsa_verify_group(int g, int n, const uint32_t* e,
                              const uint32_t* r, const uint32_t* s,
                              const uint32_t* qx, const uint32_t* qy,
                              uint32_t* out) {
  switch (g) {
    case 1: verify_group<1>(n, e, r, s, qx, qy, out); break;
    case 4: verify_group<4>(n, e, r, s, qx, qy, out); break;
    case 8: verify_group<8>(n, e, r, s, qx, qy, out); break;
    default: break;
  }
}

// ---------------------------------------------------------------------------
// Ed25519 (ed25519_field.cuh)
// ---------------------------------------------------------------------------

void edh_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, f256::mont_mul(get(a), get(b), ed25519::mod_p()));
}

void edh_mont_sqr(const uint32_t* a, uint32_t* out) {
  put(out, f256::mont_sqr(get(a), ed25519::mod_p()));
}

void edh_mod_add(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, f256::mod_add(get(a), get(b), ed25519::mod_p()));
}

void edh_mod_sub(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, f256::mod_sub(get(a), get(b), ed25519::mod_p()));
}

// a^(p-2) by square-and-multiply over the header's products and squarings
// (the kernels need no inversion; this is a 500-deep chain of them)
void edh_inv(const uint32_t* a, uint32_t* out) {
  const f256::Mod m = ed25519::mod_p();
  const uint32_t e[8] = {0xFFFFFFEBu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                         0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
  const Fe x = get(a);
  Fe acc = ed25519::p_one();
  for (int bit = 254; bit >= 0; --bit) {
    acc = f256::mont_sqr(acc, m);
    if ((e[bit >> 5] >> (bit & 31)) & 1u) acc = f256::mont_mul(acc, x, m);
  }
  put(out, acc);
}

void edh_pt_dbl(const uint32_t* p, uint32_t* out) {
  put_ept(out, ed25519::pt_dbl(get_ept(p)));
}

void edh_pt_add(const uint32_t* p, const uint32_t* q, uint32_t* out) {
  put_ept(out, ed25519::pt_add(get_ept(p), get_ept(q)));
}

uint32_t edh_on_curve(const uint32_t* xm, const uint32_t* ym) {
  return ed25519::on_curve(get(xm), get(ym));
}

// the Ed25519 comb kernel's lane loop, run sequentially
void edh_comb_verify(int n, const uint32_t* s, const uint32_t* h,
                     const uint32_t* rx, const uint32_t* ry,
                     const int32_t* ok, const int32_t* kidx,
                     const uint32_t* btab, const uint32_t* qtab, int nkeys,
                     uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    int k = kidx[i];
    const uint32_t* q =
        (k >= 0 && k < nkeys) ? qtab + (size_t)k * 256 * 24 : nullptr;
    out[i] = ed25519::comb_verify_lane(s + 8 * i, h + 8 * i, rx + 8 * i,
                                       ry + 8 * i, ok[i], btab, q);
  }
}

// the comb group kernel's program (ed25519_comb_group.cuh) for a group of
// g = 1, 2 or 4 ranks, serialised as p256h_ecdsa_verify_group's
void edh_comb_verify_group(int g, int n, const uint32_t* s, const uint32_t* h,
                           const uint32_t* rx, const uint32_t* ry,
                           const int32_t* ok, const int32_t* kidx,
                           const uint32_t* btab, const uint32_t* qtab,
                           int nkeys, uint32_t* out) {
  switch (g) {
    case 1: ed_comb_group<1>(n, s, h, rx, ry, ok, kidx, btab, qtab, nkeys, out); break;
    case 2: ed_comb_group<2>(n, s, h, rx, ry, ok, kidx, btab, qtab, nkeys, out); break;
    case 4: ed_comb_group<4>(n, s, h, rx, ry, ok, kidx, btab, qtab, nkeys, out); break;
    default: break;
  }
}

// the generic Ed25519 kernel's lane loop, run sequentially
void edh_eddsa_verify(int n, const uint32_t* s, const uint32_t* h,
                      const uint32_t* rx, const uint32_t* ry,
                      const uint32_t* ax, const uint32_t* ay,
                      const int32_t* ok, uint32_t* out) {
  for (int i = 0; i < n; ++i)
    out[i] = ed25519::eddsa_verify_lane(s + 8 * i, h + 8 * i, rx + 8 * i,
                                        ry + 8 * i, ax + 8 * i, ay + 8 * i,
                                        ok[i]);
}

// the fold field of ed25519_group.cuh (plain form mod 2^255 - 19; the
// results may be only partly reduced, e_canon makes them canonical)
void edh_e_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, edg::e_mul(get(a), get(b)));
}

void edh_e_sqr(const uint32_t* a, uint32_t* out) {
  put(out, edg::e_sqr(get(a)));
}

void edh_e_add(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, edg::e_add(get(a), get(b)));
}

void edh_e_sub(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put(out, edg::e_sub(get(a), get(b)));
}

void edh_e_canon(const uint32_t* a, uint32_t* out) {
  put(out, edg::e_canon(get(a)));
}

// the comb program's D = 76 z (ed25519_comb_group.cuh)
void edh_e_mul76(const uint32_t* a, uint32_t* out) {
  put(out, edc::e_mul76(get(a)));
}

// the group kernel's program (ed25519_group.cuh) for a group of g = 1, 2
// or 4 ranks, serialised as p256h_ecdsa_verify_group's
void edh_eddsa_verify_group(int g, int n, const uint32_t* s,
                            const uint32_t* h, const uint32_t* rx,
                            const uint32_t* ry, const uint32_t* ax,
                            const uint32_t* ay, const int32_t* ok,
                            uint32_t* out) {
  switch (g) {
    case 1: ed_verify_group<1>(n, s, h, rx, ry, ax, ay, ok, out); break;
    case 2: ed_verify_group<2>(n, s, h, rx, ry, ax, ay, ok, out); break;
    case 4: ed_verify_group<4>(n, s, h, rx, ry, ax, ay, ok, out); break;
    default: break;
  }
}

// BLS12-381 (bls381_field.cuh, bls381_pairing.cuh).  Fp values are 12
// words, Fp12 values 12 Fp in the stacked order (a0 re, a0 im, a1 re, ...,
// b2 im), table the (418, 12) constant table of cuda_bls.const_table.

void blsh_fp_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  putb(out, b381::fp_mul(getb(a), getb(b)));
}

void blsh_fp_sqr(const uint32_t* a, uint32_t* out) {
  putb(out, b381::fp_sqr(getb(a)));
}

void blsh_fp_add(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  putb(out, b381::fp_add(getb(a), getb(b)));
}

void blsh_fp_sub(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  putb(out, b381::fp_sub(getb(a), getb(b)));
}

void blsh_fp_inv(const uint32_t* a, uint32_t* out) {
  putb(out, b381::fp_inv(getb(a)));
}

void blsh_fp12_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  put12(out, b381::fp12_mul(get12(a), get12(b)));
}

void blsh_fp12_sqr(const uint32_t* a, uint32_t* out) {
  put12(out, b381::fp12_sqr(get12(a)));
}

void blsh_fp12_cyclo_sqr(const uint32_t* a, uint32_t* out) {
  put12(out, b381::fp12_cyclo_sqr(get12(a)));
}

void blsh_fp12_inv(const uint32_t* a, uint32_t* out) {
  put12(out, b381::fp12_inv(get12(a)));
}

void blsh_fp12_frob(const uint32_t* a, const uint32_t* table,
                    uint32_t* out) {
  put12(out, b381::fp12_frob(get12(a), consts(table).frob));
}

// f * the line (l00, lx, ly: 3 Fp2, 72 words) evaluated at (xp, yp)
void blsh_mul_line(const uint32_t* f, const uint32_t* line,
                   const uint32_t* xp, const uint32_t* yp, uint32_t* out) {
  b381::Fp12 acc = get12(f);
  b381::Fp2 l[3];
  std::memcpy(l, line, sizeof l);
  b381::mul_line(acc, l, getb(xp), getb(yp));
  put12(out, acc);
}

// one lane's Miller loop, and the final exponentiation of an Fp12
void blsh_miller(const uint32_t* table, const uint32_t* lane,
                 uint32_t* out) {
  const b381::Fp2 qx{getb(lane + 48), getb(lane + 60)};
  const b381::Fp2 qy{getb(lane + 72), getb(lane + 84)};
  put12(out, b381::miller(consts(table), getb(lane), getb(lane + 12),
                          getb(lane + 24), getb(lane + 36), qx, qy));
}

void blsh_final_exp(const uint32_t* table, const uint32_t* f,
                    uint32_t* out) {
  b381::Fp2 g[5];
  std::memcpy(g, consts(table).frob, sizeof g);
  put12(out, b381::final_exp(get12(f), g));
}

// the kernel's lane loop, run sequentially: the inputs as the kernel's
void blsh_verify(int n, const uint32_t* table, const uint32_t* sig_x,
                 const uint32_t* sig_y, const uint32_t* hm_x,
                 const uint32_t* hm_y, const uint32_t* pk_x0,
                 const uint32_t* pk_x1, const uint32_t* pk_y0,
                 const uint32_t* pk_y1, const int32_t* ok, uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    if (ok[i] == 0) {
      out[i] = 0;
      continue;
    }
    const size_t o = (size_t)b381::kWords * i;
    const b381::Fp2 qx{getb(pk_x0 + o), getb(pk_x1 + o)};
    const b381::Fp2 qy{getb(pk_y0 + o), getb(pk_y1 + o)};
    out[i] = b381::verify_lane(consts(table), getb(sig_x + o),
                               getb(sig_y + o), getb(hm_x + o),
                               getb(hm_y + o), qx, qy);
  }
}

// the kernel's stage program (prog: crypto/bls_stages.py's words) on the
// grid of a group of g = 1, 3, 6 or 12 threads a lane, serialised
void blsh_verify_group(int g, int n, const uint32_t* prog,
                       const uint32_t* table, const uint32_t* sig_x,
                       const uint32_t* sig_y, const uint32_t* hm_x,
                       const uint32_t* hm_y, const uint32_t* pk_x0,
                       const uint32_t* pk_x1, const uint32_t* pk_y0,
                       const uint32_t* pk_y1, const int32_t* ok,
                       uint32_t* out) {
  const uint32_t* const in[8] = {sig_x, sig_y, hm_x,  hm_y,
                                 pk_x0, pk_x1, pk_y0, pk_y1};
  switch (g) {
    case 1: bls_verify_group<1>(n, prog, table, in, ok, out); break;
    case 3: bls_verify_group<3>(n, prog, table, in, ok, out); break;
    case 6: bls_verify_group<6>(n, prog, table, in, ok, out); break;
    case 12: bls_verify_group<12>(n, prog, table, in, ok, out); break;
    default: break;
  }
}

// one lane (lane: its 8 inputs, 96 words) through the first `stages`
// stages at g threads; slots: the program's slot count x 12 words
void blsh_lane_slots(int g, const uint32_t* prog, const uint32_t* table,
                     const uint32_t* lane, int stages, uint32_t* slots) {
  const uint32_t* const in[8] = {lane,      lane + 12, lane + 24, lane + 36,
                                 lane + 48, lane + 60, lane + 72, lane + 84};
  switch (g) {
    case 1: bls_lane_slots<1>(prog, table, in, stages, slots); break;
    case 6: bls_lane_slots<6>(prog, table, in, stages, slots); break;
    case 12: bls_lane_slots<12>(prog, table, in, stages, slots); break;
    default: break;
  }
}

void blsh_fp_add_nr(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  putb(out, b381::fp_add_nr(getb(a), getb(b)));
}

// the Fp products and squarings counted since the last reset
void blsh_op_counts(unsigned long long* out) {
  out[0] = b381::op_count().mul;
  out[1] = b381::op_count().sqr;
}

void blsh_reset_op_counts() { b381::op_count() = b381::OpCount{0, 0}; }

}  // extern "C"
