// Static-key comb P-256 ECDSA verify for Hopper (sm_90a).
//
// Replaces the TPU kernel smartbft_tpu/crypto/pallas_comb.py::_kernel
// (driven by ecdsa_verify_comb): verify against registered replica keys
// with Lim-Lee comb tables (8 teeth, stride 32): u1 = e/s and u2 = r/s mod
// n by a Fermat inversion, 32 x (one complete doubling + two complete
// additions of table entries gtab[d1], qtab[kidx][d2]), then x(R) mod n
// == r.
//
// What bounds it: a signature reads 100 bytes and writes 4, but its work
// is two chains of dependent products.  The scan is 96 point operations of
// 6 / 2 / 6 (or 5) products, each operation waiting on the one before; the
// scalar prologue is the inversion, ~330 products mod n each waiting on the
// one before.  At the main path's batch sizes (128 to 2048 lanes: at most
// 64 blocks, one an SM) the two chains' latency bounds a launch; at 16384
// lanes integer issue does.  The tables (24 KB a key) stay in the 50 MB
// L2.
//
// Design: the prologue runs at block level, one thread per signature:
// threads 0..31 of a block (warp 0) each check one signature's range,
// compute u1 and u2 on the mod-n products of p256_comb_group.cuh (PTX
// carry chains, a dedicated squaring) and write the 32 comb digit pairs to
// shared memory; then __syncthreads().  The inversion thus runs 32
// signatures to a warp, with no divergence inside a group.  The scan is a
// group program: COMB_GROUP consecutive threads of a warp verify one
// signature over p256_comb_group.cuh's 289 stages, every point operation 3
// stages of independent products mod p (p_mul, p's special form) with the
// products exchanged through the signature's shared block and
// __syncwarp(group mask) between stages; each digit's two table entries
// are loaded one stage ahead, each rank its own words.  32 signatures a
// block, 716 bytes of shared memory each.  Signatures past n re-run the
// last one and store nothing, and a failing lane runs every stage and is
// masked at the end, so no thread leaves before a barrier.
#include <cuda_runtime.h>

#include "p256_comb_group.cuh"

// threads a signature; the library builds at 8, chip_smoke.py also times
// a build at 4 (csrc.VARIANTS)
#ifndef COMB_GROUP
#define COMB_GROUP 8
#endif

namespace {

constexpr int kGroup = COMB_GROUP;
static_assert(kGroup == 4 || kGroup == 8, "COMB_GROUP must be 4 or 8");
constexpr int kSigs = p256c::kSigsPerBlock;
constexpr int kThreads = kSigs * kGroup;

__global__ void __launch_bounds__(kThreads)
comb_verify_kernel(const uint32_t* __restrict__ e,
                   const uint32_t* __restrict__ r,
                   const uint32_t* __restrict__ s,
                   const int32_t* __restrict__ kidx,
                   const uint32_t* __restrict__ gtab,
                   const uint32_t* __restrict__ qtab, int nkeys,
                   uint32_t* __restrict__ out, int n) {
  __shared__ p256c::Shared sh[kSigs];
  const int base = blockIdx.x * kSigs;
  if (threadIdx.x < kSigs) {
    const int src = min(base + (int)threadIdx.x, n - 1);
    const size_t off = 8 * (size_t)src;
    p256c::prologue(sh[threadIdx.x], e + off, r + off, s + off, kidx[src],
                    nkeys);
  }
  __syncthreads();
  const int rank = threadIdx.x % kGroup;
  const int loc = threadIdx.x / kGroup;
  const int sig = base + loc;
  const size_t off = 8 * (size_t)(sig < n ? sig : n - 1);
  const p256c::In in{gtab, qtab, r + off};
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << kGroup) - 1u)
                        << (lane & ~(unsigned)(kGroup - 1));
  p256::Pt acc;
  uint32_t verdict = 0;
#pragma unroll 1
  for (int id = 0; id < p256c::kStages; ++id) {
    verdict |= p256c::stage<kGroup>(id, rank, acc, sh[loc], in);
    __syncwarp(mask);
  }
  if (rank == 0 && sig < n) out[sig] = verdict;
}

}  // namespace

// threads per signature this library was built with
extern "C" int smartbft_comb_group() { return kGroup; }

// e, r, s: (n, 8) uint32 words; kidx: (n,) int32; gtab: (256, 3, 8);
// qtab: (nkeys, 256, 3, 8); out: (n,) uint32.  Returns cudaGetLastError().
extern "C" int smartbft_comb_verify(const void* e, const void* r,
                                    const void* s, const void* kidx,
                                    const void* gtab, const void* qtab,
                                    int nkeys, void* out, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  dim3 grid((n + kSigs - 1) / kSigs);
  comb_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)e, (const uint32_t*)r, (const uint32_t*)s,
      (const int32_t*)kidx, (const uint32_t*)gtab, (const uint32_t*)qtab,
      nkeys, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
