// Generic P-256 ECDSA verify for Hopper (sm_90a), for keys outside the
// comb registry.
//
// Replaces the TPU kernel smartbft_tpu/crypto/pallas_ecdsa.py::_kernel ->
// _verify_block (driven by ecdsa_verify): range checks, Fermat inversion
// of s, an on-curve check of Q, a 16-entry joint table {iG + jQ} and a
// 128-digit 2-bit Strauss-Shamir scan (2 doublings + 1 addition a digit).
//
// What bounds it: a signature reads 160 bytes and writes 4, but needs
// ~4,900 products of 8 x 32-bit words, most of them in one chain of
// dependent point operations.  At the main path's batch sizes (up to a few
// thousand lanes, a warp or so a scheduler) that chain's latency bounds
// the launch; one thread per signature ran it alone.  At 16384 lanes
// integer issue bounds it.
//
// Design: a group of ECDSA_GROUP consecutive threads of a warp verifies
// one signature, over the stage program of p256_group.cuh.  In the
// prologue rank 0 runs the mod-n inversion and the other ranks build the
// joint table into shared memory; the two branches diverge within the
// warp, so they run one after the other.  In the scan every point
// operation is 3 stages of
// independent products mod p spread over the ranks, with the products
// exchanged through the signature's shared block and __syncwarp(group
// mask) between stages.  Products mod p are p_mul, whose reduction uses
// p's special form (no multiply).  16 signatures a block, 2,060 bytes of
// shared memory each.  Signatures past n re-run the last one and store
// nothing, so no thread leaves before a barrier.
#include <cuda_runtime.h>

#include "p256_group.cuh"

// threads a signature; the library builds at 8, chip_smoke.py also times
// a build at 4 (csrc.VARIANTS)
#ifndef ECDSA_GROUP
#define ECDSA_GROUP 8
#endif

namespace {

constexpr int kGroup = ECDSA_GROUP;
static_assert(kGroup == 4 || kGroup == 8, "ECDSA_GROUP must be 4 or 8");
constexpr int kSigs = p256g::kSigsPerBlock;
constexpr int kThreads = kSigs * kGroup;

__global__ void __launch_bounds__(kThreads)
ecdsa_verify_kernel(const uint32_t* __restrict__ e,
                    const uint32_t* __restrict__ r,
                    const uint32_t* __restrict__ s,
                    const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy,
                    uint32_t* __restrict__ out, int n) {
  __shared__ p256g::Shared sh[kSigs];
  const int rank = threadIdx.x % kGroup;
  const int loc = threadIdx.x / kGroup;
  const int sig = blockIdx.x * kSigs + loc;
  const size_t off = 8 * (size_t)(sig < n ? sig : n - 1);
  const p256g::In in{e + off, r + off, s + off, qx + off, qy + off};
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << kGroup) - 1u)
                        << (lane & ~(unsigned)(kGroup - 1));
  p256::Pt acc;
  uint32_t verdict = 0;
#pragma unroll 1
  for (int id = 0; id < p256g::kStages; ++id) {
    verdict |= p256g::stage<kGroup>(id, rank, acc, sh[loc], in);
    __syncwarp(mask);
  }
  if (rank == 0 && sig < n) out[sig] = verdict;
}

}  // namespace

// threads per signature this library was built with
extern "C" int smartbft_ecdsa_group() { return kGroup; }

// e, r, s, qx, qy: (n, 8) uint32 words; out: (n,) uint32.
// Returns cudaGetLastError().
extern "C" int smartbft_ecdsa_verify(const void* e, const void* r,
                                     const void* s, const void* qx,
                                     const void* qy, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  dim3 grid((n + kSigs - 1) / kSigs);
  ecdsa_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)e, (const uint32_t*)r, (const uint32_t*)s,
      (const uint32_t*)qx, (const uint32_t*)qy, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
