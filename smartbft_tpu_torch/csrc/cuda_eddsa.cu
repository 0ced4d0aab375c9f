// Generic Ed25519 verify for Hopper (sm_90a), for keys outside the comb
// registry.
//
// Replaces the JAX package's XLA kernel
// smartbft_tpu/crypto/ed25519.py::eddsa_verify_kernel (with
// shamir_double_scalar), the route the JAX engine takes for every chunk
// that holds an unregistrable key: the S < L check, on-curve checks of R
// and A, a 16-entry joint table {iB + j(-A)} and 127 two-bit digits x (2
// doublings + 1 unified addition), then the projective comparison with R
// and the host's ok mask (R and A decode).
//
// What bounds it: a signature reads 196 bytes and writes 4, but needs
// ~3,200 products of 8 x 32-bit words mod 2^255 - 19, most of them in one
// chain of dependent point operations.  At the main path's batch sizes (a
// few hundred to a few thousand lanes) that chain's latency bounds the
// launch; at 16384 lanes integer issue does.
//
// Design: a group of EDDSA_GROUP consecutive threads of a warp verifies
// one signature, over the stage program of ed25519_group.cuh: every point
// operation is 2 stages of 4 independent products, one a rank at G = 4,
// exchanged through the signature's shared block with __syncwarp(group
// mask) between stages; 768 stages in all.  Products mod p are e_mul /
// e_sqr (a schoolbook product and a fold by 38, values in plain form, so
// the inputs need no conversion).  The prologue (curve checks, -2A, -3A,
// the joint table in cached form) runs on one code path on every rank.
// 16 signatures a block, 2,884 bytes of shared memory each.  Signatures
// past n re-run the last one and store nothing, and a lane that fails a
// check runs every stage and is masked at the end, so no thread leaves
// before a barrier.
#include <cuda_runtime.h>

#include "ed25519_group.cuh"

// threads a signature; the library builds at 4, chip_smoke.py also times
// a build at 2 (csrc.VARIANTS)
#ifndef EDDSA_GROUP
#define EDDSA_GROUP 4
#endif

namespace {

constexpr int kGroup = EDDSA_GROUP;
static_assert(kGroup == 2 || kGroup == 4, "EDDSA_GROUP must be 2 or 4");
constexpr int kSigs = edg::kSigsPerBlock;
constexpr int kThreads = kSigs * kGroup;

__global__ void __launch_bounds__(kThreads)
eddsa_verify_kernel(const uint32_t* __restrict__ s,
                    const uint32_t* __restrict__ h,
                    const uint32_t* __restrict__ rx,
                    const uint32_t* __restrict__ ry,
                    const uint32_t* __restrict__ ax,
                    const uint32_t* __restrict__ ay,
                    const int32_t* __restrict__ ok,
                    uint32_t* __restrict__ out, int n) {
  __shared__ edg::Shared sh[kSigs];
  const int rank = threadIdx.x % kGroup;
  const int loc = threadIdx.x / kGroup;
  const int sig = blockIdx.x * kSigs + loc;
  const int src = sig < n ? sig : n - 1;
  const size_t off = 8 * (size_t)src;
  const edg::In in{s + off,  h + off,  rx + off, ry + off,
                   ax + off, ay + off, ok[src]};
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << kGroup) - 1u)
                        << (lane & ~(unsigned)(kGroup - 1));
  uint32_t verdict = 0;
#pragma unroll 1
  for (int id = 0; id < edg::kStages; ++id) {
    verdict |= edg::stage<kGroup>(id, rank, sh[loc], in);
    __syncwarp(mask);
  }
  if (rank == 0 && sig < n) out[sig] = verdict;
}

}  // namespace

// threads per signature this library was built with
extern "C" int smartbft_eddsa_group() { return kGroup; }

// s, h, rx, ry, ax, ay: (n, 8) uint32 words; ok: (n,) int32; out: (n,)
// uint32.  Returns cudaGetLastError().
extern "C" int smartbft_eddsa_verify(const void* s, const void* h,
                                     const void* rx, const void* ry,
                                     const void* ax, const void* ay,
                                     const void* ok, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  dim3 grid((n + kSigs - 1) / kSigs);
  eddsa_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)s, (const uint32_t*)h, (const uint32_t*)rx,
      (const uint32_t*)ry, (const uint32_t*)ax, (const uint32_t*)ay,
      (const int32_t*)ok, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
