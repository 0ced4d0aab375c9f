// Static-key comb Ed25519 verify for Hopper (sm_90a).
//
// Replaces the TPU kernel smartbft_tpu/crypto/pallas_ed25519.py::_kernel
// (driven by eddsa_verify_comb): cofactorless [S]B + [h](-A) == R against
// registered replica keys, with Lim-Lee comb tables (8 teeth, stride 32)
// of the base point B and of each negated key -A; 32 x (one doubling + two
// unified additions) in extended coordinates, R's curve check, a
// projective match with a Z != 0 guard, and the host's ok mask (R decodes,
// S < L).
//
// What bounds it: a signature reads 136 bytes (S, h, R's coordinates, ok,
// key index) and writes 4, but its work is one chain of 96 dependent point
// operations, ~740 products of 8 x 32-bit words mod 2^255 - 19.  At the
// main path's batch sizes (128 to 2048 lanes: at most 128 blocks, one an
// SM) the chain's latency bounds a launch: 196 stages, each one product
// deep.  At 16384 lanes integer throughput does.  The tables (24 KB a key)
// stay in the 50 MB L2.
//
// Design: a group of ED_COMB_GROUP consecutive threads of a warp verifies
// one signature over the stage program of ed25519_comb_group.cuh: every
// point operation is 2 stages of at most 4 independent products, one a
// rank at G = 4, on the fold products of ed25519_group.cuh (plain form, so
// R needs no conversion), exchanged through the signature's shared block
// with __syncwarp(group mask) between stages; 196 stages in all.  The
// tables are read as stored: their Montgomery words are, as plain numbers,
// the extended point (x R : y R : R : x y R).  Each digit's two 96-byte
// entries are loaded, each rank its own words, in a stage before the one
// that reads them.  16 signatures a block, 836 bytes of shared memory
// each.  Signatures past n re-run the last one and store nothing, and a
// failing lane (ok = 0, a key index outside the stack) runs every stage on
// the base table and is masked at the end, so no thread leaves before a
// barrier.
#include <cuda_runtime.h>

#include "ed25519_comb_group.cuh"

// threads a signature; the library builds at 4, chip_smoke.py also times
// a build at 2 (csrc.VARIANTS)
#ifndef ED_COMB_GROUP
#define ED_COMB_GROUP 4
#endif

namespace {

constexpr int kGroup = ED_COMB_GROUP;
static_assert(kGroup == 2 || kGroup == 4, "ED_COMB_GROUP must be 2 or 4");
constexpr int kSigs = edc::kSigsPerBlock;
constexpr int kThreads = kSigs * kGroup;

__global__ void __launch_bounds__(kThreads)
ed_comb_verify_kernel(const uint32_t* __restrict__ s,
                      const uint32_t* __restrict__ h,
                      const uint32_t* __restrict__ rx,
                      const uint32_t* __restrict__ ry,
                      const int32_t* __restrict__ ok,
                      const int32_t* __restrict__ kidx,
                      const uint32_t* __restrict__ btab,
                      const uint32_t* __restrict__ qtab, int nkeys,
                      uint32_t* __restrict__ out, int n) {
  __shared__ edc::Shared sh[kSigs];
  const int rank = threadIdx.x % kGroup;
  const int loc = threadIdx.x / kGroup;
  const int sig = blockIdx.x * kSigs + loc;
  const int src = sig < n ? sig : n - 1;
  const size_t off = 8 * (size_t)src;
  const edc::In in = edc::lane_in(s + off, h + off, rx + off, ry + off,
                                  ok[src], kidx[src], btab, qtab, nkeys);
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << kGroup) - 1u)
                        << (lane & ~(unsigned)(kGroup - 1));
  uint32_t verdict = 0;
#pragma unroll 1
  for (int id = 0; id < edc::kStages; ++id) {
    verdict |= edc::stage<kGroup>(id, rank, sh[loc], in);
    __syncwarp(mask);
  }
  if (rank == 0 && sig < n) out[sig] = verdict;
}

}  // namespace

// threads per signature this library was built with
extern "C" int smartbft_ed_comb_group() { return kGroup; }

// s, h, rx, ry: (n, 8) uint32 words; ok, kidx: (n,) int32; btab: (256, 3,
// 8); qtab: (nkeys, 256, 3, 8); out: (n,) uint32.  Returns
// cudaGetLastError().
extern "C" int smartbft_ed_comb_verify(const void* s, const void* h,
                                       const void* rx, const void* ry,
                                       const void* ok, const void* kidx,
                                       const void* btab, const void* qtab,
                                       int nkeys, void* out, int n,
                                       void* stream) {
  if (n <= 0) return 0;
  dim3 grid((n + kSigs - 1) / kSigs);
  ed_comb_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)s, (const uint32_t*)h, (const uint32_t*)rx,
      (const uint32_t*)ry, (const int32_t*)ok, (const int32_t*)kidx,
      (const uint32_t*)btab, (const uint32_t*)qtab, nkeys, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
