// BLS12-381 aggregate verify for Hopper (sm_90a): per lane, the pairing
// check e(sig, -g2) * e(H(m), pk) == 1, masked by the host's ok.
//
// Replaces the JAX package's XLA kernel
// smartbft_tpu/crypto/bls12381.py::bls_verify_kernel (_dev_miller_fused,
// _dev_final_exp, _dev_is_one), the device path of BASELINE configs[4]:
// one lane holds one signature or a whole aggregated quorum.
//
// What bounds it: a lane reads 388 bytes and writes 4, but needs 17,931
// products and 382 squarings mod the 381-bit p (crypto/cuda_bls.py::
// lane_ops), most of them in one dependent chain (the Miller loop's 63
// steps, then the final exponentiation's 316 cyclotomic squares and the
// Fermat inversion).  At the main path's batch sizes (a few hundred lanes)
// that chain's latency bounds a launch; at 16384 lanes integer issue and
// the shared memory that holds the lanes in flight do.
//
// Design: a group of BLS_GROUP consecutive threads of a warp verifies one
// lane, over the stage program of bls381_group.cuh (crypto/bls_stages.py):
// the Fp products of a stage are independent (an Fp12 square's 36 with the
// G2 doubling's first 9 and the fixed line's scaling, the fixed side's
// line product's 39 with the doubling's next 15, a cyclotomic square's
// 18, an Fp6 product's 18), so the ranks run them side by side and meet
// at __syncwarp(group mask); the Karatsuba pre-sums are formed in each
// product's operands, the recombinations are signed sums of slots.  The
// lane's state (the Fp12 accumulator, the G2 point, the lines and every
// intermediate, 150 slots of 48 bytes) lives in its slice of dynamic
// shared memory; only a job's operands are in registers.  The 12-word
// products are CIOS on PTX carry chains (bls381_field.cuh).  The program
// (about 207,000 words, 16 bytes a job) and the constant table (68 line rows
// at -g2 and the Frobenius gammas, 20,064 bytes) are read from global
// memory through the read-only cache (__ldg): the ranks of a group read
// different rows at once, which constant memory would serialise, and a
// copy into shared memory would take room the lanes need.  One warp a
// block, 32 / G lanes; a group leaves together when its lane is past n or
// has ok = 0 (storing 0), so every __syncwarp sees its whole group.  Built
// with -DBLS_MILLER_ONLY=1 the kernel stops after the Miller loop
// (chip_smoke.py times the split); that build is no verify.
#include <cuda_runtime.h>

// threads a lane; the library builds at 12, chip_smoke.py also times a
// build at 6 (csrc.VARIANTS)
#ifndef BLS_GROUP
#define BLS_GROUP 12
#endif
#ifndef BLS_MILLER_ONLY
#define BLS_MILLER_ONLY 0
#endif

#include "bls381_group.cuh"

namespace {

constexpr int kGroup = BLS_GROUP;
static_assert(kGroup >= 1 && kGroup <= 32, "BLS_GROUP must be 1 .. 32");
using Shape = b381g::Grid<kGroup>;

__global__ void __launch_bounds__(Shape::kThreads)
bls_verify_kernel(const uint32_t* __restrict__ sig_x,
                  const uint32_t* __restrict__ sig_y,
                  const uint32_t* __restrict__ hm_x,
                  const uint32_t* __restrict__ hm_y,
                  const uint32_t* __restrict__ pk_x0,
                  const uint32_t* __restrict__ pk_x1,
                  const uint32_t* __restrict__ pk_y0,
                  const uint32_t* __restrict__ pk_y1,
                  const int32_t* __restrict__ ok,
                  const uint32_t* __restrict__ prog,
                  const uint32_t* __restrict__ table,
                  uint32_t* __restrict__ out, int n, int stride) {
  extern __shared__ uint4 smem[];
  int loc, rank;
  if (!b381g::place<kGroup>(threadIdx.x, loc, rank)) return;
  const int i = blockIdx.x * Shape::kLanes + loc;
  if (i >= n) return;
  if (ok[i] == 0) {
    if (rank == 0) out[i] = 0;
    return;
  }
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) + (size_t)loc * stride;
  const unsigned mask = (unsigned)(((1ull << kGroup) - 1ull)
                                   << ((threadIdx.x & 31u) / kGroup * kGroup));
  const uint32_t* const in[8] = {sig_x, sig_y, hm_x,  hm_y,
                                 pk_x0, pk_x1, pk_y0, pk_y1};
  b381g::prologue<kGroup>(rank, S, in, (size_t)i);
  __syncwarp(mask);
  const int stages = (int)__ldg(prog + (BLS_MILLER_ONLY ? 3 : 0));
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    b381g::run_stage<kGroup>(prog, s, rank, S, table);
    __syncwarp(mask);
  }
  if (rank == 0)
    out[i] = b381g::is_one(prog, BLS_MILLER_ONLY ? 16 : 4, S);
}

}  // namespace

// threads a lane this library was built with
extern "C" int smartbft_bls_group() { return kGroup; }

// dynamic shared memory a block takes for a program of nslots slots
extern "C" int smartbft_bls_shared_bytes(int nslots) {
  return Shape::kLanes * b381g::lane_stride(nslots) * 4;
}

// sig_x .. pk_y1: (n, 12) uint32 words of Montgomery values; ok: (n,)
// int32; prog: the program words on the device (crypto/bls_stages.py),
// nslots its slot count; consts: the (418, 12) uint32 constant table on
// the device (crypto/cuda_bls.py::const_table); out: (n,) uint32.  Returns
// the first CUDA error of the launch.
extern "C" int smartbft_bls_verify(const void* sig_x, const void* sig_y,
                                   const void* hm_x, const void* hm_y,
                                   const void* pk_x0, const void* pk_x1,
                                   const void* pk_y0, const void* pk_y1,
                                   const void* ok, const void* prog,
                                   int nslots, const void* consts, void* out,
                                   int n, void* stream) {
  if (n <= 0) return 0;
  const int bytes = smartbft_bls_shared_bytes(nslots);
  cudaError_t err = cudaFuncSetAttribute(
      bls_verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + Shape::kLanes - 1) / Shape::kLanes);
  bls_verify_kernel<<<grid, Shape::kThreads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)sig_x, (const uint32_t*)sig_y, (const uint32_t*)hm_x,
      (const uint32_t*)hm_y, (const uint32_t*)pk_x0, (const uint32_t*)pk_x1,
      (const uint32_t*)pk_y0, (const uint32_t*)pk_y1, (const int32_t*)ok,
      (const uint32_t*)prog, (const uint32_t*)consts, (uint32_t*)out, n,
      b381g::lane_stride(nslots));
  return (int)cudaGetLastError();
}
