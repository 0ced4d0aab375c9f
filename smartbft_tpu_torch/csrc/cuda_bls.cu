// BLS12-381 aggregate verify for Hopper (sm_90a): per lane, the pairing
// check e(sig, -g2) * e(H(m), pk) == 1, masked by the host's ok.
//
// Replaces the JAX package's XLA kernel
// smartbft_tpu/crypto/bls12381.py::bls_verify_kernel (_dev_miller_fused,
// _dev_final_exp, _dev_is_one), the device path of BASELINE configs[4]:
// one lane holds one signature or a whole aggregated quorum.
//
// What bounds it: a lane reads 388 bytes and writes 4, but needs ~24,000
// products mod the 381-bit p (crypto/cuda_bls.py::lane_ops), nearly all
// in one chain: the Miller loop's 63 steps of squaring and line products,
// then the final exponentiation's ~320 Fp12 squarings.  At the main
// path's batch sizes (a few to a few hundred lanes) the chain's latency
// bounds the launch, and at 16384 lanes integer issue does.
//
// Design, a first kernel: one thread a lane, 32 lanes a block so a small
// batch spreads over the SMs.  The arithmetic is bls381_pairing.cuh over
// bls381_field.cuh (12-word CIOS Montgomery products in portable C++,
// values fully reduced, Fp12 in local memory).  The fixed side's 68 line
// rows and the Frobenius gammas (20,064 bytes) are copied into __constant__
// memory before each launch: every lane reads the same row at the same
// step, which the constant cache broadcasts.  The loop bits are
// constants, so no lane diverges; a lane with ok = 0 stores 0 and leaves.
#include <cuda_runtime.h>

#include "bls381_pairing.cuh"

namespace {

constexpr int kThreads = 32;

__constant__ b381::Consts c_consts;

__global__ void __launch_bounds__(kThreads)
bls_verify_kernel(const uint32_t* __restrict__ sig_x,
                  const uint32_t* __restrict__ sig_y,
                  const uint32_t* __restrict__ hm_x,
                  const uint32_t* __restrict__ hm_y,
                  const uint32_t* __restrict__ pk_x0,
                  const uint32_t* __restrict__ pk_x1,
                  const uint32_t* __restrict__ pk_y0,
                  const uint32_t* __restrict__ pk_y1,
                  const int32_t* __restrict__ ok,
                  uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (ok[i] == 0) {
    out[i] = 0;
    return;
  }
  const size_t off = (size_t)b381::kWords * i;
  const b381::Fp2 qx{b381::load_fp(pk_x0 + off), b381::load_fp(pk_x1 + off)};
  const b381::Fp2 qy{b381::load_fp(pk_y0 + off), b381::load_fp(pk_y1 + off)};
  out[i] = b381::verify_lane(c_consts, b381::load_fp(sig_x + off),
                             b381::load_fp(sig_y + off),
                             b381::load_fp(hm_x + off),
                             b381::load_fp(hm_y + off), qx, qy);
}

}  // namespace

// sig_x .. pk_y1: (n, 12) uint32 words of Montgomery values; ok: (n,)
// int32; consts: the (418, 12) uint32 constant table on the device
// (crypto/cuda_bls.py::const_table); out: (n,) uint32.  Returns the first
// CUDA error of the table copy or the launch.
extern "C" int smartbft_bls_verify(const void* sig_x, const void* sig_y,
                                   const void* hm_x, const void* hm_y,
                                   const void* pk_x0, const void* pk_x1,
                                   const void* pk_y0, const void* pk_y1,
                                   const void* ok, const void* consts,
                                   void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_consts, consts, sizeof(b381::Consts), 0, cudaMemcpyDeviceToDevice,
      st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kThreads - 1) / kThreads);
  bls_verify_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)sig_x, (const uint32_t*)sig_y, (const uint32_t*)hm_x,
      (const uint32_t*)hm_y, (const uint32_t*)pk_x0, (const uint32_t*)pk_x1,
      (const uint32_t*)pk_y0, (const uint32_t*)pk_y1, (const int32_t*)ok,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
