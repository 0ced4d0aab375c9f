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
// What bounds it: integer multiply throughput.  A signature reads 196 bytes
// and writes 4, but runs about 2,330 Montgomery products and 1,020
// squarings mod p of 8 x 32-bit words.
//
// Design, simple first: one thread per signature, 128 threads a block,
// grid ceil(B / 128), the ragged edge masked; the joint table is built per
// thread into local memory (16 x 128 bytes) and read with a direct index.
#include <cuda_runtime.h>

#include "ed25519_field.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
eddsa_verify_kernel(const uint32_t* __restrict__ s,
                    const uint32_t* __restrict__ h,
                    const uint32_t* __restrict__ rx,
                    const uint32_t* __restrict__ ry,
                    const uint32_t* __restrict__ ax,
                    const uint32_t* __restrict__ ay,
                    const int32_t* __restrict__ ok,
                    uint32_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t off = (size_t)i * 8;
  out[i] = ed25519::eddsa_verify_lane(s + off, h + off, rx + off, ry + off,
                                      ax + off, ay + off, ok[i]);
}

}  // namespace

// s, h, rx, ry, ax, ay: (n, 8) uint32 words; ok: (n,) int32; out: (n,)
// uint32.  Returns cudaGetLastError().
extern "C" int smartbft_eddsa_verify(const void* s, const void* h,
                                     const void* rx, const void* ry,
                                     const void* ax, const void* ay,
                                     const void* ok, void* out, int n,
                                     void* stream) {
  if (n <= 0) return 0;
  dim3 grid((n + kThreads - 1) / kThreads);
  eddsa_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)s, (const uint32_t*)h, (const uint32_t*)rx,
      (const uint32_t*)ry, (const uint32_t*)ax, (const uint32_t*)ay,
      (const int32_t*)ok, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
