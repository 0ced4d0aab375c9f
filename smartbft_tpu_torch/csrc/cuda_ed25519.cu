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
// What bounds it: integer multiply throughput.  A signature reads 136 bytes
// (S, h, R's coordinates, ok, key index) and writes 4, but runs 710
// Montgomery products and 130 squarings mod p = 2^255 - 19 of 8 x 32-bit
// words.  The tables (24 KB per key: 256 affine entries x (X, Y, T) x 8
// words; 1.6 MB for 64 keys plus B) stay resident in the 50 MB L2.
//
// Design, simple first: one thread per signature, 128 threads a block,
// grid ceil(B / 128), the ragged edge masked.  The TPU kernel's one-hot
// matmul select over split-byte bf16 rows becomes a direct load
// btab[digit] / qtab[kidx][digit].  No inversion: unlike P-256 the lane is
// the comb walk alone.
#include <cuda_runtime.h>

#include "ed25519_field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kEntryWords = 256 * 24;  // one key's table: 256 x (X, Y, T)

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
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int k = kidx[i];
  const uint32_t* q =
      (k >= 0 && k < nkeys) ? qtab + (size_t)k * kEntryWords : nullptr;
  size_t off = (size_t)i * 8;
  out[i] = ed25519::comb_verify_lane(s + off, h + off, rx + off, ry + off,
                                     ok[i], btab, q);
}

}  // namespace

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
  dim3 grid((n + kThreads - 1) / kThreads);
  ed_comb_verify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)s, (const uint32_t*)h, (const uint32_t*)rx,
      (const uint32_t*)ry, (const int32_t*)ok, (const int32_t*)kidx,
      (const uint32_t*)btab, (const uint32_t*)qtab, nkeys, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
