// K1: rotate + gadget-decompose, transposed layout, for Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_t.py, rotate_decompose_t and its kernel
// body _rotdec_t_kernel (the Pallas TPU kernel of the blind-rotation step).
//
// Computes, for every coefficient n and ciphertext b of the accumulator
// acc (2, N, B) (uint32 words, coefficient-major, batch fastest):
//   rot  = X^a[b] * acc[c, :, b]   (negacyclic, wrapped coefficients NOT-
//                                   negated: ~x, the reference's ^Torus(0)-x)
//   tmp  = rot - acc + offset      (wrapping mod 2^32)
//   d_lv = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,  lv < l
// and writes int8 digits to out (ND*2L*N, B), limb-major rows
// [(i, c, lv)] * N + n; for bgbit > 8 each digit splits into nd exact
// signed base-256 limbs (pallas_t.py:105-114 arithmetic).
//
// What bounds it on this card: memory.  Per (n, b) it reads 16 bytes (the
// coefficient and its rotation source, two channels) and writes 2L*ND
// bytes; there is no reuse to exploit, so the kernel is a single pass.
// The rotation is computed directly (k2 = a mod 2N, r = k2 mod N,
// src = (n - r) mod N, negate when (n < r) xor (k2 >= N)) instead of the
// TPU's composition of log2(2N) static rolls: a gather costs one load
// here, where on the TPU dynamic per-lane gathers were the slow path.
// One thread serves one (n, b) and both channels; threads of a warp run
// over consecutive b, so acc[c, n, b] reads and the int8 stores coalesce.
// The source row differs per ciphertext, so the acc[c, src, b] reads do
// not coalesce: a later kernel can stage tiles of acc in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rotdec_t_kernel(const uint32_t* __restrict__ acc,
                const int32_t* __restrict__ amounts,
                int8_t* __restrict__ out, int n, int b, int l, int bgbit,
                uint32_t offset, int nd) {
  const int bi = blockIdx.x * kThreads + threadIdx.x;
  const int ni = blockIdx.y;
  if (bi >= b) return;
  int k2 = amounts[bi] % (2 * n);
  if (k2 < 0) k2 += 2 * n;
  const int r = k2 % n;
  int src = ni - r;
  const bool wrapped = src < 0;
  if (wrapped) src += n;
  const bool neg = wrapped != (k2 >= n);
  const size_t plane = (size_t)n * b;
  const uint32_t mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);
  for (int c = 0; c < 2; ++c) {
    const uint32_t x0 = acc[c * plane + (size_t)ni * b + bi];
    uint32_t xr = acc[c * plane + (size_t)src * b + bi];
    if (neg) xr = ~xr;
    const uint32_t tmp = xr - x0 + offset;
    for (int lv = 0; lv < l; ++lv) {
      const int sh = 32 - (lv + 1) * bgbit;
      int32_t d = (int32_t)((tmp >> sh) & mask) - half_bg;
      for (int i = 0; i < nd; ++i) {
        int32_t limb = d;
        if (i < nd - 1) {                 // exact signed base-256 split
          limb = ((d + 128) & 255) - 128;
          d = (d - limb) >> 8;            // arithmetic shift, exact
        }
        const size_t row = (size_t)(i * 2 * l + c * l + lv) * n + ni;
        out[row * b + bi] = (int8_t)limb;
      }
    }
  }
}

}  // namespace

// acc (2, N, B) uint32, amounts (B,) int32, out (nd*2L*N, B) int8; all on
// the current device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tfhe_rotdec_t(const void* acc, const void* amounts, void* out,
                             int n, int b, int l, int bgbit,
                             unsigned int offset, int nd, void* stream) {
  dim3 grid((b + kThreads - 1) / kThreads, n);
  rotdec_t_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)amounts, (int8_t*)out, n, b, l,
      bgbit, (uint32_t)offset, nd);
  return (int)cudaGetLastError();
}
