// K7: rotate + gadget-decompose, row-major layout, with a block count, for
// Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_rotate.py, rotate_decompose_pallas and
// its kernel body _rotdec_kernel (the Pallas TPU kernel of the block blind
// rotation's step and of its per-bit tail).
//
// The accumulator acc (2, B, N) holds uint32 words, ciphertext-major with
// coefficients contiguous.  For every ciphertext b, block bit j < bs,
// channel c and coefficient n, with a = amounts[j, b] mod 2N:
//   rot  = X^a * acc[c, b, :] at n  (negacyclic, wrapped coefficients NOT-
//                                    negated: ~x, the reference's ^Torus(0)-x)
//   tmp  = rot - acc[c, b, n] + offset             (wrapping mod 2^32)
//   d_lv = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,  lv < l
// and writes int8 digits to out (B, ND*bs*2L*N), limb-major, then block
// bit, channel, level: column (i*bs*2L + (j*2 + c)*L + lv)*N + n
// (pallas_rotate.py:93); for bgbit > 8 each digit splits into nd exact
// signed base-256 limbs.  a = 2N is the identity.
//
// What bounds it on this card: memory.  Per (b, n) it reads the
// coefficient and, per block bit, its rotation source, in both channels,
// and writes ND*bs*2L bytes; there is no reuse beyond the unrotated
// coefficient, which a thread keeps in registers across the bs block bits.
// The TPU composes log2(2N) static lane rolls per block bit, because
// per-lane gathers are slow there; here one thread per (b, n) computes its
// source directly (r = a mod N, src = (n - r) mod N, negate when
// (n < r) xor (a >= N)).  In this layout the threads of a warp run over
// consecutive n of one ciphertext, which share the rotation amount: the
// unrotated reads, the rotated reads (consecutive sources, one wrap at
// most) and the int8 stores all coalesce, unlike K1's transposed layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rotdec_kernel(const uint32_t* __restrict__ acc,
              const int32_t* __restrict__ amounts, int8_t* __restrict__ out,
              int n, int b, int bs, int l, int bgbit, uint32_t offset,
              int nd) {
  const int bi = blockIdx.x;
  const int ni = blockIdx.y * kThreads + threadIdx.x;
  if (ni >= n) return;
  const size_t plane = (size_t)b * n;
  const size_t row = (size_t)bi * n;
  const uint32_t mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);
  const int rows = bs * 2 * l;                  // digit rows per limb plane
  int8_t* out_b = out + (size_t)bi * nd * rows * n;
  uint32_t x0[2];
  for (int c = 0; c < 2; ++c) x0[c] = acc[c * plane + row + ni];
  for (int j = 0; j < bs; ++j) {
    int k2 = amounts[(size_t)j * b + bi] % (2 * n);
    if (k2 < 0) k2 += 2 * n;
    const int r = k2 % n;
    int src = ni - r;
    const bool wrapped = src < 0;
    if (wrapped) src += n;
    const bool neg = wrapped != (k2 >= n);
    for (int c = 0; c < 2; ++c) {
      uint32_t xr = acc[c * plane + row + src];
      if (neg) xr = ~xr;
      const uint32_t tmp = xr - x0[c] + offset;
      for (int lv = 0; lv < l; ++lv) {
        const int sh = 32 - (lv + 1) * bgbit;
        int32_t d = (int32_t)((tmp >> sh) & mask) - half_bg;
        for (int i = 0; i < nd; ++i) {
          int32_t limb = d;
          if (i < nd - 1) {                 // exact signed base-256 split
            limb = ((d + 128) & 255) - 128;
            d = (d - limb) >> 8;            // arithmetic shift, exact
          }
          const size_t col = (size_t)(i * rows + (j * 2 + c) * l + lv) * n + ni;
          out_b[col] = (int8_t)limb;
        }
      }
    }
  }
}

}  // namespace

// acc (2, B, N) uint32, amounts (bs, B) int32, out (B, nd*bs*2L*N) int8;
// all on the current device.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tfhe_rotdec(const void* acc, const void* amounts, void* out,
                           int n, int b, int bs, int l, int bgbit,
                           unsigned int offset, int nd, void* stream) {
  dim3 grid(b, (n + kThreads - 1) / kThreads);
  rotdec_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)amounts, (int8_t*)out, n, b, bs,
      l, bgbit, (uint32_t)offset, nd);
  return (int)cudaGetLastError();
}
