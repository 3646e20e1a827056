// K4: rotate + gadget-decompose of the interleaved big accumulator, for
// extended look-up tables, transposed layout, for Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_t.py, rotate_decompose_ext_t and its
// kernel body _rotdec_ext_t_kernel (the Pallas TPU kernel of the
// extended-LUT blind-rotation step, uint6/uint7).
//
// The big polynomial (degree k*N) is stored as k blocks of N coefficients,
// big[j] == block[j % k][j // k]; acc (2, k*N, B) holds block r in rows
// [rN, (r+1)N) of each channel (uint32 words, batch fastest).  For every
// output block r', coefficient n and ciphertext b, with t = amount mod 2kN:
//   r   = (r' - t) mod k,   q = (t + r - r') / k     (exact, 0 <= q <= 2N)
//   rot = Y^q * block[r] at n   (Y = X^k; negacyclic in N, wrapped
//                                coefficients NOT-negated: ~x)
//   tmp = rot - block[r'][n] + offset                (wrapping mod 2^32)
//   d_lv = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,  lv < l
// and writes int8 digits to out (k*ND*2L*N, B), block-major rows
// ((r'*ND + i)*2L + c*l + lv)*N + n; for bgbit > 8 each digit splits into
// nd exact signed base-256 limbs (uint6/uint7: bgbit 22, l 1, nd 3).
// t = 2kN is the identity (mod_switch_general can return 2kN).
//
// What bounds it on this card: memory, as K1.  Per ciphertext at uint6
// (N 2048, k 2) it reads 2 * 2 * 4096 words (each coefficient and its
// rotation source, two channels) and writes 24,576 int8 digits; at uint7
// (k 4) both double.  The TPU kernel composes log2(2kN) static block
// rolls, because per-lane gathers are slow there; here one thread serves
// one (output row, ciphertext) pair and both channels, and computes its
// source row directly: one gather load each.  Threads of a warp run over
// consecutive b, so the unrotated reads and the int8 stores coalesce; the
// source row differs per ciphertext, so the rotated reads do not (as in
// K1; staging tiles in shared memory is later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rotdec_ext_t_kernel(const uint32_t* __restrict__ acc,
                    const int32_t* __restrict__ amounts,
                    int8_t* __restrict__ out, int n, int k, int b, int l,
                    int bgbit, uint32_t offset, int nd) {
  const int bi = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;              // r' * N + n, in [0, kN)
  if (bi >= b) return;
  const int rp = row / n;
  const int ni = row - rp * n;
  const int big = 2 * k * n;
  int t = amounts[bi] % big;
  if (t < 0) t += big;
  int r = (rp - t) % k;
  if (r < 0) r += k;
  int q = (t + r - rp) / k;                // exact, in [0, 2N]
  if (q >= 2 * n) q -= 2 * n;
  const int rr = q % n;
  int src = ni - rr;
  const bool wrapped = src < 0;
  if (wrapped) src += n;
  const bool neg = wrapped != (q >= n);
  const size_t plane = (size_t)k * n * b;
  const size_t src_row = (size_t)r * n + src;
  const uint32_t mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);
  for (int c = 0; c < 2; ++c) {
    const uint32_t x0 = acc[c * plane + (size_t)row * b + bi];
    uint32_t xr = acc[c * plane + src_row * b + bi];
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
        const size_t orow =
            ((size_t)(rp * nd + i) * 2 * l + c * l + lv) * n + ni;
        out[orow * b + bi] = (int8_t)limb;
      }
    }
  }
}

}  // namespace

// acc (2, k*N, B) uint32, amounts (B,) int32, out (k*nd*2L*N, B) int8; all
// on the current device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tfhe_rotdec_ext_t(const void* acc, const void* amounts,
                                 void* out, int n, int k, int b, int l,
                                 int bgbit, unsigned int offset, int nd,
                                 void* stream) {
  dim3 grid((b + kThreads - 1) / kThreads, k * n);
  rotdec_ext_t_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)amounts, (int8_t*)out, n, k, b, l,
      bgbit, (uint32_t)offset, nd);
  return (int)cudaGetLastError();
}
