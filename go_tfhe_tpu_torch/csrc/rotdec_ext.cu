// K6: rotate + gadget-decompose of the interleaved big accumulator, for
// extended look-up tables, row-major layout, for Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_ext.py, rotate_decompose_ext_pallas and
// its kernel body _rotdec_ext_kernel (the Pallas TPU kernel of the row-major
// extended-LUT blind rotation, which the JAX package runs for uint8's k = 9).
//
// The big polynomial (degree k*N) is stored as k blocks of N coefficients,
// big[j] == block[j % k][j // k]; acc (2, B, k*N) holds block r in columns
// [rN, (r+1)N) of each ciphertext's row (uint32 words).  For every
// ciphertext b, output block r', coefficient n and channel c, with
// t = amount mod 2kN:
//   r   = (r' - t) mod k,   q = (t + r - r') / k     (exact, 0 <= q <= 2N)
//   rot = Y^q * block[r] at n   (Y = X^k; negacyclic in N, wrapped
//                                coefficients NOT-negated: ~x)
//   tmp = rot - block[r'][n] + offset                (wrapping mod 2^32)
//   d_lv = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,  lv < l
// and writes int8 digits to out (B, k*ND*2L*N), block-major, then limb,
// channel, level: column (r'*ND*2L + i*2L + c*L + lv)*N + n
// (pallas_ext.py:111), so out.reshape(B*k, ND*2L*N) is K8's digit input
// with the blocks folded into the batch.  t = 2kN is the identity
// (mod_switch_general can return 2kN).
//
// What bounds it on this card: memory.  At uint8 (N 2048, k 9, nd 3) a
// ciphertext reads 2 * 2 * 18432 words (each coefficient and its rotation
// source, two channels) and writes 110,592 int8 digits.  The TPU composes
// log2(2kN) rounds of static block rolls, because per-lane gathers are slow
// there; here one thread per (ciphertext, output coefficient) computes its
// source directly, as K4 does.  The threads of a warp run over consecutive
// n of one output block of one ciphertext; they share t, so r and q are
// the same across the warp and the source coefficients are consecutive:
// the unrotated and rotated reads and the int8 stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rotdec_ext_kernel(const uint32_t* __restrict__ acc,
                  const int32_t* __restrict__ amounts,
                  int8_t* __restrict__ out, int n, int k, int b, int l,
                  int bgbit, uint32_t offset, int nd) {
  const int bi = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;   // r' * N + n
  if (col >= k * n) return;
  const int rp = col / n;
  const int ni = col - rp * n;
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
  const size_t kn = (size_t)k * n;
  const size_t plane = (size_t)b * kn;
  const size_t row = (size_t)bi * kn;
  const size_t src_col = (size_t)r * n + src;
  const uint32_t mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);
  const int l2 = 2 * l;
  int8_t* out_b = out + (size_t)bi * k * nd * l2 * n;
  for (int c = 0; c < 2; ++c) {
    const uint32_t x0 = acc[c * plane + row + col];
    uint32_t xr = acc[c * plane + row + src_col];
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
        const size_t ocol =
            ((size_t)(rp * nd + i) * l2 + c * l + lv) * n + ni;
        out_b[ocol] = (int8_t)limb;
      }
    }
  }
}

}  // namespace

// acc (2, B, k*N) uint32, amounts (B,) int32, out (B, k*nd*2L*N) int8; all
// on the current device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tfhe_rotdec_ext(const void* acc, const void* amounts,
                               void* out, int n, int k, int b, int l,
                               int bgbit, unsigned int offset, int nd,
                               void* stream) {
  dim3 grid(b, (k * n + kThreads - 1) / kThreads);
  rotdec_ext_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)amounts, (int8_t*)out, n, k, b, l,
      bgbit, (uint32_t)offset, nd);
  return (int)cudaGetLastError();
}
