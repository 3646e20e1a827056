// K3: one whole blind-rotation step in one kernel, row-major layout, for
// Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_step.py, fused_rotate_step and its
// kernel body _step_kernel (the Pallas TPU kernel of blind_rotate_tpu's
// opt-in fused step, blindrotate.FUSED_STEP).
//
// Computes, for the accumulator acc (2, B, N) (uint32 words, channel-major,
// coefficients contiguous), the amounts a[b] in [0, 2N] (2N is the
// identity) and one LWE bit's band (2, 2L, 2N) (the port's one band
// layout, ops/cuda_t.py pack_bsk_band_t, the TPU's dropped low key limbs
// subtracted at packing time):
//   tmp[c, b, j]  = X^a[b] * acc[c, b, :] at j  - acc[c, b, j] + offset
//   d[b, r, j]    = ((tmp[c, b, j] >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,
//                   r = c*L + lv
//   out[c, b, n]  = acc[c, b, n] + sum_{r, j} d[b, r, j] * band[c, r, N+n-j]
// mod 2^32: K7 at bs = 1 followed by K8 with the accumulator fused
// (csrc/rotdec.cu, csrc/extprod.cu), int8-size digits only (one limb).
//
// What bounds it on this card: the external product's integer multiply-
// adds on the CUDA cores, as in K8 (2 * B * N * 2L * N wrapping IMADs; at
// 128bit_fast, B 4096: 34.4 G).  What the TPU kernel keeps out of device
// memory is the digits, and the fusion saves one launch per step; this
// kernel keeps both.  It is K8's kernel (the 64 (n) x 128 (b) output tile,
// 8 x 4 registers per thread, the 95-word band window) with the digit
// staging replaced by the rotation: per input channel and 32-deep j chunk
// a thread reads 4 consecutive j of 4 ciphertexts (one 16-byte load of the
// unrotated words, four gathers of their rotation sources, which a warp
// reads as consecutive words with one wrap at most), keeps the 16
// differences in registers and, per level, writes their digits into the
// b-contiguous shared chunk K8 stages (rows padded to 132 words).  The
// TPU's whole-step resident Toeplitz (~25 MB) has no place in 227 KB of
// shared memory, so the fusion is kept and the residency is not; the
// digits are recomputed by each of the 2 * N/64 blocks that read a batch
// tile (from L2: 32 KB per block and chunk, against K8's 4 KB of digits),
// where the TPU kernel held a tile's digits in VMEM for all of them.
// The output is written out of place: every block reads whole rows of acc
// for its rotations, and other blocks write the same rows.  Ragged B is
// masked per row (a row's result reads only its own digits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;    // output coefficients per block
constexpr int TB = 128;   // ciphertexts per block
constexpr int TJ = 32;    // contraction depth per shared-memory stage
constexpr int RN = 8;     // coefficients per thread
constexpr int RB = 4;     // ciphertexts per thread
constexpr int kThreads = (TN / RN) * (TB / RB);     // 256
constexpr int DS = TB + 4;                          // digit chunk row, words
constexpr int OS = TN + 1;                          // output tile row, words
constexpr int kSmem = (TJ * DS > TB * OS) ? TJ * DS : TB * OS;

static_assert(kThreads == (TB / 4) * (TJ / 4), "one 4x4 digit block each");

// Block shape (TB / RB, TN / RN); grid (ceil(B/TB), N/TN, 2 channels).
__global__ void __launch_bounds__(kThreads)
step_kernel(const uint32_t* __restrict__ acc,
            const int32_t* __restrict__ amounts,
            const int32_t* __restrict__ band, uint32_t* __restrict__ out,
            int n, int b, int l, int bgbit, uint32_t offset) {
  __shared__ __align__(16) int32_t smem[kSmem];
  __shared__ int32_t win_s[TN + TJ];
  const int c = blockIdx.z;
  const int n0 = blockIdx.y * TN;
  const int b0 = blockIdx.x * TB;
  const int tx = threadIdx.x;            // 0..31: ciphertexts tx*RB ..
  const int ty = threadIdx.y;            // 0..7:  coefficients ty*RN ..
  const int tid = ty * blockDim.x + tx;
  const size_t plane = (size_t)b * n;                 // one channel of acc
  const int32_t* band_c = band + (size_t)c * 2 * l * 2 * n;
  const uint32_t mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);

  // Staging role: jq picks 4 consecutive j of a chunk, g the rows 4g..4g+3
  // (K8's stage_digits mapping).  Each row's rotation: r = a mod N, and
  // the wrapped words are negated unless a >= N flips that.
  const int lane = tid & 31;
  const int jq = lane >> 2;
  const int g = ((tid >> 5) << 2) + (lane & 3);
  int rot_r[4];
  bool flip[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int bg = b0 + 4 * g + q;
    int k2 = 0;
    if (bg < b) {
      k2 = amounts[bg] % (2 * n);
      if (k2 < 0) k2 += 2 * n;
    }
    rot_r[q] = k2 % n;
    flip[q] = k2 >= n;
  }

  uint32_t sum[RN][RB];
#pragma unroll
  for (int k = 0; k < RN; ++k)
#pragma unroll
    for (int q = 0; q < RB; ++q) sum[k][q] = 0u;

  for (int ci = 0; ci < 2; ++ci) {
    const uint32_t* acc_ci = acc + (size_t)ci * plane;
    for (int j0 = 0; j0 < n; j0 += TJ) {
      // The 4 x 4 differences of this thread, kept across the l levels.
      const int j = j0 + 4 * jq;
      uint32_t tmp[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int bg = b0 + 4 * g + q;
        if (bg < b) {
          const uint32_t* row = acc_ci + (size_t)bg * n;
          const uint4 x0 = *reinterpret_cast<const uint4*>(row + j);
          const uint32_t xs[4] = {x0.x, x0.y, x0.z, x0.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int src = j + e - rot_r[q];
            const bool wrapped = src < 0;
            if (wrapped) src += n;
            uint32_t xr = row[src];
            if (wrapped != flip[q]) xr = ~xr;
            tmp[q][e] = xr - xs[e] + offset;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[q][e] = 0u;
        }
      }
      for (int lv = 0; lv < l; ++lv) {
        const int sh = 32 - (lv + 1) * bgbit;
        const int32_t* brow = band_c + (size_t)(ci * l + lv) * 2 * n;
        // window start >= N + 0 - (N - TJ) - (TJ - 1) = 1, end <= 2N - 1
        const int w0 = n + n0 - j0 - (TJ - 1);
        for (int t = tid; t < TN + TJ - 1; t += kThreads)
          win_s[t] = brow[w0 + t];
        int32_t d[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[q][e] = (int32_t)((tmp[q][e] >> sh) & mask) - half_bg;
        int32_t* dst = smem + (4 * jq) * DS + 4 * g;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<int4*>(dst + e * DS) =
              make_int4(d[0][e], d[1][e], d[2][e], d[3][e]);
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) {
          const int4 dv = *reinterpret_cast<const int4*>(&smem[jj * DS + tx * RB]);
#pragma unroll
          for (int k = 0; k < RN; ++k) {
            const uint32_t w = (uint32_t)win_s[ty * RN + k + (TJ - 1) - jj];
            sum[k][0] += w * (uint32_t)dv.x;
            sum[k][1] += w * (uint32_t)dv.y;
            sum[k][2] += w * (uint32_t)dv.z;
            sum[k][3] += w * (uint32_t)dv.w;
          }
        }
        __syncthreads();
      }
    }
  }

  // Epilogue: the tile through shared memory, then acc + tile along n.
#pragma unroll
  for (int q = 0; q < RB; ++q)
#pragma unroll
    for (int k = 0; k < RN; ++k)
      smem[(tx * RB + q) * OS + ty * RN + k] = (int32_t)sum[k][q];
  __syncthreads();
  const size_t chan = (size_t)c * plane;
  for (int e = tid; e < TB * TN; e += kThreads) {
    const int bb = e / TN;
    const int nn = e % TN;
    const int bg = b0 + bb;
    if (bg < b) {
      const size_t idx = chan + (size_t)bg * n + n0 + nn;
      out[idx] = acc[idx] + (uint32_t)smem[bb * OS + nn];
    }
  }
}

}  // namespace

// acc and out (2, B, N) uint32 (distinct buffers, acc 16-byte aligned),
// amounts (B,) int32, band (2, 2l, 2N) int32; N a multiple of TN,
// 1 <= bgbit <= 8.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tfhe_fused_step(const void* acc, const void* amounts,
                               const void* band, void* out, int n, int b,
                               int l, int bgbit, unsigned int offset,
                               void* stream) {
  if (b == 0) return 0;
  dim3 block(TB / RB, TN / RN);
  dim3 grid((b + TB - 1) / TB, n / TN, 2);
  step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)amounts, (const int32_t*)band,
      (uint32_t*)out, n, b, l, bgbit, (uint32_t)offset);
  return (int)cudaGetLastError();
}
