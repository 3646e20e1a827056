// K2: external product, transposed layout, for Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_t.py, extprod_t and its kernel body
// _extprod_t_kernel (the Pallas TPU kernel of the blind-rotation step).
//
// Computes, per output channel c, a GEMM with an implicit Toeplitz operand:
//   out[c][n, b] = acc[c][n, b] + sum_{r < 2L, j < N} band[c, r, N+n-j] * d[r, j, b]
// mod 2^32, where band[c, r] = D'[r, c] (ops/cuda_t.py, pack_bsk_band_t):
// D = concat(-K, K) of BSK row r, channel c, with the dropped low key limbs
// already subtracted at packing time, and d[r, j, b] = sum_i limb_i * 256^i
// recombines the int8 digit limbs (ND*2L*N, B), limb-major rows
// [(i, r)] * N + j.  One wrapping 32-bit multiply-add per term computes
// exactly what the TPU kernel's int8 limb-pair dots compute: pairs of
// weight >= 2^32 are multiples of 2^32 and vanish mod 2^32 by themselves.
//
// What bounds it on this card: integer multiply-adds on the CUDA cores.
// At 128bit_fast (N = 1024, 2L = 4) one step of a 4096-ciphertext batch is
// 2 * 1024 * 4096 * 4096 = 34 G wrapping IMADs; the operands are small
// (digits 16 MB, band 32 KB) and stay in L2.  The design keeps the IMAD
// pipes fed from registers: a 256-thread block owns a 64 (n) x 128 (b)
// output tile and each thread an 8 x 4 register tile.  The Toeplitz matrix
// is never stored: per (r, 32-deep j chunk) the block stages the band
// window band[c, r, N+n0-j0-31 .. N+n0+63-j0] (95 words) and the chunk of
// recombined digits (32 x 128 words) in shared memory, and reads
// T[n, j] = window[(n - n0) + 31 - (j - j0)].  The 32 threads of a warp
// share n (window reads broadcast) and cover 128 consecutive b (one
// conflict-free 16-byte digit read each).  Per 32 IMADs a thread issues
// one 16-byte and at most eight 4-byte shared-memory reads.  The s8 tensor
// cores (mma.sync / wgmma) offer over ten times the CUDA cores' rate for
// this product; using them is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;    // output coefficients per block
constexpr int TB = 128;   // ciphertexts per block
constexpr int TJ = 32;    // contraction depth per shared-memory stage
constexpr int RN = 8;     // coefficients per thread
constexpr int RB = 4;     // ciphertexts per thread
constexpr int kThreads = (TN / RN) * (TB / RB);   // 256

__global__ void __launch_bounds__(kThreads)
extprod_t_kernel(const int8_t* __restrict__ digits,
                 const int32_t* __restrict__ band,
                 const uint32_t* __restrict__ acc,
                 uint32_t* __restrict__ out, int n, int b, int l2, int nd) {
  __shared__ __align__(16) int32_t dig_s[TJ][TB];
  __shared__ int32_t win_s[TN + TJ];
  const int tx = threadIdx.x;            // 0..31: ciphertexts tx*RB ..
  const int ty = threadIdx.y;            // 0..7:  coefficients ty*RN ..
  const int tid = ty * blockDim.x + tx;
  const int b0 = blockIdx.x * TB;
  const int n0 = blockIdx.y * TN;
  const int c = blockIdx.z;
  const size_t plane_rows = (size_t)l2 * n;          // rows per limb plane
  const int32_t* band_c = band + (size_t)c * l2 * 2 * n;

  uint32_t sum[RN][RB];
#pragma unroll
  for (int k = 0; k < RN; ++k)
#pragma unroll
    for (int q = 0; q < RB; ++q) sum[k][q] = 0u;

  for (int r = 0; r < l2; ++r) {
    const int32_t* brow = band_c + (size_t)r * 2 * n;
    for (int j0 = 0; j0 < n; j0 += TJ) {
      // window start >= N + 0 - (N - TJ) - (TJ - 1) = 1, end <= 2N - 1
      const int w0 = n + n0 - j0 - (TJ - 1);
      for (int t = tid; t < TN + TJ - 1; t += kThreads) win_s[t] = brow[w0 + t];
      for (int e = tid; e < TJ * TB; e += kThreads) {
        const int jj = e / TB;
        const int bb = e % TB;
        const int bg = b0 + bb;
        int32_t v = 0;
        if (bg < b) {
          const size_t row = (size_t)r * n + j0 + jj;
          for (int i = nd - 1; i >= 0; --i)
            v = v * 256 + (int32_t)digits[(i * plane_rows + row) * b + bg];
        }
        dig_s[jj][bb] = v;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const int4 d = *reinterpret_cast<const int4*>(&dig_s[jj][tx * RB]);
#pragma unroll
        for (int k = 0; k < RN; ++k) {
          const uint32_t w = (uint32_t)win_s[ty * RN + k + (TJ - 1) - jj];
          sum[k][0] += w * (uint32_t)d.x;
          sum[k][1] += w * (uint32_t)d.y;
          sum[k][2] += w * (uint32_t)d.z;
          sum[k][3] += w * (uint32_t)d.w;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < RN; ++k) {
    const size_t rowoff = ((size_t)c * n + n0 + ty * RN + k) * b;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int bg = b0 + tx * RB + q;
      if (bg < b) out[rowoff + bg] = acc[rowoff + bg] + sum[k][q];
    }
  }
}

}  // namespace

// digits (nd*l2*N, B) int8, band (2, l2, 2N) int32, acc and out (2, N, B)
// uint32; N a multiple of TN.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tfhe_extprod_t(const void* digits, const void* band,
                              const void* acc, void* out, int n, int b,
                              int l2, int nd, void* stream) {
  dim3 block(TB / RB, TN / RN);
  dim3 grid((b + TB - 1) / TB, n / TN, 2);
  extprod_t_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int8_t*)digits, (const int32_t*)band, (const uint32_t*)acc,
      (uint32_t*)out, n, b, l2, nd);
  return (int)cudaGetLastError();
}
