// One output tile of the transposed external product, shared by K2
// (extprod_t.cu) and K5 (extprod_ext_t.cu).
//
// For one channel's band and one block of digits, a 256-thread block
// computes a TN (coefficients) x TB (ciphertexts) tile of
//   out[n, b] = acc[n, b] + sum_{r < l2, j < N} band[r, N+n-j] * d[r, j, b]
// mod 2^32, with d[r, j, b] = sum_i limb_i * 256^i recombined from the int8
// digit limbs (ND*l2*N, B), limb-major rows [(i, r)] * N + j.  extprod_t.cu
// explains the design (why wrapping u32 multiply-adds are exact, the band
// window, the register tile).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;    // output coefficients per block
constexpr int TB = 128;   // ciphertexts per block
constexpr int TJ = 32;    // contraction depth per shared-memory stage
constexpr int RN = 8;     // coefficients per thread
constexpr int RB = 4;     // ciphertexts per thread
constexpr int kExtprodThreads = (TN / RN) * (TB / RB);   // 256

constexpr int kGroups = TJ * TB / 4 / kExtprodThreads;  // 4 per stage

// Stage the recombined digits d[r, j0 + jj, b0 + bb] (jj < TJ, bb < TB) of
// one contraction chunk into dig_s.  With B a multiple of 4 every row of
// the digits is 4-byte aligned, so a thread reads four neighbouring
// ciphertexts' limbs at once (a warp: 128 bytes of one row per limb); the
// loop is unrolled over the ND limb planes, so all of a thread's loads
// issue before the first is used.  Otherwise, one byte at a time.
template <int ND>
__device__ __forceinline__ void stage_digits(
    const int8_t* __restrict__ digits, int32_t (*dig_s)[TB], int b,
    size_t plane_rows, size_t row0, int b0, int tid) {
  if (b % 4 == 0) {
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int g = tid + u * kExtprodThreads;
      const int jj = g / (TB / 4);
      const int bb = (g % (TB / 4)) * 4;
      const int bg = b0 + bb;
      int4 v = make_int4(0, 0, 0, 0);
      if (bg < b) {                      // then bg + 3 < b as well
        const size_t row = row0 + jj;
#pragma unroll
        for (int i = ND - 1; i >= 0; --i) {
          const char4 q = *reinterpret_cast<const char4*>(
              digits + (i * plane_rows + row) * b + bg);
          v.x = v.x * 256 + q.x;
          v.y = v.y * 256 + q.y;
          v.z = v.z * 256 + q.z;
          v.w = v.w * 256 + q.w;
        }
      }
      *reinterpret_cast<int4*>(&dig_s[jj][bb]) = v;
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < TJ * TB; e += kExtprodThreads) {
      const int jj = e / TB;
      const int bb = e % TB;
      const int bg = b0 + bb;
      int32_t v = 0;
      if (bg < b) {
        const size_t row = row0 + jj;
#pragma unroll
        for (int i = ND - 1; i >= 0; --i)
          v = v * 256 + (int32_t)digits[(i * plane_rows + row) * b + bg];
      }
      dig_s[jj][bb] = v;
    }
  }
}

// Block shape (TB / RB, TN / RN); tile origin (n0, b0).  digits, acc and out
// point at this block's (channel, LUT block) slice; band_c at the channel's
// band (l2, 2N).  Rows of acc and out are N coefficients of B words.
// ND: limbs per digit (1..4).
template <int ND>
__device__ __forceinline__ void extprod_tile(
    const int8_t* __restrict__ digits, const int32_t* __restrict__ band_c,
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ out, int n,
    int b, int l2, int n0, int b0) {
  __shared__ __align__(16) int32_t dig_s[TJ][TB];
  __shared__ int32_t win_s[TN + TJ];
  const int tx = threadIdx.x;            // 0..31: ciphertexts tx*RB ..
  const int ty = threadIdx.y;            // 0..7:  coefficients ty*RN ..
  const int tid = ty * blockDim.x + tx;
  const size_t plane_rows = (size_t)l2 * n;          // rows per limb plane

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
      for (int t = tid; t < TN + TJ - 1; t += kExtprodThreads)
        win_s[t] = brow[w0 + t];
      stage_digits<ND>(digits, dig_s, b, plane_rows, (size_t)r * n + j0, b0,
                       tid);
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
    const size_t rowoff = (size_t)(n0 + ty * RN + k) * b;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int bg = b0 + tx * RB + q;
      if (bg < b) out[rowoff + bg] = acc[rowoff + bg] + sum[k][q];
    }
  }
}

}  // namespace
