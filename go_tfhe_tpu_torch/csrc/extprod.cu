// K8: external product, row-major layout, fused accumulator update, for
// Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_extprod.py, extprod_pallas and its
// kernel body _extprod_kernel (the Pallas TPU kernel of the block blind
// rotation and of the row-major extended-LUT blind rotation).
//
// Computes, per output channel c, a GEMM with an implicit Toeplitz operand:
//   out[c, b, n] = acc[c, b, n] + sum_{r < R, j < N} d[b, r, j] * band[c, r, N+n-j]
// mod 2^32.  Rows of the digits (B', ND*R*N) int8 are ciphertexts (or, on
// the extended path, ciphertext-blocks); each row is limb-major,
// column (i*R + r)*N + j, and d = sum_i limb_i * 256^i recombines the
// limbs.  R is 2L for a per-bit step, bs*2L for a block step (rows block
// bit, channel, level) or 2L with the k LUT blocks folded into B'.  band
// is the port's one band layout, K2's (ops/cuda_t.py, pack_bsk_band_t):
// D = concat(-K, K) of each BSK row and channel, with the TPU's dropped
// low key limbs (``drop_limbs``) subtracted at packing time.  One wrapping
// 32-bit multiply-add per term is exact: the TPU kernel's digit-limb x
// key-limb pairs of weight >= 2^32 are multiples of 2^32 and vanish
// mod 2^32 by themselves (as in K2).
//
// What bounds it on this card: integer multiply-adds on the CUDA cores.
// At uint8 (N 2048, 2L 2, B' = 256 * 9 block-rows) one step is
// 2 * 2304 * 2048 * 4096 = 38.7 G wrapping IMADs; a block step at
// 128bit_fast (bs 3, R 12, N 1024, B 4096) is 103 G.  The register tile is
// K2's: a 256-thread block owns a 64 (n) x 128 (b) output tile, each
// thread an 8 x 4 register tile; per (r, 32-deep j chunk) the block stages
// the 95-word band window and the 32 x 128 chunk of recombined digits in
// shared memory, and reads T[j, n] = window[(n - n0) + 31 - (j - j0)].
// What the row-major layout changes is the staging and the epilogue:
//  * the digits of one ciphertext are contiguous along j, so a thread
//    reads 4 consecutive j of 4 rows (4-byte loads, a warp covering 4 rows
//    x 32 bytes per load, all ND limb planes issued before use), transposes
//    that 4 x 4 block in registers and stores four 16-byte words into the
//    b-contiguous shared chunk; its rows are padded to 132 words so that
//    these stores are free of bank conflicts;
//  * the output rows are coefficient-contiguous, so the finished tile goes
//    through shared memory (reusing the digit chunk's space) and is added
//    to acc and written along n, 128 bytes per warp.
// Ragged B' is masked per row.  This is written as its own kernel and does
// not share K2's tile (extprod_tile.cuh): moving K2's code into a shared
// function measured 7.5% slower K2 calls on an H100 at 700 W (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;    // output coefficients per block
constexpr int TB = 128;   // digit rows (ciphertexts) per block
constexpr int TJ = 32;    // contraction depth per shared-memory stage
constexpr int RN = 8;     // coefficients per thread
constexpr int RB = 4;     // rows per thread
constexpr int kThreads = (TN / RN) * (TB / RB);     // 256
constexpr int DS = TB + 4;                          // digit chunk row, words
constexpr int OS = TN + 1;                          // output tile row, words
constexpr int kSmem = (TJ * DS > TB * OS) ? TJ * DS : TB * OS;

static_assert(kThreads == (TB / 4) * (TJ / 4), "one 4x4 digit block each");

// Stage d[b0 + bb, r, j0 + jj] (bb < TB, jj < TJ) into dig_s[jj][bb] (row
// stride DS).  Thread (warp w, lane): jq = lane / 4 picks 4 consecutive j,
// g = 4w + lane % 4 picks rows 4g .. 4g+3.
template <int ND>
__device__ __forceinline__ void stage_digits(
    const int8_t* __restrict__ digits, int32_t* dig_s, int bp,
    size_t row_bytes, size_t plane_bytes, size_t col0, int b0, int tid) {
  const int lane = tid & 31;
  const int jq = lane >> 2;
  const int g = ((tid >> 5) << 2) + (lane & 3);
  int4 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = make_int4(0, 0, 0, 0);
    const int bg = b0 + 4 * g + q;
    if (bg < bp) {
      const int8_t* src = digits + (size_t)bg * row_bytes + col0 + 4 * jq;
#pragma unroll
      for (int i = ND - 1; i >= 0; --i) {
        const char4 c = *reinterpret_cast<const char4*>(src + i * plane_bytes);
        v[q].x = v[q].x * 256 + c.x;
        v[q].y = v[q].y * 256 + c.y;
        v[q].z = v[q].z * 256 + c.z;
        v[q].w = v[q].w * 256 + c.w;
      }
    }
  }
  int32_t* dst = dig_s + (4 * jq) * DS + 4 * g;
  *reinterpret_cast<int4*>(dst) = make_int4(v[0].x, v[1].x, v[2].x, v[3].x);
  *reinterpret_cast<int4*>(dst + DS) =
      make_int4(v[0].y, v[1].y, v[2].y, v[3].y);
  *reinterpret_cast<int4*>(dst + 2 * DS) =
      make_int4(v[0].z, v[1].z, v[2].z, v[3].z);
  *reinterpret_cast<int4*>(dst + 3 * DS) =
      make_int4(v[0].w, v[1].w, v[2].w, v[3].w);
}

// Block shape (TB / RB, TN / RN); grid (ceil(B'/TB), N/TN, 2 channels).
template <int ND>
__global__ void __launch_bounds__(kThreads)
extprod_kernel(const int8_t* __restrict__ digits,
               const int32_t* __restrict__ band,
               const uint32_t* __restrict__ acc, uint32_t* __restrict__ out,
               int n, int bp, int rows) {
  __shared__ __align__(16) int32_t smem[kSmem];
  __shared__ int32_t win_s[TN + TJ];
  const int c = blockIdx.z;
  const int n0 = blockIdx.y * TN;
  const int b0 = blockIdx.x * TB;
  const int tx = threadIdx.x;            // 0..31: rows tx*RB ..
  const int ty = threadIdx.y;            // 0..7:  coefficients ty*RN ..
  const int tid = ty * blockDim.x + tx;
  const size_t plane_bytes = (size_t)rows * n;        // one limb plane
  const size_t row_bytes = ND * plane_bytes;          // one digit row
  const int32_t* band_c = band + (size_t)c * rows * 2 * n;

  uint32_t sum[RN][RB];
#pragma unroll
  for (int k = 0; k < RN; ++k)
#pragma unroll
    for (int q = 0; q < RB; ++q) sum[k][q] = 0u;

  for (int r = 0; r < rows; ++r) {
    const int32_t* brow = band_c + (size_t)r * 2 * n;
    for (int j0 = 0; j0 < n; j0 += TJ) {
      // window start >= N + 0 - (N - TJ) - (TJ - 1) = 1, end <= 2N - 1
      const int w0 = n + n0 - j0 - (TJ - 1);
      for (int t = tid; t < TN + TJ - 1; t += kThreads)
        win_s[t] = brow[w0 + t];
      stage_digits<ND>(digits, smem, bp, row_bytes, plane_bytes,
                       (size_t)r * n + j0, b0, tid);
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const int4 d = *reinterpret_cast<const int4*>(&smem[jj * DS + tx * RB]);
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

  // Epilogue: the tile through shared memory, then acc + tile along n.
#pragma unroll
  for (int q = 0; q < RB; ++q)
#pragma unroll
    for (int k = 0; k < RN; ++k)
      smem[(tx * RB + q) * OS + ty * RN + k] = (int32_t)sum[k][q];
  __syncthreads();
  const size_t chan = (size_t)c * bp * n;
  for (int e = tid; e < TB * TN; e += kThreads) {
    const int bb = e / TN;
    const int nn = e % TN;
    const int bg = b0 + bb;
    if (bg < bp) {
      const size_t idx = chan + (size_t)bg * n + n0 + nn;
      out[idx] = acc[idx] + (uint32_t)smem[bb * OS + nn];
    }
  }
}

}  // namespace

// digits (B', nd*rows*N) int8, band (2, rows, 2N) int32, acc and out
// (2, B', N) uint32; N a multiple of TN, 1 <= nd <= 4, digits 4-byte
// aligned.  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for another nd).
extern "C" int tfhe_extprod(const void* digits, const void* band,
                            const void* acc, void* out, int n, int bp,
                            int rows, int nd, void* stream) {
  dim3 block(TB / RB, TN / RN);
  dim3 grid((bp + TB - 1) / TB, n / TN, 2);
  auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)digits, (const int32_t*)band, (const uint32_t*)acc,
        (uint32_t*)out, n, bp, rows);
  };
  switch (nd) {
    case 1: launch(extprod_kernel<1>); break;
    case 2: launch(extprod_kernel<2>); break;
    case 3: launch(extprod_kernel<3>); break;
    case 4: launch(extprod_kernel<4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
