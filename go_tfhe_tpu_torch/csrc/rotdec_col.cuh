// The staged-column rotate + gadget-decompose kernel shared by K1
// (rotdec_t.cu, k = 1) and K4 (rotdec_ext_t.cu, k = 2..4), and its block
// body rotdec_tile, which K9's Y blocks run too (pipe.cu, k = 1), transposed
// layout (coefficient rows, ciphertext batch fastest), for Hopper (sm_90a).
//
// Every ciphertext has its own rotation, so a direct gather acc[c, (n -
// r_b) mod N, b] puts a warp's 32 source words in 32 rows.  Instead one
// block for each tile of TB ciphertexts and channel copies the tile's
// whole k*N-row column into shared memory with cp.async (16-byte pieces
// when the batch and the pointers allow it), so each accumulator word
// crosses device memory once in whole row segments, and gathers there:
// ciphertext w's source of row n is row (n - rr_w) mod N of its source
// block.
//
// Gather mapping: a thread takes 4 consecutive ciphertexts w0..w0+3 of one
// row n and writes each digit row's 4 bytes as one 32-bit word.  A warp
// spans 128/TB consecutive rows (aligned) x TB/4 threads per row.  A row
// holds TB words, so rows s and s + R (R = 32/TB) share banks; the thread
// of row n reads its words in the order j = (t + n/R) mod 4 (step t), so at
// each step the warp's R-row groups read 4 different ciphertext columns,
// and within a group the R consecutive rows (and sources) differ mod R:
// every bank is hit once (tests/test_torch_rotdec_tile.py models it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rotdec_col {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;       // the H100's per-block opt-in limit

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The rotation of ciphertext amount `a` for output block rp of a k-block
// polynomial (k = 1 for K1), packed rr | flip << 16 | sel << 17: the source
// block sel = (rp - t) mod k, t = a mod 2kN, and Y^q with q = (t + sel -
// rp) / k (exact, in [0, 2N]; 2N is the identity): rr = q mod N, flip = q
// >= N (wrapped words are NOT-negated once more).
__device__ __forceinline__ int rot_entry(int a, int n, int k, int rp) {
  const int big = 2 * k * n;
  int t = a % big;
  if (t < 0) t += big;
  int r = (rp - t) % k;
  if (r < 0) r += k;
  int q = (t + r - rp) / k;
  if (q >= 2 * n) q -= 2 * n;
  return (q % n) | (q >= n) << 16 | r << 17;
}

// Four digit bytes of consecutive ciphertexts: one 32-bit store, or
// (vec false) the first `left` bytes one by one.
__device__ __forceinline__ void store4(int8_t* o, uint32_t word, bool vec,
                                       int left) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(o) = word;
  } else {
    for (int j = 0; j < 4 && j < left; ++j) o[j] = (int8_t)(word >> (8 * j));
  }
}

// The digits of output block rp of a tile.  col[(sel * N + s) * TB + w]
// is row s of the tile's staged source block sel, x0[n * TB + w] the output
// block's unrotated rows, rot[w] each ciphertext's rot_entry.  Digit (lv,
// limb i) of row n, ciphertext w goes to out[i * limb_stride + lv *
// lv_stride + (n / 32) * chunk_stride + (n % 32) * row_stride + w].
//
// A thread keeps one 4-ciphertext group and one read order for all its
// rows (blockDim is a multiple of 32 and a warp spans 4R rows), so it reads
// its rotations once.  Per row and ciphertext: the wrapped source row by a
// sign mask, two shared-memory loads, one 3-input add and one 3-input xor
// (the NOT of a wrapped word, and each digit field's top bit: x ^ Bg/2 is
// x - Bg/2 in two's complement).  Digits are then sign-extended by two
// shifts; a signed base-256 limb is the low byte, the next limb comes from
// (d + 128) >> 8.  Each digit row's 4 bytes are packed by byte permutes
// straight into ciphertext order and stored as one word (vec; else byte by
// byte).  Byte digits (bgbit 8, one limb) are the fields' bytes
// themselves: three permutes.
template <int TB, bool kBytes>
__device__ void rotdec_rows(const uint32_t* col, const uint32_t* x0,
                            const int* rot, int8_t* out, size_t row_stride,
                            size_t chunk_stride, size_t lv_stride,
                            size_t limb_stride, int n, int tb, bool vec,
                            int l, int bgbit, uint32_t offset, int nd) {
  constexpr int P = TB / 4;            // threads per row
  constexpr int R = 32 / TB;           // rows per bank cycle
  const int w0 = 4 * (threadIdx.x % P);
  if (w0 >= tb) return;
  const int g = (threadIdx.x / P / R) & 3;
  const uint32_t* xs[4];               // step t reads ciphertext (t + g) & 3
  int rr[4], xo_at[4];
  uint32_t flip[4];
  uint32_t place = 0;                  // permute: t-order bytes -> w order
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int w = w0 + ((t + g) & 3);
    const int e = rot[w];
    rr[t] = e & 0xFFFF;
    flip[t] = (e >> 16) & 1 ? ~0u : 0u;
    xs[t] = col + (e >> 17) * n * TB + w;
    xo_at[t] = w;
    place |= (uint32_t)(t < 2 ? t : t + 2) << (4 * ((t + g) & 3));
  }
  uint32_t top = 0;                    // each digit field's top bit
  for (int lv = 0; lv < l; ++lv) top |= 1u << (31 - lv * bgbit);
  for (int ni = threadIdx.x / P; ni < n; ni += blockDim.x / P) {
    uint32_t tmp[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      int s = ni - rr[t];
      const int m = s >> 31;           // wrapped: NOT-negated once more
      s += n & m;
      const uint32_t xr = xs[t][s * TB] ^ flip[t] ^ (uint32_t)m;
      tmp[t] = (xr - x0[ni * TB + xo_at[t]] + offset) ^ top;
    }
    int8_t* o = out + (ni >> 5) * chunk_stride + (ni & 31) * row_stride + w0;
    for (int lv = 0; lv < l; ++lv) {
      if (kBytes) {
        const uint32_t pick = (3 - lv) | (7 - lv) << 4;
        store4(o + lv * lv_stride,
               __byte_perm(__byte_perm(tmp[0], tmp[1], pick),
                           __byte_perm(tmp[2], tmp[3], pick), place),
               vec, tb - w0);
        continue;
      }
      int32_t d[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        d[t] = (int32_t)(tmp[t] << (lv * bgbit)) >> (32 - bgbit);
      for (int i = 0; i < nd; ++i) {
        store4(o + i * limb_stride + lv * lv_stride,
               __byte_perm(__byte_perm(d[0], d[1], 0x40),
                           __byte_perm(d[2], d[3], 0x40), place),
               vec, tb - w0);
#pragma unroll
        for (int t = 0; t < 4; ++t) d[t] = (d[t] + 128) >> 8;
      }
    }
  }
}

// Where the digits of output block rp of a tile go: the digit rows (out
// of B columns), or (tiled) a buffer whose digit rows are cut into 32-row
// chunks stored tile by tile, out[row group][N / 32][tile][32][TB], so that
// a block writes 32 * TB contiguous bytes a chunk (Bp = tiles * TB
// columns); untile_kernel (rotdec_ext_t.cu) turns each chunk, one
// contiguous run, into 32 digit rows.
template <int TB>
__device__ void rotdec_block(const uint32_t* col, const uint32_t* x0,
                             const int* rot, int8_t* out, int rp, int c,
                             int b0, int tiles, int n, int b, int tb,
                             bool vec, bool tiled, int l, int bgbit,
                             uint32_t offset, int nd) {
  const size_t bp = tiled ? (size_t)tiles * TB : b;
  const size_t row_stride = tiled ? TB : b, chunk_stride = 32 * bp;
  const size_t lv_stride = (size_t)n * bp, limb_stride = 2 * l * lv_stride;
  int8_t* o = out + (rp * nd * 2 + c) * l * lv_stride +
              (tiled ? (size_t)b0 * 32 : b0);
  if (bgbit == 8 && nd == 1)
    rotdec_rows<TB, true>(col, x0, rot, o, row_stride, chunk_stride,
                          lv_stride, limb_stride, n, tb, vec || tiled, l,
                          bgbit, offset, nd);
  else
    rotdec_rows<TB, false>(col, x0, rot, o, row_stride, chunk_stride,
                           lv_stride, limb_stride, n, tb, vec || tiled, l,
                           bgbit, offset, nd);
}

// One block's work, for tile `tile` of TB ciphertexts (of `tiles`) and
// channel c: stage the tile's k*N-row column (k = 1 for K1 and K9) and the
// rotations of its k output blocks in `smem`, then compute the output
// blocks in turn.  Shared memory: col_smem_bytes(k, N, TB).  vec: 16-byte
// staging copies and 32-bit digit stores; tiled: see rotdec_block.  The
// staging and the gather stride by blockDim.x, a multiple of 32 (256 in
// rotdec_kernel, 128 in K9's pipe_kernel).
template <int TB>
__device__ __forceinline__ void rotdec_tile(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ amounts,
    int8_t* __restrict__ out, int n, int k, int b, int l, int bgbit,
    uint32_t offset, int nd, bool vec, bool tiled, int tile, int c,
    int tiles, uint32_t* smem) {
  const int b0 = tile * TB;
  const int tb = min(TB, b - b0);
  const int rows = k * n;
  uint32_t* col = smem;
  int* rot = reinterpret_cast<int*>(col + rows * TB);

  for (int i = threadIdx.x; i < k * TB; i += blockDim.x) {
    const int w = i % TB;
    rot[i] = w < tb ? rot_entry(amounts[b0 + w], n, k, i / TB) : 0;
  }
  const uint32_t* src = acc + (size_t)c * rows * b + b0;
  if (vec) {
    constexpr int P = TB / 4;
    for (int i = threadIdx.x; i < rows * P; i += blockDim.x) {
      const int row = i / P, q = i - row * P;
      if (4 * q < tb)
        cp_async16(col + row * TB + 4 * q, src + (size_t)row * b + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < rows * TB; i += blockDim.x) {
      const int row = i / TB, w = i - row * TB;
      if (w < tb) cp_async4(col + row * TB + w, src + (size_t)row * b + w);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
  __syncthreads();
  for (int rp = 0; rp < k; ++rp)
    rotdec_block<TB>(col, col + rp * n * TB, rot + rp * TB, out, rp, c, b0,
                     tiles, n, b, tb, vec, tiled, l, bgbit, offset, nd);
}

// The kernel: one block for each tile of TB ciphertexts (blockIdx.x) and
// channel (blockIdx.y), each running rotdec_tile.
template <int TB>
__global__ void __launch_bounds__(kThreads)
rotdec_kernel(const uint32_t* __restrict__ acc,
              const int32_t* __restrict__ amounts, int8_t* __restrict__ out,
              int n, int k, int b, int l, int bgbit, uint32_t offset, int nd,
              bool vec, bool tiled) {
  extern __shared__ __align__(16) uint32_t smem[];
  rotdec_tile<TB>(acc, amounts, out, n, k, b, l, bgbit, offset, nd, vec,
                  tiled, blockIdx.x, blockIdx.y, gridDim.x, smem);
}

// What the kernel takes: TB in {4, 8, 16, 32} and N a multiple of the rows
// of one bank cycle (32 / TB; the conflict-free read order needs it).
inline bool plan_ok(int tb, int n) {
  return (tb == 4 || tb == 8 || tb == 16 || tb == 32) && n % (32 / tb) == 0;
}

// A block's shared memory: k*N rows of TB words and k*TB rotation entries.
inline size_t col_smem_bytes(int k, int n, int tb) {
  return ((size_t)k * n + k) * tb * 4;
}

// 16-byte staging copies and 32-bit digit stores: a batch of B columns
// that is a multiple of 4, acc 16-byte and out 4-byte aligned.
inline bool vec_ok(const void* acc, const void* out, int b) {
  return b % 4 == 0 && (uintptr_t)acc % 16 == 0 && (uintptr_t)out % 4 == 0;
}

// Launches rotdec_kernel<tb>, ceil(B / tb) tiles for each of the 2
// channels (tiled: into a chunked buffer `out` of Bp = ceil(B / tb) * tb
// columns; N a multiple of 32).  Returns a CUDA error code
// (cudaErrorInvalidValue for a plan it does not take).
inline int launch(const void* acc, const void* amounts, void* out, int n,
                  int k, int b, int l, int bgbit, unsigned int offset, int nd,
                  int tb, bool tiled, void* stream) {
  if (!plan_ok(tb, n) || b < 1 || k < 1 || l < 1 || nd < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = col_smem_bytes(k, n, tb);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = vec_ok(acc, out, b);
  auto go = [&](auto w) {
    constexpr int TB = decltype(w)::value;
    auto kernel = rotdec_kernel<TB>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((b + TB - 1) / TB, 2);
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const int32_t*)amounts, (int8_t*)out, n, k, b,
        l, bgbit, (uint32_t)offset, nd, vec, tiled);
    return (int)cudaGetLastError();
  };
  switch (tb) {
    case 4: return go(std::integral_constant<int, 4>{});
    case 8: return go(std::integral_constant<int, 8>{});
    case 16: return go(std::integral_constant<int, 16>{});
    default: return go(std::integral_constant<int, 32>{});
  }
}

}  // namespace rotdec_col
