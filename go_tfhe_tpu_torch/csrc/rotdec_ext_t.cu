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
// What bounds it on this card: bytes, as K1.  At uint6 B 2048 the
// accumulator is 67 MB, more than the 50 MB L2, so a direct gather, whose
// 32 source words per warp lie in 32 rows, fetched most of its 8-fold
// sector waste from HBM.  The gather is K1's (rotdec_col.cuh): a block
// stages a tile's column in shared memory with 16-byte cp.async copies, so
// each accumulator word crosses device memory once, and gathers there.
// The column of a tile is k*N rows, 4096 at uint6 and 8192 at uint7, so a
// tile holds only 4 (or 8) ciphertexts, and a block would write 4 (8) bytes
// of each digit row: L2 takes such narrow writes slowly.  So, where B % 4
// == 0, K4 runs in two passes: rotdec_kernel writes each block's digits in
// 128-byte runs to a scratch buffer cut into 32-row chunks stored tile by
// tile, and untile_kernel turns each chunk, one contiguous run, into 32
// digit rows, one contiguous run too.  Otherwise one pass writes the rows
// directly, with the widest tile that fits.  The plan is the wrapper's
// (ops/cuda_ext_t.rotdec_ext_t_plan).  A cluster of k blocks a tile, each
// staging one source block and reading the others' through distributed
// shared memory, took wider tiles but read remote words more slowly
// (PERF.md §6), so it is not built.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rotdec_col.cuh"

namespace {

constexpr int kUntileThreads = 256;

// Rearranges the chunked digits of rotdec_kernel (tiled, TB 4) into the
// digit rows, as 32-bit words: chunk (row group g, rows 32 nc ..) of the
// scratch is [tile][32], one contiguous run of Bp / 4 * 32 words (a tile is
// one word); the digit rows 32 nc .. of group g are [32][B / 4], another.
// A block moves 32 rows x 32 words of one chunk through shared memory,
// reading and writing 16-byte pieces (4-byte ones where B % 16 != 0).
__global__ void __launch_bounds__(kUntileThreads)
untile_kernel(const uint32_t* __restrict__ scratch,
              uint32_t* __restrict__ out, int n, int words, int words_p) {
  __shared__ uint32_t t[32][33];
  const int x0 = blockIdx.x * 32, nc = blockIdx.y, g = blockIdx.z;
  const uint4* in = reinterpret_cast<const uint4*>(
      scratch + ((size_t)g * n + nc * 32) * words_p + (size_t)x0 * 32);
  uint32_t* o = out + ((size_t)g * n + nc * 32) * words + x0;
  for (int f = threadIdx.x; f < 256; f += blockDim.x) {
    const int x = f >> 3, nl = (f & 7) * 4;     // tile x, rows nl..nl+3
    if (x0 + x < words) {
      const uint4 v = in[f];
      t[nl][x] = v.x;
      t[nl + 1][x] = v.y;
      t[nl + 2][x] = v.z;
      t[nl + 3][x] = v.w;
    }
  }
  __syncthreads();
  const bool vec = words % 4 == 0 && (uintptr_t)out % 16 == 0;
  for (int f = threadIdx.x; f < 256; f += blockDim.x) {
    const int nl = f >> 3, x = (f & 7) * 4;
    uint32_t* row = o + (size_t)nl * words + x;
    if (vec && x0 + x < words) {
      *reinterpret_cast<uint4*>(row) =
          make_uint4(t[nl][x], t[nl][x + 1], t[nl][x + 2], t[nl][x + 3]);
    } else {
      for (int j = 0; j < 4 && x0 + x + j < words; ++j) row[j] = t[nl][x + j];
    }
  }
}

}  // namespace

// acc (2, k*N, B) uint32, amounts (B,) int32, out (k*nd*2L*N, B) int8; all
// on the current device.  tb: the ciphertexts a tile (4, 8, 16 or 32; N a
// multiple of 32 / tb).  scratch: null, or k*nd*2L*N*B bytes for the
// chunked digits; then tb == 4, B % 4 == 0 and N % 32 == 0, and the kernel
// runs in two passes (rotdec_kernel tiled, then untile_kernel).  Launches
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan it does not take.
extern "C" int tfhe_rotdec_ext_t(const void* acc, const void* amounts,
                                 void* out, void* scratch, int n, int k,
                                 int b, int l, int bgbit, unsigned int offset,
                                 int nd, int tb, void* stream) {
  if (!scratch)
    return rotdec_col::launch(acc, amounts, out, n, k, b, l, bgbit, offset,
                              nd, tb, false, stream);
  if (b % 4 || tb != 4 || (uintptr_t)out % 4 || (uintptr_t)scratch % 16 ||
      n % 32)
    return (int)cudaErrorInvalidValue;
  const int rc = rotdec_col::launch(acc, amounts, scratch, n, k, b, l, bgbit,
                                    offset, nd, tb, true, stream);
  if (rc) return rc;
  const int words = b / 4;
  dim3 grid((words + 31) / 32, n / 32, 2 * k * nd * l);
  untile_kernel<<<grid, kUntileThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)scratch, (uint32_t*)out, n, words, words);
  return (int)cudaGetLastError();
}
