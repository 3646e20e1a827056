// K8: external product, row-major layout, fused accumulator update, for
// Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_extprod.py, extprod_pallas and its
// kernel body _extprod_kernel (the Pallas TPU kernel of the block blind
// rotation, of the row-major per-bit rotation and of the row-major
// extended-LUT blind rotation).
//
// Computes, per output channel c, a GEMM with an implicit Toeplitz operand:
//   out[c, b, n] = acc[c, b, n] + sum_{r < R, j < N} d[b, r, j] * band[c, r, N+n-j]
// mod 2^32.  Rows of the digits (B', ND*R*N) int8 are ciphertexts (or, on
// the extended path, ciphertext-blocks); each row is limb-major,
// column (i*R + r)*N + j, and d = sum_i limb_i * 256^i recombines the
// limbs.  R is 2L for a per-bit step, bs*2L for a block step (rows block
// bit, channel, level) or 2L with the k LUT blocks folded into B'.  band
// is the port's one band layout, K2's (ops/cuda_t.py, pack_bsk_band_t):
// D = concat(-K, K) of each BSK row and channel, packed without its `lo`
// lowest balanced key limbs (the TPU's ``drop_limbs``), which are not
// computed.  As in the TPU kernel, the product runs as int8 limb-pair
// dots; pairs of weight >= 2^32 vanish mod 2^32 and are not computed.
//
// What bounds it on this card: int8 tensor-core operations.  A block step
// at 128bit_fast (bs 3, R 12, N 1024, B 4096, 3 limb pairs) is 3 * 2 *
// 1024 * 4096 * 12288 = 309 G multiply-adds, 0.313 ms at the dense int8
// peak; a per-bit step (R 4) 0.104 ms; uint8 (N 2048, R 2, B' = 256 * 9,
// nd 3, 9 pairs) 0.352 ms.  The design is K2's tensor-core tile
// (extprod_tile.cuh; 64 (n) x 64 (b) outputs per 128-thread block, every
// limb pair as mma.sync m16n8k32 s8 x s8 -> s32, the band window staged as
// reversed, byte-shifted balanced key limbs) with the row-major digit
// source: the digits of one ciphertext are contiguous along j, which is
// the K-major B operand the MMAs read, so each stage's 64-byte row pieces
// are copied with cp.async straight into the operand rows (no
// transposition, which K2 needs), and the C fragments are written
// coefficient-contiguous (a warp store: 4 rows x 8 consecutive words).
// Ragged B' is zero-filled by row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"

namespace {

template <int ND, int LO>
__global__ void __launch_bounds__(kExtprodThreads, kBlocksPerSM)
extprod_kernel(const int8_t* __restrict__ digits,
               const int32_t* __restrict__ band,
               const uint32_t* __restrict__ acc, uint32_t* __restrict__ out,
               int n, int bp, int rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = blockIdx.z;
  const size_t chan = (size_t)c * bp * n;
  extprod_tile_from<ND, LO>(RowMajorDigits<ND>(digits, n, bp, rows),
                            band + (size_t)c * rows * 2 * n, acc + chan,
                            out + chan, n, bp, blockIdx.y * TN,
                            blockIdx.x * TB, smem);
}

}  // namespace

// digits (B', nd*rows*N) int8 (16-byte aligned), band (2, rows, 2N) int32
// packed without its `lo` lowest key limbs, acc and out (2, B', N) uint32;
// N a multiple of TN, rows*N < 2^15, 1 <= nd <= 4, lo 0 or 1.  Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for other
// arguments).
extern "C" int tfhe_extprod(const void* digits, const void* band,
                            const void* acc, void* out, int n, int bp,
                            int rows, int nd, int lo, void* stream) {
  if (n % TN || rows * n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  if (bp == 0) return 0;
  const dim3 grid((bp + TB - 1) / TB, n / TN, 2);
  return dispatch_nd_lo(nd, lo, [&](auto nd_c, auto lo_c) {
    constexpr int ND = decltype(nd_c)::value, LO = decltype(lo_c)::value;
    return launch_tile(extprod_kernel<ND, LO>, grid,
                       tile_smem_bytes<RowMajorDigits<ND>>(),
                       (cudaStream_t)stream, (const int8_t*)digits,
                       (const int32_t*)band, (const uint32_t*)acc,
                       (uint32_t*)out, n, bp, rows);
  });
}
