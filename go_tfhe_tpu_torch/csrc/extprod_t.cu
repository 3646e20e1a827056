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
// over the int8 digit limbs (ND*2L*N, B), limb-major rows [(i, r)] * N + j.
// As in the TPU kernel, the product runs as int8 limb-pair dots (digit limb
// i against balanced key limb l, weight 2^(8(i+l))); pairs of weight >=
// 2^32 vanish mod 2^32 and are not computed.
//
// What bounds it on this card: int8 tensor-core operations.  Each limb
// pair whose weight is below 2^32 (3 at 128bit_fast, whose lowest key limb
// is dropped; 4 at 128bit) is one int8 GEMM of (N x 2L*N) by (2L*N x B) per
// channel: at 128bit_fast, B 4096, 3 * 2 * 1024 * 4096 * 4096 = 103 G
// multiply-adds per step, 0.104 ms at the card's dense int8 peak; the
// operands are small (digits 16 MB, band 32 KB) and stay in L2.  The design
// (extprod_tile.cuh, shared with K5 and K9): a 128-thread block owns a 64 (n)
// x 64 (b) output tile, its 4 warps 32 x 32 each, and runs every limb pair
// as mma.sync m16n8k32 s8 x s8 -> s32 into one s32 sum per weight, folded
// into u32 once at the end.  The Toeplitz matrix is never stored: per BSK
// row and 64-deep j chunk the block stages the 127-word band window as
// balanced int8 key limbs, reversed and in four byte-shifted copies, so
// that each A-fragment register is one aligned 32-bit load, and the digit
// limbs transposed to [b][j] rows, so that each B-fragment register is one
// too; the next chunk's loads are in flight during the current chunk's
// MMAs.  The `lo` key limbs that the band was packed without are skipped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"

namespace {

template <int ND, int LO>
__global__ void __launch_bounds__(kExtprodThreads, kBlocksPerSM)
extprod_t_kernel(const int8_t* __restrict__ digits,
                 const int32_t* __restrict__ band,
                 const uint32_t* __restrict__ acc,
                 uint32_t* __restrict__ out, int n, int b, int l2) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = blockIdx.z;
  const size_t chan = (size_t)c * n * b;
  extprod_tile<ND, LO>(digits, band + (size_t)c * l2 * 2 * n, acc + chan,
                       out + chan, n, b, l2, blockIdx.y * TN,
                       blockIdx.x * TB, smem);
}

}  // namespace

// digits (nd*l2*N, B) int8, band (2, l2, 2N) int32 packed without its `lo`
// lowest key limbs, acc and out (2, N, B) uint32; N a multiple of TN,
// l2*N < 2^15, 1 <= nd <= 4, lo 0 or 1.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for other arguments).
extern "C" int tfhe_extprod_t(const void* digits, const void* band,
                              const void* acc, void* out, int n, int b,
                              int l2, int nd, int lo, void* stream) {
  if (n % TN || l2 * n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const dim3 grid((b + TB - 1) / TB, n / TN, 2);
  return dispatch_nd_lo(nd, lo, [&](auto nd_c, auto lo_c) {
    constexpr int ND = decltype(nd_c)::value, LO = decltype(lo_c)::value;
    return launch_tile(extprod_t_kernel<ND, LO>, grid,
                       extprod_smem_bytes<ND>(), (cudaStream_t)stream,
                       (const int8_t*)digits, (const int32_t*)band,
                       (const uint32_t*)acc, (uint32_t*)out, n, b, l2);
  });
}
