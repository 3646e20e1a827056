// K5: block-wise external product for extended look-up tables, transposed
// layout, for Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_t.py, extprod_ext_t and its kernel body
// _extprod_ext_t_kernel (the Pallas TPU kernel of the extended-LUT
// blind-rotation step, uint6/uint7).
//
// Computes K2's contraction (extprod_t.cu) for each of the k blocks of the
// interleaved big accumulator, every block against the SAME band:
//   out[c][rN + n, b] = acc[c][rN + n, b]
//                     + sum_{r2 < 2L, j < N} band[c, r2, N+n-j] * d_r[r2, j, b]
// mod 2^32, where d_r recombines row group r of the block-major digits
// (k*ND*2L*N, B), each group in K2's limb-major layout.
//
// What bounds it on this card: int8 tensor-core operations, as for K2.
// The uint profiles' digits are three int8 limbs (bgbit 22) against four
// key limbs: 9 limb pairs below 2^32.  At uint6 (N = 2048, k = 2, 2L = 2)
// one step of a 2048-ciphertext batch is 9 * 2 * 2 * 2048 * 2048 * 4096 =
// 619 G multiply-adds, 0.625 ms at the dense int8 peak; at uint7 (k = 4),
// batch 256, 155 G.  The design is K2's tensor-core tile (extprod_tile.cuh)
// with one more grid dimension: blockIdx.z enumerates (channel, block)
// pairs and offsets the digit group, the accumulator rows and the output
// rows; the band window is staged per channel as in K2, and each of the
// three digit limbs is its own B operand.  The TPU kernel rebuilds its
// Toeplitz scratch once per k block cells; here there is no Toeplitz matrix
// to rebuild (the 127-word window is staged per chunk), so the blocks are
// just more independent tiles, which also fills the card at small batches
// (uint7, B 256: 4 x 32 x 8 = 1024 blocks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"

namespace {

template <int ND, int LO>
__global__ void __launch_bounds__(kExtprodThreads, kBlocksPerSM)
extprod_ext_t_kernel(const int8_t* __restrict__ digits,
                     const int32_t* __restrict__ band,
                     const uint32_t* __restrict__ acc,
                     uint32_t* __restrict__ out, int n, int k, int b,
                     int l2) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = blockIdx.z / k;
  const int r = blockIdx.z % k;
  const size_t rows = ((size_t)c * k + r) * n * b;     // block r of channel c
  const size_t group = (size_t)r * ND * l2 * n * b;    // digit row group r
  extprod_tile<ND, LO>(digits + group, band + (size_t)c * l2 * 2 * n,
                       acc + rows, out + rows, n, b, l2, blockIdx.y * TN,
                       blockIdx.x * TB, smem);
}

}  // namespace

// digits (k*nd*l2*N, B) int8, band (2, l2, 2N) int32 packed without its
// `lo` lowest key limbs, acc and out (2, k*N, B) uint32; N a multiple of
// TN, l2*N < 2^15, 1 <= nd <= 4, lo 0 or 1.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for other arguments).
extern "C" int tfhe_extprod_ext_t(const void* digits, const void* band,
                                  const void* acc, void* out, int n, int k,
                                  int b, int l2, int nd, int lo,
                                  void* stream) {
  if (n % TN || l2 * n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const dim3 grid((b + TB - 1) / TB, n / TN, 2 * k);
  return dispatch_nd_lo(nd, lo, [&](auto nd_c, auto lo_c) {
    constexpr int ND = decltype(nd_c)::value, LO = decltype(lo_c)::value;
    return launch_tile(extprod_ext_t_kernel<ND, LO>, grid,
                       extprod_smem_bytes<ND>(), (cudaStream_t)stream,
                       (const int8_t*)digits, (const int32_t*)band,
                       (const uint32_t*)acc, (uint32_t*)out, n, k, b, l2);
  });
}
