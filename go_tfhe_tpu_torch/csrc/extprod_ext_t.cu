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
// What bounds it on this card: integer multiply-adds on the CUDA cores, as
// for K2.  At uint6 (N = 2048, k = 2, 2L = 2) one step of a 2048-ciphertext
// batch is 2 * 2 * 2048 * 2048 * 4096 = 69 G wrapping IMADs; at uint7 (k =
// 4), batch 256, 17 G.  The uint profiles' digits are three int8 limbs
// (bgbit 22), so staging the recombined digits reads three times K2's
// bytes: the tile's vectorized, ND-templated staging matters most here
// (measured on an H100 at 700 W, uint6 B 2048: 10.99 ms per call with one
// byte per load, 5.85 ms with four).  The design is K2's tile
// (extprod_tile.cuh) with one more grid dimension: blockIdx.z enumerates
// (channel, block) pairs and offsets the digit group, the accumulator rows
// and the output rows; the band window is read per channel as in K2.  A
// ragged batch (B not a multiple of 4) takes the byte-wise staging.  The
// TPU kernel rebuilds its
// Toeplitz scratch once per k block cells; here there is no Toeplitz
// matrix to rebuild (the 95-word window is staged per tile), so the blocks
// are just more independent tiles, which also fills the card at small
// batches (uint7, B 256: 2 x 32 x 8 = 512 blocks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"

namespace {

template <int ND>
__global__ void __launch_bounds__(kExtprodThreads)
extprod_ext_t_kernel(const int8_t* __restrict__ digits,
                     const int32_t* __restrict__ band,
                     const uint32_t* __restrict__ acc,
                     uint32_t* __restrict__ out, int n, int k, int b,
                     int l2) {
  const int c = blockIdx.z / k;
  const int r = blockIdx.z % k;
  const size_t rows = ((size_t)c * k + r) * n * b;     // block r of channel c
  const size_t group = (size_t)r * ND * l2 * n * b;    // digit row group r
  extprod_tile<ND>(digits + group, band + (size_t)c * l2 * 2 * n, acc + rows,
                   out + rows, n, b, l2, blockIdx.y * TN, blockIdx.x * TB);
}

}  // namespace

// digits (k*nd*l2*N, B) int8, band (2, l2, 2N) int32, acc and out
// (2, k*N, B) uint32; N a multiple of TN, 1 <= nd <= 4.  Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for another
// nd).
extern "C" int tfhe_extprod_ext_t(const void* digits, const void* band,
                                  const void* acc, void* out, int n, int k,
                                  int b, int l2, int nd, void* stream) {
  dim3 block(TB / RB, TN / RN);
  dim3 grid((b + TB - 1) / TB, n / TN, 2 * k);
  auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)digits, (const int32_t*)band, (const uint32_t*)acc,
        (uint32_t*)out, n, k, b, l2);
  };
  switch (nd) {
    case 1: launch(extprod_ext_t_kernel<1>); break;
    case 2: launch(extprod_ext_t_kernel<2>); break;
    case 3: launch(extprod_ext_t_kernel<3>); break;
    case 4: launch(extprod_ext_t_kernel<4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
