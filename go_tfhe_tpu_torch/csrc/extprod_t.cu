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
// one 16-byte and at most eight 4-byte shared-memory reads.  The digit
// staging is the other cost: the kernel is templated on ND, and for B a
// multiple of 4 a thread reads four ciphertexts' limbs per 4-byte load, all
// of its loads of a stage issued before the first is used (measured on an
// H100 at 700 W: 3.67 -> 2.38 ms per call at 128bit_fast, B 4096, against
// one byte per load in a loop over a run-time ND).  The s8 tensor cores
// (mma.sync / wgmma) offer over ten times the CUDA cores' rate for this
// product; using them is later work.  The tile's device code is
// extprod_tile.cuh, shared with K5 (extprod_ext_t.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"

namespace {

template <int ND>
__global__ void __launch_bounds__(kExtprodThreads)
extprod_t_kernel(const int8_t* __restrict__ digits,
                 const int32_t* __restrict__ band,
                 const uint32_t* __restrict__ acc,
                 uint32_t* __restrict__ out, int n, int b, int l2) {
  const int c = blockIdx.z;
  const size_t chan = (size_t)c * n * b;
  extprod_tile<ND>(digits, band + (size_t)c * l2 * 2 * n, acc + chan,
                   out + chan, n, b, l2, blockIdx.y * TN, blockIdx.x * TB);
}

}  // namespace

// digits (nd*l2*N, B) int8, band (2, l2, 2N) int32, acc and out (2, N, B)
// uint32; N a multiple of TN, 1 <= nd <= 4.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for another nd).
extern "C" int tfhe_extprod_t(const void* digits, const void* band,
                              const void* acc, void* out, int n, int b,
                              int l2, int nd, void* stream) {
  dim3 block(TB / RB, TN / RN);
  dim3 grid((b + TB - 1) / TB, n / TN, 2);
  auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)digits, (const int32_t*)band, (const uint32_t*)acc,
        (uint32_t*)out, n, b, l2);
  };
  switch (nd) {
    case 1: launch(extprod_t_kernel<1>); break;
    case 2: launch(extprod_t_kernel<2>); break;
    case 3: launch(extprod_t_kernel<3>); break;
    case 4: launch(extprod_t_kernel<4>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
