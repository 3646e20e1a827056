// K2 at small batches: the external product, transposed layout, on the
// CUDA cores, for Hopper (sm_90a).
//
// Replaces no Pallas kernel on its own: it is the small-batch form of
// go_tfhe_tpu/ops/pallas_t.py extprod_t (K2, csrc/extprod_t.cu), with K2's
// contract and arguments.  ops/cuda_t.extprod_t launches it where the
// batch is too small for K2's tile (cuda_t.takes_small_form) and
// tfhe_extprod_t_small_fits accepts the shape, the one rule of its block.
//
// Computes, per output channel c:
//   out[c][n, b] = acc[c][n, b] + sum_{r < 2L, j < N} band[c, r, N+n-j] * d[r, j, b]
// mod 2^32, with d[r, j, b] = sum_i limb_i * 256^i over the int8 digit limbs
// (ND*2L*N, B), limb-major rows [(i, r)] * N + j.  Each digit is rebuilt
// once as a u32 word and multiplied by the whole band word with wrapping
// u32 multiply-adds.  That is the tile's value bit for bit: its limb pairs
// of weight >= 2^32 vanish mod 2^32, the `lo` key limbs it skips are zero
// in the packed band, and wrapping u32 sums do not depend on their order.
//
// Why the tile cannot serve small batches: a tile block owns 64
// coefficients x 64 ciphertexts and walks the whole contraction, 2L*N deep
// (6,144 at 128-bit), in 96 serial stages.  At B 1 the grid is 32 blocks on
// 132 SMs, 63 of every 64 ciphertexts computed are padding, and each exact
// u32 product costs 4 (nd 1) to 9 (nd 3) int8 limb pairs; the step takes
// 96 stages of latency (0.177 ms at 128-bit) whatever the batch.
//
// The block body, its bounds and its design are extprod_t_small.cuh's,
// which the fused step (step_t_small.cu) shares; here a block rebuilds
// each digit once from its ND int8 limbs as it stages them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_t_small.cuh"

namespace {

using small_form::kThreads;

template <int RB>
__global__ void __launch_bounds__(kThreads)
extprod_t_small_kernel(const int8_t* __restrict__ digits,
                       const uint32_t* __restrict__ band,
                       const uint32_t* __restrict__ acc,
                       uint32_t* __restrict__ out, int n, int b, int l2,
                       int nd) {
  extern __shared__ __align__(16) uint32_t smem[];
  // The digits, each rebuilt once: d = sum_i limb_i * 256^i mod 2^32;
  // ciphertexts past the batch read as 0.  A thread takes U rows at a
  // time, so that their 32 byte loads are in flight together.
  auto stage = [&](uint32_t* dig_s, int b0) {
    constexpr int U = 32 / RB;
    const int tid = threadIdx.x, kdim = l2 * n;
    const size_t plane = (size_t)kdim * b;
    for (int k0 = tid; k0 < kdim; k0 += kThreads * U) {
      uint32_t d[U][RB];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < RB; ++q) d[u][q] = 0;
      for (int i = 0; i < nd; ++i) {
        int8_t v[U][RB];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + u * kThreads;
          const int8_t* src = digits + i * plane + (size_t)k * b + b0;
#pragma unroll
          for (int q = 0; q < RB; ++q)
            v[u][q] = k < kdim && b0 + q < b ? src[q] : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int q = 0; q < RB; ++q)
            d[u][q] += (uint32_t)(int32_t)v[u][q] << (8 * i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * kThreads;
        if (k < kdim) {
#pragma unroll
          for (int q = 0; q < RB; ++q) dig_s[k * RB + q] = d[u][q];
        }
      }
    }
  };
  small_form::block<RB>(band, acc, out, n, b, l2, smem, stage);
}

// Whether this form takes the shape on the current device: the block's
// rule (small_form::fits) and 1 <= nd <= 4.
bool takes_shape(int n, int b, int l2, int nd) {
  return nd >= 1 && nd <= 4 && small_form::fits(n, b, l2);
}

template <int RB>
int launch_small(const void* digits, const void* band, const void* acc,
                 void* out, int n, int b, int l2, int nd,
                 cudaStream_t stream) {
  return small_form::launch(extprod_t_small_kernel<RB>, RB, n, b, l2, stream,
                            (const int8_t*)digits, (const uint32_t*)band,
                            (const uint32_t*)acc, (uint32_t*)out, n, b, l2,
                            nd);
}

}  // namespace

// 1 where tfhe_extprod_t_small takes K2's shapes N, B, 2L and ND on the
// current device, else 0 (ops/cuda_t.extprod_t then launches the tile).
extern "C" int tfhe_extprod_t_small_fits(int n, int b, int l2, int nd) {
  return takes_shape(n, b, l2, nd) ? 1 : 0;
}

// K2's arguments: digits (nd*l2*N, B) int8, band (2, l2, 2N) int32 packed
// without its `lo` lowest key limbs (whole words here: the dropped limbs are
// zero in them), acc and out (2, N, B) uint32.  The shape must be one that
// tfhe_extprod_t_small_fits accepts.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for other arguments).
extern "C" int tfhe_extprod_t_small(const void* digits, const void* band,
                                    const void* acc, void* out, int n, int b,
                                    int l2, int nd, int lo, void* stream) {
  (void)lo;
  if (!takes_shape(n, b, l2, nd)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (small_form::block_rows(b)) {
    case 1: return launch_small<1>(digits, band, acc, out, n, b, l2, nd, s);
    case 2: return launch_small<2>(digits, band, acc, out, n, b, l2, nd, s);
    default: return launch_small<4>(digits, band, acc, out, n, b, l2, nd, s);
  }
}
