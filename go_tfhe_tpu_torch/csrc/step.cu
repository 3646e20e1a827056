// K3: one whole blind-rotation step in one kernel, row-major layout, for
// Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_step.py, fused_rotate_step and its
// kernel body _step_kernel (the Pallas TPU kernel of blind_rotate_tpu's
// opt-in fused step, blindrotate.FUSED_STEP).
//
// Computes, for the accumulator acc (2, B, N) (uint32 words, channel-major,
// coefficients contiguous), the amounts a[b] in [0, 2N] (2N is the
// identity) and one LWE bit's band (2, 2L, 2N) (the port's one band
// layout, ops/cuda_t.py pack_bsk_band_t, packed without its `lo` lowest
// key limbs, which are not computed):
//   tmp[c, b, j]  = X^a[b] * acc[c, b, :] at j  - acc[c, b, j] + offset
//   d[b, r, j]    = ((tmp[c, b, j] >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,
//                   r = c*L + lv
//   out[c, b, n]  = acc[c, b, n] + sum_{r, j} d[b, r, j] * band[c, r, N+n-j]
// mod 2^32: K7 at bs = 1 followed by K8 with the accumulator fused
// (csrc/rotdec.cu, csrc/extprod.cu), int8-size digits only (one limb).
//
// What bounds it on this card: the external product's int8 tensor-core
// operations, as in K8 (2 * B * N * 2L * N multiply-adds per limb pair; at
// 128bit_fast, B 4096, 3 pairs: 103 G, 0.104 ms at the dense int8 peak).
// What the TPU kernel keeps out of device memory is the digits, and the
// fusion saves one launch per step; this kernel keeps both.  It is K8's
// tensor-core tile (extprod_tile.cuh: 64 (n) x 64 (b) outputs per
// 128-thread block, mma.sync s8 limb pairs, the band window staged as
// reversed, byte-shifted balanced key limbs) with the digit staging
// replaced by the rotation (RotatedDigits): the stages run (input
// channel, 64-deep j chunk, level), and at each chunk's first level the
// block reads its 64 ciphertexts' unrotated words and rotation sources
// (16 KB each, mostly from L2), forms the differences once and stores all
// L levels' packed digits as MMA operands.  The TPU's whole-step resident
// Toeplitz (~25 MB) has no place in 227 KB of shared memory, so the fusion
// is kept and the residency is not; the digits are recomputed by each of
// the 2 * N/64 blocks that read a batch tile, where the TPU kernel held a
// tile's digits in VMEM for all of them.  That recomputation is what the
// fusion costs here: on an H100 at 700 W (PERF.md) a 128bit_fast step at
// B 4096 takes 1.71 ms against K7 + K8's 0.50; with the digits made once
// per tile it ran in 0.55 ms, with the accumulator loads replaced by
// register values in 1.05 (about 2 GB a step is read from L2).  Staging
// the accumulator chunks with cp.async instead of loads changed nothing.
// The output is written out of place: every block reads whole rows of acc
// for its rotations, and other blocks write the same rows.  Ragged B is
// masked per row (a row's result reads only its own digits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"

namespace {

// Grid (ceil(B/TB), N/TN, 2 output channels).
template <int LO>
__global__ void __launch_bounds__(kExtprodThreads, kBlocksPerSM)
step_kernel(const uint32_t* __restrict__ acc,
            const int32_t* __restrict__ amounts,
            const int32_t* __restrict__ band, uint32_t* __restrict__ out,
            int n, int b, int l, int bgbit, uint32_t offset) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = blockIdx.z;
  const size_t chan = (size_t)c * b * n;
  extprod_tile_from<1, LO>(
      RotatedDigits(acc, amounts, n, b, l, bgbit, offset),
      band + (size_t)c * 2 * l * 2 * n, acc + chan, out + chan, n, b,
      blockIdx.y * TN, blockIdx.x * TB, smem);
}

}  // namespace

// acc and out (2, B, N) uint32 (distinct buffers, acc 16-byte aligned),
// amounts (B,) int32, band (2, 2l, 2N) int32 packed without its `lo`
// lowest key limbs; N a multiple of TN, 2l*N < 2^15, 1 <= bgbit <= 8,
// l*bgbit <= 32, lo 0 or 1.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for other arguments).
extern "C" int tfhe_fused_step(const void* acc, const void* amounts,
                               const void* band, void* out, int n, int b,
                               int l, int bgbit, unsigned int offset, int lo,
                               void* stream) {
  if (n % TN || 2 * l * n >= (1 << 15) || bgbit < 1 || bgbit > 8 ||
      l * bgbit > 32)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const dim3 grid((b + TB - 1) / TB, n / TN, 2);
  return dispatch_nd_lo(1, lo, [&](auto, auto lo_c) {
    constexpr int LO = decltype(lo_c)::value;
    return launch_tile(step_kernel<LO>, grid,
                       tile_smem_bytes<RotatedDigits>(
                           RotatedDigits::own_words(l)),
                       (cudaStream_t)stream, (const uint32_t*)acc,
                       (const int32_t*)amounts, (const int32_t*)band,
                       (uint32_t*)out, n, b, l, bgbit, (uint32_t)offset);
  });
}
