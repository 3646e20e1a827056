// The blind-rotation step at small batches in one launch: K1's rotate +
// gadget-decompose made inside K2's small form, transposed layout, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel on its own: it computes what K1
// (go_tfhe_tpu/ops/pallas_t.py rotate_decompose_t, csrc/rotdec_t.cu)
// followed by K2's small form (csrc/extprod_t_small.cu) computes, word for
// word.  ops/cuda_t.step_t_small launches it; blind_rotate_t's steps take
// it where cuda_t.takes_fused_step says so (a card, a batch of at most
// cuda_t.FUSED_BATCH_MAX, and tfhe_step_t_small_fits).  The kernel takes
// any batch of K2's small form; above FUSED_BATCH_MAX the digits that each
// of the 2N/16 blocks of a ciphertext makes again cost more than K1's one
// pass (PERF.md §6).
//
// Computes, for every output channel c, coefficient n and ciphertext b:
//   out[c][n, b] = acc[c][n, b] + sum_{r < 2L, j < N} band[c, r, N+n-j] * d[r, j, b]
// mod 2^32, where row r = c' * L + lv holds digit lv of channel c' of
//   tmp = X^a[b] * acc[c'][:, b] - acc[c'][:, b] + offset
// (negacyclic, wrapped coefficients NOT-negated, as K1's rot_entry and
// rotdec_rows in rotdec_col.cuh),
//   d = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2
// sign-extended to 32 bits.  K1 stores that digit as ND exact signed
// base-256 limbs (|d| <= 2^(8*ND - 2)) and K2 rebuilds it as sum_i limb_i *
// 256^i: the same word, so the limbs are neither made nor read here.
//
// Why: at B 1 K1 is bound by latency, not bytes (8 KB in, 6 KB out at
// 128-bit): one block a tile of 16 ciphertexts and channel, 2 blocks on 132
// SMs, 16.7 us a step at 128-bit and 28.4 us at uint5 on an H100 (PERF.md),
// more than K2's small form itself.  Every block of the small form stages
// all of the step's digits anyway, and they are a cheap function of the
// accumulator it already reads.
//
// The design: K2's small-form block (extprod_t_small.cuh: its grid,
// contraction, bounds) with a digit stage of its own.  While the band
// window's copy is in flight, each thread takes one of the block's RB
// ciphertexts (256 threads, RB | 256) and, for each channel, coefficients
// j = tid / RB + i * 256 / RB: it reads acc[c'][j] and the rotation's
// source acc[c'][(j - r) mod N] of its ciphertext straight from global
// memory (the 2*N*RB words of the block's ciphertexts, in L2; at B 1
// consecutive threads read consecutive words, except at the wrap), U
// coefficients at a time so that their loads are in flight together, and
// writes the L digits of each as u32 words.  acc is only read and out is a
// new tensor, so blocks that read acc never race blocks that write out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_t_small.cuh"

namespace {

using small_form::kThreads;

template <int RB>
__global__ void __launch_bounds__(kThreads)
step_t_small_kernel(const uint32_t* __restrict__ acc,
                    const int32_t* __restrict__ amounts,
                    const uint32_t* __restrict__ band,
                    uint32_t* __restrict__ out, int n, int b, int l,
                    int bgbit, uint32_t offset) {
  extern __shared__ __align__(16) uint32_t smem[];
  auto stage = [&](uint32_t* dig_s, int b0) {
    constexpr int U = 8;
    constexpr int per_pass = kThreads / RB;      // coefficients a pass
    const int q = threadIdx.x % RB;
    const bool live = b0 + q < b;
    // The ciphertext's rotation by X^t, t = a mod 2N (rotdec_col.cuh's
    // rot_entry at k = 1): by rr = t mod N, wrapped words NOT-negated, all
    // words NOT-negated once more where t >= N.
    int rr = 0;
    uint32_t flip = 0;
    if (live) {
      int t = amounts[b0 + q] % (2 * n);
      if (t < 0) t += 2 * n;
      rr = t % n;
      flip = t >= n ? ~0u : 0u;
    }
    uint32_t top = 0;                            // each digit field's top bit
    for (int lv = 0; lv < l; ++lv) top |= 1u << (31 - lv * bgbit);
    for (int c = 0; c < 2; ++c) {
      const uint32_t* col = acc + (size_t)c * n * b + b0 + q;
      uint32_t* dig_c = dig_s + (size_t)c * l * n * RB + q;
      for (int j0 = threadIdx.x / RB; j0 < n; j0 += per_pass * U) {
        uint32_t tmp[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * per_pass;
          uint32_t x0 = 0, xr = 0;
          if (live && j < n) {
            int s = j - rr;
            const int m = s >> 31;               // wrapped: NOT-negated
            s += n & m;
            x0 = col[(size_t)j * b];
            xr = col[(size_t)s * b] ^ flip ^ (uint32_t)m;
          }
          // x ^ top puts each digit field's top bit at x - Bg/2
          tmp[u] = (xr - x0 + offset) ^ top;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * per_pass;
          if (j < n) {
            for (int lv = 0; lv < l; ++lv)
              dig_c[((size_t)lv * n + j) * RB] =
                  (uint32_t)((int32_t)(tmp[u] << (lv * bgbit)) >>
                             (32 - bgbit));
          }
        }
      }
    }
  };
  small_form::block<RB>(band, acc, out, n, b, 2 * l, smem, stage);
}

// Whether the fused step takes the shape on the current device: the small
// form's block rule (small_form::fits) and a gadget of at most 32 bits.
bool takes_shape(int n, int b, int l, int bgbit) {
  return l >= 1 && bgbit >= 1 && l * bgbit <= 32 &&
         small_form::fits(n, b, 2 * l);
}

template <int RB>
int launch_step(const void* acc, const void* amounts, const void* band,
                void* out, int n, int b, int l, int bgbit, uint32_t offset,
                cudaStream_t stream) {
  return small_form::launch(step_t_small_kernel<RB>, RB, n, b, 2 * l, stream,
                            (const uint32_t*)acc, (const int32_t*)amounts,
                            (const uint32_t*)band, (uint32_t*)out, n, b, l,
                            bgbit, offset);
}

}  // namespace

// 1 where tfhe_step_t_small takes N, B, L and bgbit on the current device,
// else 0 (the rotation then runs K1 and K2 apart).
extern "C" int tfhe_step_t_small_fits(int n, int b, int l, int bgbit) {
  return takes_shape(n, b, l, bgbit) ? 1 : 0;
}

// acc and out (2, N, B) uint32, amounts (B,) int32, band (2, 2L, 2N)
// int32 (K2's, ops/cuda_t.pack_bsk_band_t: whole words here, any dropped
// key limbs are zero in them); all on the current device.  The shape must
// be one that tfhe_step_t_small_fits accepts.  Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for other arguments).
extern "C" int tfhe_step_t_small(const void* acc, const void* amounts,
                                 const void* band, void* out, int n, int b,
                                 int l, int bgbit, unsigned int offset,
                                 void* stream) {
  if (!takes_shape(n, b, l, bgbit)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (small_form::block_rows(b)) {
    case 1: return launch_step<1>(acc, amounts, band, out, n, b, l, bgbit,
                                  offset, s);
    case 2: return launch_step<2>(acc, amounts, band, out, n, b, l, bgbit,
                                  offset, s);
    default: return launch_step<4>(acc, amounts, band, out, n, b, l, bgbit,
                                   offset, s);
  }
}
