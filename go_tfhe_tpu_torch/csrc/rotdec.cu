// K7: rotate + gadget-decompose, row-major layout, with a block count, for
// Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_rotate.py, rotate_decompose_pallas and
// its kernel body _rotdec_kernel (the Pallas TPU kernel of the block blind
// rotation's step and of its per-bit tail).
//
// The accumulator acc (2, B, N) holds uint32 words, ciphertext-major with
// coefficients contiguous.  For every ciphertext b, block bit j < bs,
// channel c and coefficient n, with a = amounts[j, b] mod 2N:
//   rot  = X^a * acc[c, b, :] at n  (negacyclic, wrapped coefficients NOT-
//                                    negated: ~x, the reference's ^Torus(0)-x)
//   tmp  = rot - acc[c, b, n] + offset             (wrapping mod 2^32)
//   d_lv = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,  lv < l
// and writes int8 digits to out (B, ND*bs*2L*N), limb-major, then block
// bit, channel, level: column (i*bs*2L + (j*2 + c)*L + lv)*N + n
// (pallas_rotate.py:93); for bgbit > 8 each digit splits into nd exact
// signed base-256 limbs.  a = 2N is the identity.
//
// What bounds it on this card: bytes.  Per (b, c) it needs the N words of
// one accumulator row and writes bs*L*ND digit rows of N bytes; there is
// no arithmetic to speak of.  The TPU composes log2(2N) static lane rolls
// per block bit, because per-lane gathers are slow there.  Here a block
// stages `rows` consecutive rows of acc (16 KB: 4 at N 1024), one
// contiguous run, in shared memory once (rotdec_row.cuh) and makes all bs
// block bits' digit rows of each from there, each thread 4 coefficients
// and one 32-bit store per digit row.  The rows arrive in two cp.async
// groups, and the first half is computed while the second is in flight;
// the bs rotations of each row are worked out once, by rows*bs threads,
// while the rows are in flight.  (The per-element kernel this replaces
// read each word 1 + bs times, misaligned, and stored single bytes.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "rotdec_row.cuh"

namespace {

__global__ void __launch_bounds__(rotdec_row::kMaxThreads)
rotdec_kernel(const uint32_t* __restrict__ acc,
              const int32_t* __restrict__ amounts, int8_t* __restrict__ out,
              int n, int b, int bs, int rows, int l, int bgbit,
              uint32_t offset, int nd, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int r0 = blockIdx.x * rows;              // rows c * B + b of acc
  const int nr = min(rows, 2 * b - r0), half = (nr + 1) / 2;
  int* rot = reinterpret_cast<int*>(smem + rows * n);
  rotdec_row::stage(smem, acc + (size_t)r0 * n, half * n, vec);
  rotdec_row::commit();
  rotdec_row::stage(smem + half * n, acc + (size_t)(r0 + half) * n,
                    (nr - half) * n, vec);
  rotdec_row::commit();
  for (int i = threadIdx.x; i < nr * bs; i += blockDim.x) {
    const int r = i / bs, j = i - r * bs;
    const int bi = (r0 + r) % b;
    rot[i] = rotdec_row::rot_entry(amounts[(size_t)j * b + bi], n, 1, 0);
  }
  const int per_row = min(n / 4, (int)blockDim.x);
  const int v = threadIdx.x % per_row, step = blockDim.x / per_row;
  const size_t digit_rows = (size_t)2 * l * n;   // one block bit's
  for (int h = 0; h < 2; ++h) {
    rotdec_row::wait_groups(1 - h);
    for (int r = (h ? half : 0) + threadIdx.x / per_row; r < (h ? nr : half);
         r += step) {
      const int c = (r0 + r) / b, bi = r0 + r - c * b;
      int8_t* o = out + (size_t)bi * nd * bs * digit_rows + (size_t)c * l * n;
      const uint32_t* x = smem + r * n;
      if (bgbit == 8 && nd == 1)
        rotdec_row::row_digits<true>(x, x, rot + r * bs, bs, o, digit_rows,
                                     bs * digit_rows, n, v, per_row, l,
                                     bgbit, offset, nd);
      else
        rotdec_row::row_digits<false>(x, x, rot + r * bs, bs, o, digit_rows,
                                      bs * digit_rows, n, v, per_row, l,
                                      bgbit, offset, nd);
    }
  }
}

}  // namespace

// acc (2, B, N) uint32, amounts (bs, B) int32, out (B, nd*bs*2L*N) int8
// (4-byte aligned); all on the current device.  rows, threads: a block's
// (the wrapper's plan, ops/cuda_rotate.rotdec_plan).  Launches
// ceil(2B / rows) blocks on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int tfhe_rotdec(const void* acc, const void* amounts, void* out,
                           int n, int b, int bs, int l, int bgbit,
                           unsigned int offset, int nd, int rows, int threads,
                           void* stream) {
  const size_t smem = (size_t)rows * (n + bs) * 4;
  if (!rotdec_row::plan_ok(n, threads, smem) || b < 1 || bs < 1 ||
      rows < 1 || l < 1 || nd < 1 || (uintptr_t)out % 4)
    return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)acc % 16 == 0;
  rotdec_kernel<<<(2 * b + rows - 1) / rows, threads, smem,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)amounts, (int8_t*)out, n, b, bs,
      rows, l, bgbit, (uint32_t)offset, nd, vec);
  return (int)cudaGetLastError();
}
