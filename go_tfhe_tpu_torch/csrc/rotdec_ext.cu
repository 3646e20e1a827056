// K6: rotate + gadget-decompose of the interleaved big accumulator, for
// extended look-up tables, row-major layout, for Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_ext.py, rotate_decompose_ext_pallas and
// its kernel body _rotdec_ext_kernel (the Pallas TPU kernel of the row-major
// extended-LUT blind rotation, which the JAX package runs for uint8's k = 9).
//
// The big polynomial (degree k*N) is stored as k blocks of N coefficients,
// big[j] == block[j % k][j // k]; acc (2, B, k*N) holds block r in columns
// [rN, (r+1)N) of each ciphertext's row (uint32 words).  For every
// ciphertext b, output block r', coefficient n and channel c, with
// t = amount mod 2kN:
//   r   = (r' - t) mod k,   q = (t + r - r') / k     (exact, 0 <= q <= 2N)
//   rot = Y^q * block[r] at n   (Y = X^k; negacyclic in N, wrapped
//                                coefficients NOT-negated: ~x)
//   tmp = rot - block[r'][n] + offset                (wrapping mod 2^32)
//   d_lv = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,  lv < l
// and writes int8 digits to out (B, k*ND*2L*N), block-major, then limb,
// channel, level: column (r'*ND*2L + i*2L + c*L + lv)*N + n
// (pallas_ext.py:111), so out.reshape(B*k, ND*2L*N) is K8's digit input
// with the blocks folded into the batch.  t = 2kN is the identity
// (mod_switch_general can return 2kN).
//
// What bounds it on this card: bytes.  At uint8 (N 2048, k 9, nd 3) a
// ciphertext needs 2 * 18432 accumulator words and writes 110,592 int8
// digits.  The TPU composes log2(2kN) rounds of static block rolls,
// because per-lane gathers are slow there.  Here one block per
// (ciphertext, output block r') stages, for each channel, its source block
// r and its own block r' in shared memory (rotdec_row.cuh; r' alone when
// r == r'), 32 KB at uint8, and makes the output block's 2*L*ND digit
// rows, each thread 4 coefficients and one 32-bit store per digit row;
// channel 1's blocks are in flight while channel 0's digits are made.
// Each block of the accumulator is staged once as a rotation source (r' ->
// r is a permutation) and once as the unrotated block, in whole aligned
// runs; the k-fold grid (2,304 blocks at uint8 B 256) fills the card,
// where one block staging a whole 72 KB row would leave 512.  (The
// per-element kernel this replaces computed its source with runtime
// divisions in every thread, read it misaligned and stored single bytes.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "rotdec_row.cuh"

namespace {

__global__ void __launch_bounds__(rotdec_row::kMaxThreads)
rotdec_ext_kernel(const uint32_t* __restrict__ acc,
                  const int32_t* __restrict__ amounts,
                  int8_t* __restrict__ out, int n, int k, int b, int l,
                  int bgbit, uint32_t offset, int nd, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];   // [c][r' | r] blocks
  int* rot = reinterpret_cast<int*>(smem + 4 * n);
  const int bi = blockIdx.x, rp = blockIdx.y;
  const size_t plane = (size_t)b * k * n;
  const uint32_t* row = acc + (size_t)bi * k * n;
  rotdec_row::stage(smem, row + (size_t)rp * n, n, vec);
  // Every thread needs r to stage it: worked out while r' is in flight.
  const int e = rotdec_row::rot_entry(amounts[bi], n, k, rp);
  const int sel = e >> 17;
  for (int c = 0; c < 2; ++c) {
    if (c) rotdec_row::stage(smem + 2 * n, row + plane + (size_t)rp * n, n,
                             vec);
    if (sel != rp)
      rotdec_row::stage(smem + (2 * c + 1) * n,
                        row + c * plane + (size_t)sel * n, n, vec);
    rotdec_row::commit();
  }
  if (threadIdx.x == 0) rot[0] = e;
  const size_t digit_rows = (size_t)2 * l * n;   // one limb's
  int8_t* o = out + ((size_t)bi * k + rp) * nd * digit_rows;
  for (int c = 0; c < 2; ++c) {
    rotdec_row::wait_groups(1 - c);
    const uint32_t* x0 = smem + 2 * c * n;
    const uint32_t* src = sel != rp ? x0 + n : x0;
    if (bgbit == 8 && nd == 1)
      rotdec_row::row_digits<true>(src, x0, rot, 1, o + c * l * n, 0,
                                   digit_rows, n, threadIdx.x, blockDim.x, l,
                                   bgbit, offset, nd);
    else
      rotdec_row::row_digits<false>(src, x0, rot, 1, o + c * l * n, 0,
                                    digit_rows, n, threadIdx.x, blockDim.x, l,
                                    bgbit, offset, nd);
  }
}

}  // namespace

// acc (2, B, k*N) uint32, amounts (B,) int32, out (B, k*nd*2L*N) int8
// (4-byte aligned); all on the current device.  threads: a block's (the
// wrapper's plan, ops/cuda_ext.rotdec_ext_plan: N/4 up to 256).  Launches
// one block per (ciphertext, output block) on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan it does not take.
extern "C" int tfhe_rotdec_ext(const void* acc, const void* amounts,
                               void* out, int n, int k, int b, int l,
                               int bgbit, unsigned int offset, int nd,
                               int threads, void* stream) {
  const size_t smem = ((size_t)4 * n + 1) * 4;
  if (!rotdec_row::plan_ok(n, threads, smem) || threads > n / 4 || b < 1 ||
      k < 1 || k > 65535 || l < 1 || nd < 1 || (uintptr_t)out % 4)
    return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)acc % 16 == 0;
  rotdec_ext_kernel<<<dim3(b, k), threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)amounts, (int8_t*)out, n, k, b, l,
      bgbit, (uint32_t)offset, nd, vec);
  return (int)cudaGetLastError();
}
