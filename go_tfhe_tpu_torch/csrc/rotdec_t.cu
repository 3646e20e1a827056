// K1: rotate + gadget-decompose, transposed layout, for Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_t.py, rotate_decompose_t and its kernel
// body _rotdec_t_kernel (the Pallas TPU kernel of the blind-rotation step).
//
// Computes, for every coefficient n and ciphertext b of the accumulator
// acc (2, N, B) (uint32 words, coefficient-major, batch fastest):
//   rot  = X^a[b] * acc[c, :, b]   (negacyclic, wrapped coefficients NOT-
//                                   negated: ~x, the reference's ^Torus(0)-x)
//   tmp  = rot - acc + offset      (wrapping mod 2^32)
//   d_lv = ((tmp >> (32 - (lv+1)*bgbit)) & (Bg-1)) - Bg/2,  lv < l
// and writes int8 digits to out (ND*2L*N, B), limb-major rows
// [(i, c, lv)] * N + n; for bgbit > 8 each digit splits into nd exact
// signed base-256 limbs (pallas_t.py:105-114 arithmetic).
//
// What bounds it on this card: bytes.  Each accumulator word is needed
// once and each digit byte written once (about 8 + 2L*ND bytes per
// coefficient and ciphertext); there is no arithmetic to speak of.  The
// TPU kernel composed log2(2N) static rolls, because per-lane gathers were
// its slow path.  Here a direct gather cannot coalesce either: every
// ciphertext has its own rotation, so a warp's 32 source words lie in 32
// rows (32 sectors for 128 useful bytes).  So a block stages a tile's
// channel column, N rows of TB ciphertexts, in shared memory with 16-byte
// cp.async copies (rotdec_col.cuh), each word crossing device memory once,
// gathers there bank-conflict free and writes each digit row's TB bytes as
// 32-bit words.  TB is the wrapper's plan (ops/cuda_t.rotdec_t_plan: 16).

#include <cuda_runtime.h>

#include "rotdec_col.cuh"

// acc (2, N, B) uint32, amounts (B,) int32, out (nd*2L*N, B) int8; all on
// the current device.  tb: the ciphertexts a tile (4, 8, 16 or 32; N a
// multiple of 32 / tb).  Launches on `stream`; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a plan it does not take.
extern "C" int tfhe_rotdec_t(const void* acc, const void* amounts, void* out,
                             int n, int b, int l, int bgbit,
                             unsigned int offset, int nd, int tb,
                             void* stream) {
  return rotdec_col::launch(acc, amounts, out, n, 1, b, l, bgbit, offset, nd,
                            tb, false, stream);
}
