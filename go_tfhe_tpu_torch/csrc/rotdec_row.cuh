// The staged-row rotate + gadget-decompose kernel body shared by K7
// (rotdec.cu: bs rotations of each accumulator row) and K6 (rotdec_ext.cu:
// one output block of a k-block row), row-major layout (ciphertext-major,
// coefficients contiguous), for Hopper (sm_90a).
//
// In this layout every digit row is N contiguous bytes of one ciphertext,
// and all of a row's coefficients share one rotation.  So a block copies
// whole source rows (N words of one ciphertext and channel) into shared
// memory with cp.async (16-byte pieces when the pointer allows it) and makes
// every digit row that reads them from there: for K7 the bs block bits of
// each of its rows, for K6 the output block whose source the row is.  The
// rows arrive in two cp.async groups, so a block computes its first rows
// while the others are still in flight.
//
// Gather mapping: a thread takes 4 consecutive coefficients 4u..4u+3 of a
// row and writes each digit row's 4 bytes as one 32-bit word, so a warp
// stores 128 contiguous bytes of a digit row.  The 4 words of a group lie
// in 4 consecutive banks, so the warp's 32 groups would put 4 lanes on each
// bank; the thread of group u reads its words in the order e = (t + g) & 3
// (step t, g = (u / 8) & 3), so at each step the 8 groups of a quarter-warp
// read 8 different 4-bank sets and the 4 quarters 4 different offsets in
// them: every bank is hit once, for the unrotated words and, since N is a
// multiple of 128 and a row shares its rotation, for the rotated ones too
// (tests/test_torch_rotdec_row.py models it).  The digit arithmetic is
// K1's (rotdec_col.cuh), copied: K1 and K4 keep their own code.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rotdec_row {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 49152;        // a block's without an opt-in

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Copies `words` words from device memory at src into shared memory at dst
// with cp.async (not yet committed): 16-byte pieces when vec (src 16-byte
// aligned, words % 4 == 0), else 4-byte ones.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int words, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the last `pending` (0 or 1) committed groups, then
// for every thread of the block.
__device__ __forceinline__ void wait_groups(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The rotation of amount `a` for output block rp of a k-block polynomial
// (k = 1 for K7), packed rr | flip << 16 | sel << 17: the source block sel
// = (rp - t) mod k, t = a mod 2kN, and Y^q with q = (t + sel - rp) / k
// (exact, in [0, 2N]; 2N is the identity): rr = q mod N, flip = q >= N
// (wrapped words are NOT-negated once more).  rotdec_col.cuh's rot_entry.
__device__ __forceinline__ int rot_entry(int a, int n, int k, int rp) {
  const int big = 2 * k * n;
  int t = a % big;
  if (t < 0) t += big;
  int r = (rp - t) % k;
  if (r < 0) r += k;
  int q = (t + r - rp) / k;
  if (q >= 2 * n) q -= 2 * n;
  return (q % n) | (q >= n) << 16 | r << 17;
}

// The digits of one staged row for each of its `nrot` rotations, by the
// `count` threads (a multiple of 32) that take the row, this one the v-th:
// src[s] is the staged source row, x0[n] the unrotated row (src for K7),
// rot[j] rotation j's rot_entry.  Digit (lv, limb i) of rotation j at
// coefficient n goes to out[j * rot_stride + i * limb_stride + lv * N + n]
// (4-byte aligned).  Per coefficient and rotation: the wrapped source by a
// sign mask, one shared-memory load, one 3-input add and one 3-input xor
// (the NOT of a wrapped word, and each digit field's top bit: x ^ Bg/2 is
// x - Bg/2 in two's complement); the unrotated words are loaded once for
// all rotations.  Digits are then sign-extended by two shifts; a signed
// base-256 limb is the low byte, the next limb comes from (d + 128) >> 8.
// Each digit row's 4 bytes are packed by byte permutes back into
// coefficient order and stored as one word.  Byte digits (bgbit 8, one
// limb) are the fields' bytes themselves: three permutes.
template <bool kBytes>
__device__ void row_digits(const uint32_t* src, const uint32_t* x0,
                           const int* rot, int nrot, int8_t* out,
                           size_t rot_stride, size_t limb_stride, int n,
                           int v, int count, int l, int bgbit,
                           uint32_t offset, int nd) {
  const int g = (v >> 3) & 3;          // the group's read order
  uint32_t place = 0;                  // permute: t-order bytes -> n order
#pragma unroll
  for (int t = 0; t < 4; ++t)
    place |= (uint32_t)(t < 2 ? t : t + 2) << (4 * ((t + g) & 3));
  uint32_t top = 0;                    // each digit field's top bit
  for (int lv = 0; lv < l; ++lv) top |= 1u << (31 - lv * bgbit);
  for (int u = v; u < n / 4; u += count) {
    const int n0 = 4 * u;
    uint32_t x[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = x0[n0 + ((t + g) & 3)];
    for (int j = 0; j < nrot; ++j) {
      const int e = rot[j];
      const int rr = e & 0xFFFF;
      const uint32_t flip = (e >> 16) & 1 ? ~0u : 0u;
      uint32_t tmp[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int s = n0 + ((t + g) & 3) - rr;
        const int m = s >> 31;            // wrapped: NOT-negated once more
        s += n & m;
        tmp[t] = ((src[s] ^ flip ^ (uint32_t)m) - x[t] + offset) ^ top;
      }
      int8_t* o = out + j * rot_stride + n0;
      for (int lv = 0; lv < l; ++lv) {
        if (kBytes) {
          const uint32_t pick = (3 - lv) | (7 - lv) << 4;
          *reinterpret_cast<uint32_t*>(o + lv * n) =
              __byte_perm(__byte_perm(tmp[0], tmp[1], pick),
                          __byte_perm(tmp[2], tmp[3], pick), place);
          continue;
        }
        int32_t d[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          d[t] = (int32_t)(tmp[t] << (lv * bgbit)) >> (32 - bgbit);
        for (int i = 0; i < nd; ++i) {
          *reinterpret_cast<uint32_t*>(o + i * limb_stride + lv * n) =
              __byte_perm(__byte_perm(d[0], d[1], 0x40),
                          __byte_perm(d[2], d[3], 0x40), place);
#pragma unroll
          for (int t = 0; t < 4; ++t) d[t] = (d[t] + 128) >> 8;
        }
      }
    }
  }
}

// What the kernels take: N a multiple of 128 (whole warps on a row, and
// the conflict-free read order and the sign-mask wrap), blocks of whole
// warps that hold whole rows' threads, at most kMaxSmem bytes.
inline bool plan_ok(int n, int threads, size_t smem) {
  const int per_row = n / 4 < threads ? n / 4 : threads;
  return n >= 128 && n % 128 == 0 && threads >= 32 && threads % 32 == 0 &&
         threads <= kMaxThreads && threads % per_row == 0 &&
         smem <= (size_t)kMaxSmem;
}

}  // namespace rotdec_row
