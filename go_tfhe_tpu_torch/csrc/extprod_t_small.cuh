// K2's small form, its block body: the external product of a block's RB
// ciphertexts, TN = 16 output coefficients and one output channel on the
// CUDA cores, transposed layout, for Hopper (sm_90a).  Two kernels run it
// and differ only in how their digits reach shared memory: K2's small
// form (extprod_t_small.cu) rebuilds them from K1's int8 limbs, the fused
// step (step_t_small.cu) makes them from the accumulator itself.
//
// Computes, for output channel c = blockIdx.z:
//   out[c][n, b] = acc[c][n, b] + sum_{r < 2L, j < N} band[c, r, N+n-j] * d[r, j, b]
// mod 2^32 with wrapping u32 multiply-adds, d[r, j, b] the signed digit as
// a u32 word.
//
// What bounds it: INT32 multiply-adds and shared-memory loads, and at B 1
// the latency of one short wave.  2 * N * 2L*N multiply-adds a ciphertext
// (12.6 M at 128-bit, 16.8 M at uint5) over the card's INT32 lanes (132
// SMs x 64 a clock); the band's 2 * 2L * 2N words read once.  The design:
// a block of 256 threads owns one channel, TN output coefficients and RB
// ciphertexts (1, 2 or 4: the batch's), so that B 1 fills 2 * N / 16
// blocks (128 at N 1024).  It stages in shared memory the band window its
// coefficients read, 2L rows of N + TN words, and the contraction's digits
// as u32 words, 2L*N x RB.  Each warp takes an eighth of the contraction;
// lane l takes every 32nd term from l, so that its band loads (TN
// consecutive words) and its digit load (RB words) are bank-conflict free
// across the warp, and holds TN x RB u32 sums.  The warp then sums its
// lanes with a butterfly (each exchange halves the sums a lane holds), the
// block sums its warps in shared memory, adds acc and stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace small_form {

constexpr int kTN = 16;                    // output coefficients per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared memory of a block: digits (2L*N x RB), band window (2L x (N+TN)),
// the warps' sums (kWarps x TN x RB), all u32 words.
__host__ __device__ constexpr size_t smem_bytes(int n, int l2, int rb) {
  return sizeof(uint32_t) * ((size_t)l2 * n * rb + (size_t)l2 * (n + kTN) +
                             (size_t)kWarps * kTN * rb);
}

// The ciphertexts a block takes (RB): 1 at B 1, 2 at B 2, else 4.
inline int block_rows(int b) { return b == 1 ? 1 : (b == 2 ? 2 : 4); }

// Whether the block takes N, B and 2L on the current device: N a multiple
// of kTN and its shared memory within the device's opt-in maximum.
inline bool fits(int n, int b, int l2) {
  int limit = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return n > 0 && n % kTN == 0 && b >= 1 && l2 >= 1 &&
         smem_bytes(n, l2, block_rows(b)) <= (size_t)limit;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

template <int RB>
__device__ __forceinline__ void load_digits(const uint32_t* p,
                                            uint32_t (&d)[RB]) {
  if constexpr (RB == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (RB == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    d[0] = v.x; d[1] = v.y;
  } else {
    d[0] = *p;
  }
}

// Sum v over the warp's lanes.  While a lane holds more than one sum, an
// exchange with the lane M away sends half of them and adds the partner's
// half to the other half; once it holds one, the exchanges add it whole.
// A lane ends with V >> S sums (S = min(log2 V, 5) halvings): slot e holds
// the warp's sum of index e + sum_{s < S} bit_s(lane) * (V >> (s + 1)).
template <int V, int H = V / 2, int M = 1>
__device__ __forceinline__ void reduce_lanes(uint32_t (&v)[V], int lane) {
  if constexpr (M < 32) {
    if constexpr (H >= 1) {
      const bool up = lane & M;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const uint32_t send = up ? v[i] : v[i + H];
        const uint32_t keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      reduce_lanes<V, H / 2, M * 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      reduce_lanes<V, 0, M * 2>(v, lane);
    }
  }
}

// One block's work (launched by `launch` below): kThreads threads,
// smem_bytes(n, l2, RB) of dynamic shared memory `smem`.  stage(dig, b0)
// writes the digits of ciphertexts b0 .. b0 + RB - 1: dig[k * RB + q] for
// contraction row k = r * N + j (any word where b0 + q >= b), all of them
// before it returns; it runs while the band window's copy is in flight.
template <int RB, class Stage>
__device__ __forceinline__ void block(const uint32_t* __restrict__ band,
                                      const uint32_t* __restrict__ acc,
                                      uint32_t* __restrict__ out, int n,
                                      int b, int l2, uint32_t* smem,
                                      Stage stage) {
  constexpr int V = kTN * RB;                    // sums a block owns
  constexpr int S = V >= 32 ? 5 : (V >= 16 ? 4 : 3);
  constexpr int E = V >> S;                      // a lane's sums after them
  const int kdim = l2 * n;                       // contraction depth 2L*N
  const int rs = n + kTN;                        // staged band row stride
  uint32_t* dig_s = smem;                        // [kdim][RB]
  uint32_t* band_s = dig_s + (size_t)kdim * RB;  // [l2][rs]
  uint32_t* red_s = band_s + (size_t)l2 * rs;    // [kWarps][V]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * RB, n0 = blockIdx.y * kTN, c = blockIdx.z;

  // The band window, copied without passing through registers:
  // band_s[r][y] = band[c, r, n0 + 1 + y], y < N + TN - 1.
  const uint32_t* band_c = band + (size_t)c * l2 * 2 * n + n0 + 1;
  for (int r = 0; r < l2; ++r)
    for (int y = tid; y < n + kTN - 1; y += kThreads)
      cp_async4(band_s + r * rs + y, band_c + (size_t)r * 2 * n + y);
  asm volatile("cp.async.commit_group;\n" ::);
  stage(dig_s, b0);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // This warp's eighth of the contraction, lane l taking every 32nd term;
  // coefficient n0 + u reads band[c, r, N + n0 + u - j] = w[u], w = pb - j.
  uint32_t sum[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = 0;
  const int per_warp = (kdim + kWarps - 1) / kWarps;
  const int k_lo = warp * per_warp, k_hi = min(kdim, k_lo + per_warp);
  for (int r = k_lo / n; r * n < k_hi; ++r) {
    const int j_lo = max(k_lo - r * n, 0), j_hi = min(k_hi - r * n, n);
    const uint32_t* pb = band_s + r * rs + n - 1;
    const uint32_t* pd = dig_s + (size_t)r * n * RB;
#pragma unroll 2
    for (int j = j_lo + lane; j < j_hi; j += 32) {
      uint32_t d[RB];
      load_digits<RB>(pd + j * RB, d);
      const uint32_t* w = pb - j;
#pragma unroll
      for (int u = 0; u < kTN; ++u) {
        const uint32_t x = w[u];
#pragma unroll
        for (int q = 0; q < RB; ++q) sum[u * RB + q] += x * d[q];
      }
    }
  }

  reduce_lanes<V>(sum, lane);
  int base = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if ((lane >> s) & 1) base += V >> (s + 1);
  if ((lane >> S) == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) red_s[warp * V + base + e] = sum[e];
  }
  __syncthreads();
  if (tid < V) {
    const int u = tid / RB, q = tid % RB;
    if (b0 + q < b) {
      uint32_t t = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red_s[w * V + tid];
      const size_t o = ((size_t)c * n + n0 + u) * b + b0 + q;
      out[o] = acc[o] + t;
    }
  }
}

// Launches kernel<RB> (a __global__ running `block`): a block for each RB
// ciphertexts, kTN coefficients and channel, with smem_bytes(n, l2, RB) of
// shared memory, on `stream`, args passed on; returns a CUDA error code.
template <class Kernel, class... Args>
int launch(Kernel kernel, int rb, int n, int b, int l2, cudaStream_t stream,
           Args... args) {
  const size_t smem = smem_bytes(n, l2, rb);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((b + rb - 1) / rb, n / kTN, 2);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace small_form
