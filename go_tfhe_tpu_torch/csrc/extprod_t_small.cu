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
// What bounds this form: INT32 multiply-adds and shared-memory loads, and
// at B 1 the latency of one short wave.  2 * N * 2L*N multiply-adds a
// ciphertext (12.6 M at 128-bit, 16.8 M at uint5) over the card's INT32
// lanes (132 SMs x 64 a clock); the band's 2 * 2L * 2N words read once.
// The design: a block of 256 threads owns one channel, TN = 16 output
// coefficients and RB ciphertexts (1, 2 or 4: the batch's), so that B 1
// fills 2 * N / 16 blocks (128 at N 1024).  It stages in shared memory the
// band window its coefficients read, 2L rows of N + TN words, and the
// contraction's digits rebuilt to u32, 2L*N x RB words.  Each warp takes an
// eighth of the contraction; lane l takes every 32nd term from l, so that
// its band loads (TN consecutive words) and its digit load (RB words) are
// bank-conflict free across the warp, and holds TN x RB u32 sums.  The warp
// then sums its lanes with a butterfly (each exchange halves the sums a
// lane holds), the block sums its warps in shared memory, adds acc and
// stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTN = 16;                    // output coefficients per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared memory of a block: digits (2L*N x RB), band window (2L x (N+TN)),
// the warps' sums (kWarps x TN x RB), all u32 words.
__host__ __device__ constexpr size_t small_smem_bytes(int n, int l2, int rb) {
  return sizeof(uint32_t) * ((size_t)l2 * n * rb + (size_t)l2 * (n + kTN) +
                             (size_t)kWarps * kTN * rb);
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

template <int RB>
__global__ void __launch_bounds__(kThreads)
extprod_t_small_kernel(const int8_t* __restrict__ digits,
                       const uint32_t* __restrict__ band,
                       const uint32_t* __restrict__ acc,
                       uint32_t* __restrict__ out, int n, int b, int l2,
                       int nd) {
  constexpr int V = kTN * RB;                    // sums a block owns
  constexpr int S = V >= 32 ? 5 : (V >= 16 ? 4 : 3);
  constexpr int E = V >> S;                      // a lane's sums after them
  extern __shared__ __align__(16) uint32_t smem[];
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
  // The digits, each rebuilt once: d = sum_i limb_i * 256^i mod 2^32;
  // ciphertexts past the batch read as 0.  A thread takes U rows at a
  // time, so that their 32 byte loads are in flight together.
  constexpr int U = 32 / RB;
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

template <int RB>
int launch_small(const void* digits, const void* band, const void* acc,
                 void* out, int n, int b, int l2, int nd,
                 cudaStream_t stream) {
  const size_t smem = small_smem_bytes(n, l2, RB);
  const cudaError_t e = cudaFuncSetAttribute(
      extprod_t_small_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((b + RB - 1) / RB, n / kTN, 2);
  extprod_t_small_kernel<RB><<<grid, kThreads, smem, stream>>>(
      (const int8_t*)digits, (const uint32_t*)band, (const uint32_t*)acc,
      (uint32_t*)out, n, b, l2, nd);
  return (int)cudaGetLastError();
}

// The ciphertexts a block takes (RB): 1 at B 1, 2 at B 2, else 4.
int block_rows(int b) { return b == 1 ? 1 : (b == 2 ? 2 : 4); }

// Whether this form takes the shape on the current device: N a multiple
// of kTN, 1 <= nd <= 4, and a block's shared memory within the device's
// opt-in maximum.
bool takes_shape(int n, int b, int l2, int nd) {
  int limit = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return n > 0 && n % kTN == 0 && b >= 1 && l2 >= 1 && nd >= 1 && nd <= 4 &&
         small_smem_bytes(n, l2, block_rows(b)) <= (size_t)limit;
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
  switch (block_rows(b)) {
    case 1: return launch_small<1>(digits, band, acc, out, n, b, l2, nd, s);
    case 2: return launch_small<2>(digits, band, acc, out, n, b, l2, nd, s);
    default: return launch_small<4>(digits, band, acc, out, n, b, l2, nd, s);
  }
}
