// The key switch's digit-table contraction as one gather-and-sum over the
// int32 table, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's key switch
// (go_tfhe_tpu/ops/keyswitch.py identity_key_switch) is a one-hot product
// left to XLA, and the port's plain version
// (ops/keyswitch.py digit_table_switch_ref) keeps that form: the whole
// table as four float32 limbs, every call, against a float32 one-hot of
// which one row in 2^basebit is useful.  ops/keyswitch.digit_table_switch
// launches this kernel for CUDA tensors where tfhe_key_switch_fits takes
// the shape; identity_key_switch (the KSK) and proxyreenc.reencrypt (a
// re-encryption key) both run it.
//
// Computes, for each ciphertext b < B and output column c < w:
//   out[b, c] = [c == w-1] ct[b, n] - sum_{i < n, j < t} table[i, j, d, c]
//   d = ((ct[b, i] + 2^(31 - basebit*t)) >> (32 - (j+1)*basebit)) & (base-1)
// mod 2^32 (trgsw/keyswitch.go), table (n, t, base = 2^basebit, w) and ct
// (B, n+1) as u32 words.  Every (i, j) term is summed, digit 0 included,
// in wrapping u32 adds: the words are exact and do not depend on the order
// of the sums.
//
// What bounds it: a ciphertext picks n*t rows of w words (26 MB at uint5),
// so at small B the bytes of those rows; at large B the B*n*t*w adds, each
// row serving every ciphertext of the batch that picks it.  On an H100
// (PERF.md) B 1 takes 1.5-1.9x its byte bound; at large B each
// batch tile of a column copies the tile's slabs again, and the copies of
// different tiles drift apart, so they come from device memory and not
// L2: uint5 at B 2048 (8 tiles) takes 8x its add bound, uint8 at B 256
// (one tile) 1.7x.
//
// Design: the (i, j) pairs are slabs of `base` rows; one gather, tiled in
// one of two ways that plan() picks from B, base, w and the card's SMs:
// * rows from device memory (direct_kernel; where B is below the rows a
//   staged batch tile would copy): a block takes one ciphertext and a range
//   of slabs, a thread M columns c = tid + 256 m; the rows of U slabs are
//   loaded together, and the slab ranges split so that the grid fills the
//   card.
// * staged slabs (staged_kernel): a block takes 32 columns, 32*CB
//   ciphertexts and a range of slabs; it copies its slabs' rows x 32
//   columns, 128 rows a stage, into a ring of kStages shared-memory stages
//   with cp.async (16-byte pieces where the rows are 16-byte aligned, else
//   words).  Blocks walk the slabs in the same order, so that a slab
//   fetched once from device memory serves the other batch tiles from L2.
//   A ciphertext's 8 threads (a quarter warp) read its digit's 128-byte row
//   as 16 bytes each: one row a quarter warp, no bank conflict whatever the
//   digits.  A thread keeps 4 columns of CB ciphertexts in registers.
// Both add their partial sums into the output, zeroed first, with atomic
// u32 adds; the first slab range adds the body.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
// Direct: at most kMaxM columns a thread (w <= 2048), U slabs' rows in
// flight a thread.
constexpr int kMaxM = 8;
constexpr int kU = 4;
// Staged: 32 columns a block (8 threads of 4 a ciphertext), 128 table rows
// a stage (at least one slab), a ring of 3 stages.
constexpr int kCols = 32;
constexpr int kStageRows = 128;
constexpr int kStages = 3;
// Blocks an SM that plan() splits the slabs for: on an H100, 16 staged
// blocks an SM against 8 took 8-13% off uint5's switch at B 256 and
// B 2048 and uint8's at B 256 (PERF.md); 2, 4 or 8 direct blocks
// an SM read alike at B 1.
constexpr int kFillStaged = 16;
constexpr int kFillDirect = 4;

__device__ __forceinline__ uint32_t digit(uint32_t a_bar, int shift,
                                          uint32_t mask) {
  return (a_bar >> shift) & mask;
}

// The block's share of the output: minus its partial sums, plus the body
// where it holds column w-1 and the first slab range.
__device__ __forceinline__ void add_out(uint32_t* out, const uint32_t* ct_b,
                                        int n, int w, int c, uint32_t sum,
                                        bool first) {
  uint32_t x = 0u - sum;
  if (first && c == w - 1) x += ct_b[n];
  atomicAdd(out + c, x);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const uint32_t* __restrict__ table,
              const uint32_t* __restrict__ ct, uint32_t* __restrict__ out,
              int n, int t, int basebit, int w, int slabs) {
  const int b = blockIdx.x;
  const int s0 = blockIdx.y * slabs;
  const int s1 = min(n * t, s0 + slabs);
  const uint32_t* ct_b = ct + (size_t)b * (n + 1);
  const uint32_t offset = 1u << (31 - basebit * t);
  const uint32_t mask = (1u << basebit) - 1;
  const size_t slab_words = (size_t)w << basebit;
  uint32_t acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0;
  for (int s = s0; s < s1; s += kU) {
    uint32_t v[kU][M];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int su = s + u;
      const bool live = su < s1;
      const int i = su / t, j = su - i * t;
      const uint32_t d =
          live ? digit(__ldg(ct_b + i) + offset, 32 - (j + 1) * basebit, mask)
               : 0u;
      const uint32_t* row = table + (size_t)su * slab_words + (size_t)d * w;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = threadIdx.x + m * kThreads;
        v[u][m] = live && c < w ? __ldg(row + c) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] += v[u][m];
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = threadIdx.x + m * kThreads;
    if (c < w)
      add_out(out + (size_t)b * w, ct_b, n, w, c, acc[m], blockIdx.y == 0);
  }
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

template <int CB>
__global__ void __launch_bounds__(kThreads)
staged_kernel(const uint32_t* __restrict__ table,
              const uint32_t* __restrict__ ct, uint32_t* __restrict__ out,
              int n, int t, int basebit, int w, int batch, int slabs,
              bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int base = 1 << basebit;
  const int g_slabs = max(1, kStageRows >> basebit);   // slabs a stage
  const int rows = g_slabs * base;                     // rows a stage
  const int c0 = blockIdx.x * kCols;
  const int s_begin = blockIdx.z * slabs;
  const int s_end = min(n * t, s_begin + slabs);
  const int stages = (s_end - s_begin + g_slabs - 1) / g_slabs;
  const int q = threadIdx.x & 7, r = threadIdx.x >> 3;
  const uint32_t offset = 1u << (31 - basebit * t);
  const uint32_t mask = base - 1;

  // Stage k: rows [(s_begin + k*g_slabs) * base, ...) of the (n*t*base, w)
  // table, columns c0 .. c0+31; rows past s_end and columns past w are not
  // copied (never read, never stored).  16-byte pieces where `vec` (every
  // row 16-byte aligned: w a multiple of 4), else words.
  auto load_stage = [&](int k) {
    uint32_t* buf = smem + (size_t)(k % kStages) * rows * kCols;
    const int row0 = (s_begin + k * g_slabs) * base;
    const int row_end = s_end * base;
    if (vec) {
      for (int e = threadIdx.x; e < rows * kCols / 4; e += kThreads) {
        const int row = row0 + (e >> 3), col = c0 + 4 * (e & 7);
        if (row < row_end && col < w)
          cp_async16(buf + 4 * e, table + (size_t)row * w + col);
      }
      return;
    }
    for (int e = threadIdx.x; e < rows * kCols; e += kThreads) {
      const int row = row0 + (e >> 5), col = c0 + (e & 31);
      if (row < row_end && col < w)
        cp_async4(buf + e, table + (size_t)row * w + col);
    }
  };

  // This thread's ciphertexts b0 + r + 32 k: their words at the current
  // slab's i (a_bar, offset added) and the next i's, loaded one i ahead.
  const int b0 = blockIdx.y * 32 * CB;
  const uint32_t* ct_k[CB];
  bool live[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) {
    const int b = b0 + r + 32 * k;
    live[k] = b < batch;
    ct_k[k] = ct + (size_t)(live[k] ? b : 0) * (n + 1);
  }
  int i = s_begin / t, j = s_begin - i * t;
  uint32_t a_bar[CB], a_next[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) {
    a_bar[k] = live[k] ? __ldg(ct_k[k] + i) + offset : 0u;
    a_next[k] = live[k] && i + 1 < n ? __ldg(ct_k[k] + i + 1) + offset : 0u;
  }
  uint4 acc[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) acc[k] = make_uint4(0, 0, 0, 0);

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < stages) load_stage(k);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < stages; ++k) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
    __syncthreads();
    if (k + kStages - 1 < stages) load_stage(k + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const uint4* buf =
        reinterpret_cast<const uint4*>(smem + (size_t)(k % kStages) * rows *
                                                  kCols);
    const int s_stage = s_begin + k * g_slabs;
    const int g_end = min(g_slabs, s_end - s_stage);
    for (int g = 0; g < g_end; ++g) {
      const int shift = 32 - (j + 1) * basebit;
      const uint4* slab = buf + (size_t)g * base * (kCols / 4) + q;
#pragma unroll
      for (int kk = 0; kk < CB; ++kk) {
        const uint4 v = slab[digit(a_bar[kk], shift, mask) * (kCols / 4)];
        acc[kk].x += v.x;
        acc[kk].y += v.y;
        acc[kk].z += v.z;
        acc[kk].w += v.w;
      }
      if (++j == t) {
        j = 0;
        ++i;
#pragma unroll
        for (int kk = 0; kk < CB; ++kk) {
          a_bar[kk] = a_next[kk];
          a_next[kk] = live[kk] && i + 1 < n ? __ldg(ct_k[kk] + i + 1) + offset
                                             : 0u;
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const bool first = blockIdx.z == 0;
#pragma unroll
  for (int kk = 0; kk < CB; ++kk) {
    if (!live[kk]) continue;
    uint32_t* out_b = out + (size_t)(b0 + r + 32 * kk) * w;
    const uint32_t sums[4] = {acc[kk].x, acc[kk].y, acc[kk].z, acc[kk].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 4 * q + e;
      if (c < w) add_out(out_b, ct_k[kk], n, w, c, sums[e], first);
    }
  }
}

// The launch that plan() picks for a shape.
struct Plan {
  bool staged;
  int width;        // staged: CB ciphertexts a thread; direct: M columns
  dim3 grid;
  int slabs;        // slabs a block
  size_t smem;      // staged: dynamic shared-memory bytes
};

size_t staged_smem(int basebit) {
  const int rows = ((kStageRows >> basebit) > 1 ? kStageRows >> basebit : 1)
                   << basebit;
  return sizeof(uint32_t) * (size_t)kStages * rows * kCols;
}

// B ciphertexts of (n, t, basebit, w): staged where the batch tiles of 32*CB
// ciphertexts would copy fewer rows of each slab (base a tile) than the B
// rows the batch picks from it, else rows straight from device memory.
// Either way the slab ranges split until the grid holds about kFill
// blocks an SM (staged blocks run 3 at a time on an SM, so a few waves
// even out the SMs' shares; direct blocks' partial sums all go to one
// ciphertext's w words).
Plan plan(int n, int t, int basebit, int w, int b, int sms) {
  Plan p{};
  const int slabs = n * t;
  int cb = 1;
  while (cb < 8 && 32 * cb < b) cb *= 2;
  const long tiles = (b + 32L * cb - 1) / (32L * cb);
  p.staged = tiles << basebit < (long)b;
  long blocks;
  int step;                                    // a slab range's multiple
  if (p.staged) {
    p.width = cb;
    p.grid = dim3((w + kCols - 1) / kCols, (unsigned)tiles, 1);
    blocks = (long)p.grid.x * p.grid.y;
    step = (kStageRows >> basebit) > 1 ? kStageRows >> basebit : 1;
    p.smem = staged_smem(basebit);
  } else {
    p.width = (w + kThreads - 1) / kThreads;
    p.grid = dim3((unsigned)b, 1, 1);
    blocks = b;
    step = kU;
  }
  const long fill = (long)(p.staged ? kFillStaged : kFillDirect) * sms;
  long split = (fill + blocks - 1) / blocks;
  if (split < 1) split = 1;
  int per = (int)((slabs + split - 1) / split);
  per = (per + step - 1) / step * step;
  split = (slabs + per - 1) / per;
  p.slabs = per;
  if (p.staged) p.grid.z = (unsigned)split;
  else p.grid.y = (unsigned)split;
  return p;
}

// What plan() and the launch read of the current device: its SMs and its
// opt-in shared memory a block.  Asked once a device (the first kMaxDevices
// devices; any later one on every call) and kept; a failed query returns
// its error and keeps nothing.
constexpr int kMaxDevices = 64;
struct Card {
  int dev, sms, smem_limit;
};
std::atomic<int> g_sms[kMaxDevices];          // 0: not asked yet
std::atomic<int> g_smem_limit[kMaxDevices];

cudaError_t current_card(Card* card) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  int sms = kept ? g_sms[dev].load(std::memory_order_acquire) : 0;
  int limit = kept ? g_smem_limit[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (sms < 1) return cudaErrorInvalidDevice;
    if (kept) {
      g_smem_limit[dev].store(limit, std::memory_order_relaxed);
      g_sms[dev].store(sms, std::memory_order_release);
    }
  }
  *card = Card{dev, sms, limit};
  return cudaSuccess;
}

// The shape's own limits: basebit 1-8 with basebit*t <= 31 (the offset and
// every digit's shift in range), w at most 256*kMaxM, B >= 1.
bool shape_ok(int n, int t, int basebit, int w, int b) {
  return n >= 1 && t >= 1 && basebit >= 1 && basebit <= 8 &&
         basebit * t <= 31 && w >= 1 && w <= kThreads * kMaxM && b >= 1 &&
         (long)n * t <= (1L << 24);
}

// The plan's grid and staged ring within the card's.
bool plan_fits(const Plan& p, const Card& card) {
  return p.grid.y <= 65535 && p.grid.z <= 65535 &&
         (!p.staged || p.smem <= (size_t)card.smem_limit);
}

template <int M>
int launch_direct(const Plan& p, const uint32_t* table, const uint32_t* ct,
                  uint32_t* out, int n, int t, int basebit, int w,
                  cudaStream_t s) {
  direct_kernel<M><<<p.grid, kThreads, 0, s>>>(table, ct, out, n, t, basebit,
                                                w, p.slabs);
  return (int)cudaGetLastError();
}

// The staged kernel's dynamic shared-memory allowance, raised on a device
// only where a launch needs more than it was given there before.
template <int CB>
cudaError_t allow_smem(const Card& card, size_t smem) {
  static std::atomic<int> allowed[kMaxDevices];
  const bool kept = card.dev < kMaxDevices;
  if (kept && allowed[card.dev].load(std::memory_order_relaxed) >= (int)smem)
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      staged_kernel<CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess && kept)
    allowed[card.dev].store((int)smem, std::memory_order_relaxed);
  return e;
}

template <int CB>
int launch_staged(const Plan& p, const Card& card, const uint32_t* table,
                  const uint32_t* ct, uint32_t* out, int n, int t,
                  int basebit, int w, int b, cudaStream_t s) {
  const cudaError_t e = allow_smem<CB>(card, p.smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = w % 4 == 0 && (uintptr_t)table % 16 == 0;
  staged_kernel<CB><<<p.grid, kThreads, p.smem, s>>>(table, ct, out, n, t,
                                                     basebit, w, b, p.slabs,
                                                     vec);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 where tfhe_key_switch takes a table (n, t, 2^basebit, w) and B
// ciphertexts on the current device, 0 where the shape is beyond the
// kernel's limits (the plain path then runs), and minus the CUDA error
// where the device could not be asked (the caller raises).
extern "C" int tfhe_key_switch_fits(int n, int t, int basebit, int w, int b) {
  if (!shape_ok(n, t, basebit, w, b)) return 0;
  Card card;
  const cudaError_t e = current_card(&card);
  if (e != cudaSuccess) return -(int)e;
  return plan_fits(plan(n, t, basebit, w, b, card.sms), card) ? 1 : 0;
}

// table (n, t, 2^basebit, w) int32 words, ct (B, n+1) int32, out (B, w)
// int32, all contiguous on the current device; the shape must be one that
// tfhe_key_switch_fits accepts.  Zeroes out and launches on `stream`;
// returns the first CUDA error (cudaErrorInvalidValue for other
// arguments).
extern "C" int tfhe_key_switch(const void* table, const void* ct, void* out,
                               int n, int t, int basebit, int w, int b,
                               void* stream) {
  if (!shape_ok(n, t, basebit, w, b)) return (int)cudaErrorInvalidValue;
  Card card;
  cudaError_t e = current_card(&card);
  if (e != cudaSuccess) return (int)e;
  const Plan p = plan(n, t, basebit, w, b, card.sms);
  if (!plan_fits(p, card)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)b * w, s);
  if (e != cudaSuccess) return (int)e;
  const uint32_t* tab = (const uint32_t*)table;
  const uint32_t* c = (const uint32_t*)ct;
  uint32_t* o = (uint32_t*)out;
  if (p.staged) {
    switch (p.width) {
      case 1:
        return launch_staged<1>(p, card, tab, c, o, n, t, basebit, w, b, s);
      case 2:
        return launch_staged<2>(p, card, tab, c, o, n, t, basebit, w, b, s);
      case 4:
        return launch_staged<4>(p, card, tab, c, o, n, t, basebit, w, b, s);
      default:
        return launch_staged<8>(p, card, tab, c, o, n, t, basebit, w, b, s);
    }
  }
  switch (p.width) {
    case 1: return launch_direct<1>(p, tab, c, o, n, t, basebit, w, s);
    case 2: return launch_direct<2>(p, tab, c, o, n, t, basebit, w, s);
    case 3: return launch_direct<3>(p, tab, c, o, n, t, basebit, w, s);
    case 4: return launch_direct<4>(p, tab, c, o, n, t, basebit, w, s);
    case 5: return launch_direct<5>(p, tab, c, o, n, t, basebit, w, s);
    case 6: return launch_direct<6>(p, tab, c, o, n, t, basebit, w, s);
    case 7: return launch_direct<7>(p, tab, c, o, n, t, basebit, w, s);
    default: return launch_direct<8>(p, tab, c, o, n, t, basebit, w, s);
  }
}
