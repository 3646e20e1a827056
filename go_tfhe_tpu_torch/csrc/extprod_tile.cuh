// One output tile of the transposed external product on the s8 tensor
// cores, shared by K2 (extprod_t.cu), K5 (extprod_ext_t.cu) and the X half
// of K9 (pipe.cu).
//
// For one channel's band and one block of digits, a 128-thread block
// computes a TN (coefficients) x TB (ciphertexts) tile of
//   out[n, b] = acc[n, b] + sum_{r < l2, j < N} band[r, N+n-j] * d[r, j, b]
// mod 2^32, with d[r, j, b] = sum_i limb_i * 256^i from the int8 digit limbs
// (ND*l2*N, B), limb-major rows [(i, r)] * N + j.
//
// Exact int8 limb pairs, the TPU kernel's arithmetic (pallas_t.py,
// _extprod_t_kernel): a band word splits into four balanced int8 limbs k_l
// with sum_l k_l * 256^l == word mod 2^32 (byte l of word + 0x80808080,
// minus 128), so
//   band * d == sum_{i + l < 4} 256^(i+l) * (k_l * limb_i)   (mod 2^32);
// pairs of weight >= 2^32 vanish.  Key limbs below LO are zero (the band
// was packed without them, ops/cuda_t.py pack_bsk_band_t) and are skipped.
// Every remaining pair is a run of mma.sync m16n8k32 s8 x s8 -> s32 into
// the s32 sum of its weight w = i + l; the sums fold into u32 once, after
// the contraction (sum_w acc_w << 8w, wrapping).  No s32 sum can overflow:
// it takes at most 4 pairs x l2*N terms of magnitude <= 2^14, and the
// wrappers refuse l2*N >= 2^15.
//
// Per stage (one BSK row r, TJ = 64 contraction indices j0 .. j0+63):
// * the key: the TN + TJ - 1 band words that the stage's Toeplitz block
//   T[n, j] = band[N + n - j] reads are split into limbs and stored
//   REVERSED per limb, V[u] = limb(band[w0 + TN+TJ-2 - u]), so that row n
//   of the block is the run V[(TN-1 - (n-n0)) + (j-j0)] of consecutive
//   bytes and an A-fragment register (4 consecutive j of one row) is one
//   32-bit load.  Rows start at every byte offset, so each limb's window is
//   kept in four copies shifted by 0..3 bytes; all of a thread's rows start
//   at one offset mod 4 and read one copy.  (The TPU kernel builds its
//   Toeplitz tile with strided rolls; this is the window it rolls.)
// * the digits: each limb plane's TJ x TB chunk, b-contiguous in device
//   memory, is transposed into [b][j] rows (4 x 4 byte blocks through
//   __byte_perm) so that a B-fragment register (4 consecutive j of one
//   ciphertext) is one 32-bit load.  The word index is XOR-swizzled by b so
//   that the transposing stores and the fragment loads are both free of
//   bank conflicts.  Each digit limb is its own B operand.
// A stage's digit rows and band window are first copied as they are, with
// cp.async, into a ring of three raw buffers; stage s + 2 is in flight and
// stage s + 1 is transposed into the second of two operand buffers while
// the warps run stage s's MMAs, with one __syncthreads per stage.  (Loads
// into registers for the next stage left the copies' latency exposed: on
// an H100 they cost K2 0.86 ms per call at 128bit_fast, B 4096, against
// 0.73 ms with the ring.)
//
// The 4 warps split the 64 x 64 tile 2 (n) x 2 (b); a warp owns 32 x 32
// outputs, 2 x 4 MMA tiles, and one s32 accumulator set of 32 registers per
// weight.  The accumulators hold a thread at 164-253 registers, so the tile
// is small enough for two blocks per SM, whose stage barriers then overlap
// each other's MMAs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TN = 64;    // output coefficients per block
constexpr int TB = 64;    // ciphertexts per block
constexpr int TJ = 64;    // contraction depth per stage
constexpr int kExtprodThreads = 128;   // 4 warps
constexpr int kBlocksPerSM = 2;

constexpr int kWin = TN + TJ - 1;             // band words per stage
constexpr int kCopyWords = 40;                // one shifted copy (32 used)
constexpr int kLimbWords = 4 * kCopyWords;    // a limb's four copies
constexpr int kKeyWords = 4 * kLimbWords;     // four key limbs
constexpr int kRowWords = TJ / 4;             // digit words per ciphertext
constexpr int kPlaneWords = TB * kRowWords;   // one digit limb's chunk
// per thread and digit limb: 4 x 4 blocks to transpose, 16-byte pieces to
// copy (both 2)
constexpr int kBlocks = TJ * TB / 16 / kExtprodThreads;
constexpr int kPieces = TJ * TB / 16 / kExtprodThreads;
constexpr int kRawBandWords = 4 * 33;         // kWin words, and the tail
                                              // that copy 3's last word reads
constexpr int kRawStages = 3;                 // copies two stages ahead

// One stage of MMA operands, and one raw stage as copied.
template <int ND>
__host__ __device__ constexpr int stage_words() {
  return kKeyWords + ND * kPlaneWords;
}
template <int ND>
__host__ __device__ constexpr int raw_words() {
  return ND * kPlaneWords + kRawBandWords;
}

// Dynamic shared memory of one block: kRawStages raw stages, two operand
// stages.
template <int ND>
__host__ __device__ constexpr size_t extprod_smem_bytes() {
  return sizeof(uint32_t) *
         (size_t)(kRawStages * raw_words<ND>() + 2 * stage_words<ND>());
}

// Rows r0..r3 of 4 bytes -> columns: byte t of w[e] = byte e of r_t.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&w)[4]) {
  const uint32_t a = __byte_perm(r0, r1, 0x5140);
  const uint32_t b = __byte_perm(r0, r1, 0x7362);
  const uint32_t c = __byte_perm(r2, r3, 0x5140);
  const uint32_t d = __byte_perm(r2, r3, 0x7362);
  w[0] = __byte_perm(a, c, 0x5410);
  w[1] = __byte_perm(a, c, 0x7632);
  w[2] = __byte_perm(b, d, 0x5410);
  w[3] = __byte_perm(b, d, 0x7632);
}

// The 4 x 4 digit block u of this thread: 4 rows (j) x 4 ciphertexts (b).
// A warp covers 4 j-quads x 8 b-quads; with the raw rows read in an order
// rotated by jq and the transposed words stored in an order rotated by bq,
// neither side has bank conflicts.
__device__ __forceinline__ void block_coords(int tid, int u, int& jq,
                                             int& bq) {
  const int g = tid + u * kExtprodThreads;
  const int w = g >> 5, lane = g & 31;
  jq = (lane >> 3) + 4 * (w & 3);
  bq = (lane & 7) + 8 * (w >> 2);
}

// Word (bb, jw) of a digit plane in shared memory.
__device__ __forceinline__ int dig_word(int bb, int jw) {
  return bb * kRowWords + (jw ^ (4 * ((bb >> 1) & 3)));
}

// Raw stage: the digit chunk as in device memory, [i][j][b] bytes (rows of
// TB bytes, 16-byte pieces XOR-swizzled by row so that the transposing
// reads are free of bank conflicts), then the band window reversed,
// raw_band[u] = band[w0 + kWin - 1 - u].
__device__ __forceinline__ int raw_word(int j, int w) {
  return j * (TB / 4) + (w ^ (8 * ((j >> 3) & 1)));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for all but the newest group of this thread's copies.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start the copies of one stage (BSK row r, contraction indices j0 ..
// j0+TJ-1) into the raw buffer `raw`.  With B a multiple of 16 the digit
// rows are copied asynchronously in 16-byte pieces (a warp: 8 whole rows);
// otherwise byte by byte, waiting for the loads here.
template <int ND>
__device__ __forceinline__ void fetch_stage(
    uint32_t* __restrict__ raw, const int8_t* __restrict__ digits,
    const int32_t* __restrict__ band_c, int n, int b, size_t plane_rows,
    int r, int j0, int n0, int b0, int tid) {
  const size_t row0 = (size_t)r * n + j0;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int pc = tid + u * kExtprodThreads;
      const int j = pc / (TB / 16), piece = pc % (TB / 16);
      const int bg = b0 + 16 * piece;
      const int8_t* src = digits + (i * plane_rows + row0 + j) * b + bg;
      uint32_t* dst = raw + i * kPlaneWords + raw_word(j, 4 * piece);
      if (b % 16 == 0) {                 // then bg < b implies bg + 15 < b
        cp_async16(dst, bg < b ? src : digits, bg < b ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (bg + e < b) w[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  // the band window, reversed: word u of the raw band holds V[u]
  const int w0 = n + n0 - j0 - (TJ - 1);     // >= 1; w0 + kWin - 1 <= 2N-1
  const int32_t* last = band_c + (size_t)r * 2 * n + w0 + kWin - 1;
  for (int u = tid; u < kRawBandWords; u += kExtprodThreads)
    cp_async4(raw + ND * kPlaneWords + u, u < kWin ? last - u : band_c,
              u < kWin ? 4 : 0);
}

// Raw stage -> the MMA operands: the digit limbs transposed to [b][j] rows
// (dig_word), the band window split into balanced limbs, four byte-shifted
// copies per limb.
template <int ND, int LO>
__device__ __forceinline__ void transpose_stage(
    uint32_t* __restrict__ st, const uint32_t* __restrict__ raw, int tid) {
  uint32_t* dig_s = st + kKeyWords;
#pragma unroll
  for (int u = 0; u < kBlocks; ++u) {
    int jq, bq;
    block_coords(tid, u, jq, bq);
    const int rot = (bq >> 1) & 3;       // store order: no bank conflicts
    const bool odd = jq & 1;             // read order: no bank conflicts
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const uint32_t* plane = raw + i * kPlaneWords;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jq + (k ^ (int)odd);
        v[k] = plane[raw_word(j, bq)];
      }
      uint32_t col[4];
      transpose4(odd ? v[1] : v[0], odd ? v[0] : v[1], odd ? v[3] : v[2],
                 odd ? v[2] : v[3], col);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = (t + rot) & 3;
        const uint32_t c = e == 0 ? col[0] : e == 1 ? col[1]
                         : e == 2 ? col[2] : col[3];
        dig_s[i * kPlaneWords + dig_word(4 * bq + e, jq)] = c;
      }
    }
  }
  // copy q, word x: V[4x+q .. 4x+q+3]; a warp reads 35 consecutive words
  const uint32_t* vband = raw + ND * kPlaneWords;
  const int q = tid & 3, x = tid >> 2;
  uint32_t k[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    k[e] = (vband[4 * x + q + e] + 0x80808080u) ^ 0x80808080u;
  // balanced limbs: the bytes of word + 0x80808080, each minus 128
  uint32_t limb[4];
  transpose4(k[0], k[1], k[2], k[3], limb);
#pragma unroll
  for (int l = LO; l < 4; ++l)
    st[l * kLimbWords + q * kCopyWords + x] = limb[l];
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4],
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage's MMAs for this warp's 32 x 32 outputs.  Fragment layouts of
// m16n8k32 (PTX ISA): lane = 4g + t; A register k holds row g (+8 for k
// odd), columns 4t..4t+3 (+16 for k >= 2); B register k holds column g,
// rows 4t..4t+3 (+16 for k = 1).
template <int ND, int LO>
__device__ __forceinline__ void mma_stage(
    const uint32_t* __restrict__ st, int lane, int wm, int wb,
    int32_t (&acc)[4 - LO][2][4][4]) {
  const uint32_t* dig_s = st + kKeyWords;
  const int g = lane >> 2, t = lane & 3;
  const int q = 3 ^ (g & 3);             // (TN - 1 - row) mod 4
#pragma unroll
  for (int kk = 0; kk < TJ / 32; ++kk) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      if (LO > 3 - i) continue;          // every pair of this limb vanishes
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int bb = wb * 32 + nt * 8 + g;
        const uint32_t* plane = dig_s + i * kPlaneWords;
        bf[nt][0] = plane[dig_word(bb, kk * 8 + t)];
        bf[nt][1] = plane[dig_word(bb, kk * 8 + 4 + t)];
      }
#pragma unroll
      for (int l = LO; l < 4 - i; ++l) {
        const uint32_t* cp = st + l * kLimbWords + q * kCopyWords;
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // row nn starts at V[TN-1-nn]; s0 = q mod 4, so (s0 - q) / 4 is
          // the word of copy q that holds V[s0 .. s0+3]
          const int nn = wm * 32 + mt * 16 + g;
          const int s0 = TN - 1 - nn + kk * 32 + 4 * t - q;
          af[mt][0] = cp[s0 >> 2];
          af[mt][1] = cp[(s0 - 8) >> 2];
          af[mt][2] = cp[(s0 + 16) >> 2];
          af[mt][3] = cp[(s0 + 8) >> 2];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_s8(acc[i + l - LO][mt][nt], af[mt], bf[nt]);
      }
    }
  }
}

// Block of kExtprodThreads threads (1-D); tile origin (n0, b0).  digits,
// acc and out point at this block's (channel, LUT block) slice; band_c at
// the channel's band (l2, 2N).  Rows of acc and out are N coefficients of
// B words.  ND: limbs per digit (1..4); LO: key limbs dropped (0 or 1).
// smem: extprod_smem_bytes<ND>() of dynamic shared memory.
template <int ND, int LO>
__device__ __forceinline__ void extprod_tile(
    const int8_t* __restrict__ digits, const int32_t* __restrict__ band_c,
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ out, int n,
    int b, int l2, int n0, int b0, uint32_t* smem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wb = warp >> 1;
  const size_t plane_rows = (size_t)l2 * n;           // rows per limb plane
  const int per_row = n / TJ;
  const int stages = l2 * per_row;

  int32_t sums[4 - LO][2][4][4];
#pragma unroll
  for (int w = 0; w < 4 - LO; ++w)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) sums[w][mt][nt][k] = 0;

  // Raw stages ring through kRawStages buffers: stage t is copied during
  // the MMAs of stage t - 2, transposed during those of stage t - 1.
  uint32_t* ops = smem + kRawStages * raw_words<ND>();
  auto raw = [&](int t) { return smem + (t % kRawStages) * raw_words<ND>(); };
  auto fetch = [&](int t) {
    if (t < stages)
      fetch_stage<ND>(raw(t), digits, band_c, n, b, plane_rows, t / per_row,
                      (t % per_row) * TJ, n0, b0, tid);
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  cp_async_wait_one();
  __syncthreads();
  transpose_stage<ND, LO>(ops, raw(0), tid);
  for (int s = 0; s < stages; ++s) {
    fetch(s + 2);               // into the buffer of stage s - 1, consumed
    cp_async_wait_one();        // stage s + 1 has landed
    __syncthreads();
    if (s + 1 < stages)
      transpose_stage<ND, LO>(ops + ((s + 1) & 1) * stage_words<ND>(),
                              raw(s + 1), tid);
    mma_stage<ND, LO>(ops + (s & 1) * stage_words<ND>(), lane, wm, wb,
                      sums);
  }

  // C fragment: register k holds row g (+8 for k >= 2), column 2t + (k & 1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int nn = n0 + wm * 32 + mt * 16 + g + 8 * (k >> 1);
        const int bg = b0 + wb * 32 + nt * 8 + 2 * t + (k & 1);
        uint32_t v = 0;
#pragma unroll
        for (int w = 0; w < 4 - LO; ++w)
          v += (uint32_t)sums[w][mt][nt][k] << (8 * (w + LO));
        const size_t at = (size_t)nn * b + bg;
        if (bg < b) out[at] = acc[at] + v;
      }
}

// Calls f(ND, LO) as integral constants for 1 <= nd <= 4, 0 <= lo <= 1;
// cudaErrorInvalidValue for any other pair.
template <typename F>
int dispatch_nd_lo(int nd, int lo, F&& f) {
  using std::integral_constant;
  switch (lo == 0 || lo == 1 ? 2 * nd + lo : -1) {
    case 2: return f(integral_constant<int, 1>{}, integral_constant<int, 0>{});
    case 3: return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
    case 4: return f(integral_constant<int, 2>{}, integral_constant<int, 0>{});
    case 5: return f(integral_constant<int, 2>{}, integral_constant<int, 1>{});
    case 6: return f(integral_constant<int, 3>{}, integral_constant<int, 0>{});
    case 7: return f(integral_constant<int, 3>{}, integral_constant<int, 1>{});
    case 8: return f(integral_constant<int, 4>{}, integral_constant<int, 0>{});
    case 9: return f(integral_constant<int, 4>{}, integral_constant<int, 1>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches a kernel built on the tile with `smem` bytes of dynamic shared
// memory (allowing more than 48 KB first); returns cudaGetLastError().
template <typename... KArgs, typename... Args>
int launch_tile(void (*kernel)(KArgs...), dim3 grid, size_t smem,
                cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kExtprodThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
