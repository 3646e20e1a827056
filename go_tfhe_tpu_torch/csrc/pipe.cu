// K9: the half-batch pipelined blind-rotation step, transposed layout, for
// Hopper (sm_90a).
//
// Replaces: go_tfhe_tpu/ops/pallas_pipe.py, pipe_step and its kernel body
// _pipe_kernel (the Pallas TPU kernel of blind_rotate_pipe,
// engine.PREFER_PIPE).
//
// One launch does two independent things for the two halves X and Y of a
// ciphertext batch, in K1/K2's transposed layouts (acc (2, N, B), digits
// (2L*N, B) int8, rows [(c, lv)] * N + n):
//   * X: out_x = acc_x + digits_x (*) band, K2's external product
//     (csrc/extprod_t.cu) at one digit limb, against the port's one band
//     layout (2, 2L, 2N) (ops/cuda_t.py pack_bsk_band_t), skipping the `lo`
//     key limbs the band was packed without;
//   * Y: dig_y = the digits of X^amt_y . acc_y - acc_y, K1's rotate +
//     decompose (csrc/rotdec_t.cu) at one digit limb.
// The halves share no data, and that is the whole point of the TPU kernel:
// the rotation of one half could run under the contraction of the other.
// On the TPU it did not (Mosaic serialised the two units within a cell,
// pallas_pipe.py:27-37).  Here the two are different blocks of one grid:
// a block id picks either one 64 x 64 output tile of X's product (K2's
// tensor-core tile, extprod_tile.cuh, templated as K2 uses it) or a 128-
// ciphertext x rows_per-coefficient tile of Y's rotation (K1's one thread
// per (n, b), both channels), the two kinds interleaved in block order and
// about as many of each, so that the SMs hold both at once and Y's memory
// traffic overlaps X's MMAs.  Every block gets the tile's dynamic shared
// memory; Y blocks leave it unused.
//
// What bounds it on this card: X's int8 tensor-core operations (2 * (B/2)
// * N * 2L * N multiply-adds per limb pair, half of K2's at the same B); Y
// moves 16 bytes in and 2L bytes out per (n, b) of its half.  Ragged
// halves, and halves of unequal size (an odd batch), are masked by each
// part.

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"

namespace {

constexpr int kRotCols = kExtprodThreads;     // ciphertexts per Y tile

// K1 on rows [r0, r1) of Y's tile: one thread per ciphertext, both
// channels, nd = 1 (rotdec_t.cu's arithmetic).
__device__ __forceinline__ void rotdec_rows(
    const uint32_t* __restrict__ acc, const int32_t* __restrict__ amounts,
    int8_t* __restrict__ out, int n, int b, int l, int bgbit,
    uint32_t offset, int bi, int r0, int r1) {
  if (bi >= b) return;
  int k2 = amounts[bi] % (2 * n);
  if (k2 < 0) k2 += 2 * n;
  const int r = k2 % n;
  const bool flip = k2 >= n;
  const size_t plane = (size_t)n * b;
  const uint32_t mask = (1u << bgbit) - 1u;
  const int32_t half_bg = 1 << (bgbit - 1);
  for (int ni = r0; ni < r1; ++ni) {
    int src = ni - r;
    const bool wrapped = src < 0;
    if (wrapped) src += n;
    const bool neg = wrapped != flip;
    for (int c = 0; c < 2; ++c) {
      const uint32_t x0 = acc[c * plane + (size_t)ni * b + bi];
      uint32_t xr = acc[c * plane + (size_t)src * b + bi];
      if (neg) xr = ~xr;
      const uint32_t tmp = xr - x0 + offset;
      for (int lv = 0; lv < l; ++lv) {
        const int sh = 32 - (lv + 1) * bgbit;
        const int32_t d = (int32_t)((tmp >> sh) & mask) - half_bg;
        out[((size_t)(c * l + lv) * n + ni) * b + bi] = (int8_t)d;
      }
    }
  }
}

// Block of kExtprodThreads threads (1-D).  Block id -> task: ids
// [0, 2*min(nx, ny)) alternate X tile, Y tile; the rest are the remaining
// tiles of the longer list.  X tiles: (b tile, n tile, channel), b fastest;
// Y tiles: (b tile of kRotCols, row chunk of rows_per), b fastest.
template <int LO>
__global__ void __launch_bounds__(kExtprodThreads, kBlocksPerSM)
pipe_kernel(const int8_t* __restrict__ digits_x,
            const int32_t* __restrict__ band,
            const uint32_t* __restrict__ acc_x, uint32_t* __restrict__ out_x,
            const uint32_t* __restrict__ acc_y,
            const int32_t* __restrict__ amt_y, int8_t* __restrict__ dig_y,
            int n, int bx, int by, int l, int bgbit, uint32_t offset,
            int nx, int ny, int rows_per) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int id = blockIdx.x;
  const int pairs = nx < ny ? nx : ny;
  bool is_x;
  int t;
  if (id < 2 * pairs) {
    is_x = (id & 1) == 0;
    t = id >> 1;
  } else {
    is_x = nx > ny;
    t = id - pairs;
  }
  if (is_x) {
    const int xbt = (bx + TB - 1) / TB;
    const int bt = t % xbt;
    const int nt = (t / xbt) % (n / TN);
    const int c = t / (xbt * (n / TN));
    const int l2 = 2 * l;
    const size_t chan = (size_t)c * n * bx;
    extprod_tile<1, LO>(digits_x, band + (size_t)c * l2 * 2 * n,
                        acc_x + chan, out_x + chan, n, bx, l2, nt * TN,
                        bt * TB, smem);
  } else {
    const int ybt = (by + kRotCols - 1) / kRotCols;
    const int bt = t % ybt;
    const int r0 = (t / ybt) * rows_per;
    const int r1 = r0 + rows_per < n ? r0 + rows_per : n;
    rotdec_rows(acc_y, amt_y, dig_y, n, by, l, bgbit, offset,
                bt * kRotCols + (int)threadIdx.x, r0, r1);
  }
}

}  // namespace

// digits_x (2l*N, bx) int8, band (2, 2l, 2N) int32 packed without its `lo`
// lowest key limbs, acc_x and out_x (2, N, bx) uint32, acc_y (2, N, by)
// uint32, amt_y (by,) int32, dig_y (2l*N, by) int8; N a multiple of TN,
// 2l*N < 2^15, 1 <= bgbit <= 8, lo 0 or 1.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for other arguments).
extern "C" int tfhe_pipe_step(const void* digits_x, const void* band,
                              const void* acc_x, void* out_x,
                              const void* acc_y, const void* amt_y,
                              void* dig_y, int n, int bx, int by, int l,
                              int bgbit, unsigned int offset, int lo,
                              void* stream) {
  if (n % TN || 2 * l * n >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const int nx = bx > 0 ? ((bx + TB - 1) / TB) * (n / TN) * 2 : 0;
  const int ybt = (by + kRotCols - 1) / kRotCols;
  // Y's row chunks: about as many Y tiles as X tiles.
  int rows_per = 1;
  if (nx > 0) rows_per = (int)(((long long)ybt * n + nx - 1) / nx);
  if (rows_per < 1) rows_per = 1;
  const int ny = by > 0 ? ybt * ((n + rows_per - 1) / rows_per) : 0;
  if (nx + ny == 0) return 0;
  return dispatch_nd_lo(1, lo, [&](auto, auto lo_c) {
    constexpr int LO = decltype(lo_c)::value;
    return launch_tile(pipe_kernel<LO>, dim3(nx + ny),
                       extprod_smem_bytes<1>(), (cudaStream_t)stream,
                       (const int8_t*)digits_x, (const int32_t*)band,
                       (const uint32_t*)acc_x, (uint32_t*)out_x,
                       (const uint32_t*)acc_y, (const int32_t*)amt_y,
                       (int8_t*)dig_y, n, bx, by, l, bgbit,
                       (uint32_t)offset, nx, ny, rows_per);
  });
}
