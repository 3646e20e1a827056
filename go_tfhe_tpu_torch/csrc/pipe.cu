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
// tensor-core tile, extprod_tile.cuh, templated as K2 uses it) or one
// (tile of kYTile ciphertexts, channel) of Y's rotation, which runs K1's
// staged-column code (rotdec_col.cuh rotdec_tile, the very function K1 and
// K4 run): the block copies the tile's N-row channel column into shared
// memory with cp.async, so that each accumulator word crosses device
// memory once, gathers there in the bank-conflict-free read order, and
// writes each digit row's 4 ciphertexts as one 32-bit word.  Every X tile
// comes first and the Y blocks after them: the X tiles leave part of their
// last wave empty (at 128bit_fast, halves of 2048, 1024 tiles fill 2.6
// waves of 132 SMs x 3 blocks), and the short Y blocks fill it, so that
// the call takes about the X half's time.  (Interleaving the two kinds
// and Y tiles of 8 measured slower: PERF.md §6.)  The launch has one
// dynamic shared-memory size for both kinds, the larger need: a Y block's
// column, 4 * (N + 1) * kYTile bytes (65,600 at N 1024), against the
// tile's 27,184; the tile's registers hold an SM at 2-3 blocks either way
// (tfhe_pipe_occupancy reports it).
//
// What bounds it on this card: X's int8 tensor-core operations (2 * (B/2)
// * N * 2L * N multiply-adds per limb pair, half of K2's at the same B); Y
// moves 8 bytes in and 2L bytes out per (n, b) of its half.  Ragged
// halves, and halves of unequal size (an odd batch), are masked by each
// part.  The plan (block counts, shared memory) is the wrapper's
// (ops/cuda_pipe.pipe_plan); the entry point refuses one that is not
// this kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "extprod_tile.cuh"
#include "rotdec_col.cuh"

namespace {

// Ciphertexts a Y tile (K1's width at N 1024, rotdec_t_plan).
constexpr int kYTile = 16;

// Block of kExtprodThreads threads (1-D).  Block ids [0, nx) are the X
// tiles (b tile, n tile, channel), b fastest; ids [nx, nx + ny) the Y
// blocks (tile of kYTile ciphertexts, channel), tile fastest.
template <int LO>
__global__ void __launch_bounds__(kExtprodThreads, kBlocksPerSM)
pipe_kernel(const int8_t* __restrict__ digits_x,
            const int32_t* __restrict__ band,
            const uint32_t* __restrict__ acc_x, uint32_t* __restrict__ out_x,
            const uint32_t* __restrict__ acc_y,
            const int32_t* __restrict__ amt_y, int8_t* __restrict__ dig_y,
            int n, int bx, int by, int l, int bgbit, uint32_t offset,
            int nx, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int id = blockIdx.x;
  if (id < nx) {
    const int xbt = (bx + TB - 1) / TB;
    const int bt = id % xbt;
    const int nt = (id / xbt) % (n / TN);
    const int c = id / (xbt * (n / TN));
    const int l2 = 2 * l;
    const size_t chan = (size_t)c * n * bx;
    extprod_tile<1, LO>(digits_x, band + (size_t)c * l2 * 2 * n,
                        acc_x + chan, out_x + chan, n, bx, l2, nt * TN,
                        bt * TB, smem);
  } else {
    const int t = id - nx;
    const int ytiles = (by + kYTile - 1) / kYTile;
    rotdec_col::rotdec_tile<kYTile>(acc_y, amt_y, dig_y, n, 1, by, l, bgbit,
                                    offset, 1, vec, false, t % ytiles,
                                    t / ytiles, ytiles, smem);
  }
}

// The dynamic shared memory a launch needs: the larger of the tile's and
// a Y block's column.
size_t pipe_smem_bytes(int n) {
  const size_t tile = extprod_smem_bytes<1>();
  const size_t col = rotdec_col::col_smem_bytes(1, n, kYTile);
  return tile > col ? tile : col;
}

}  // namespace

// digits_x (2l*N, bx) int8, band (2, 2l, 2N) int32 packed without its `lo`
// lowest key limbs, acc_x and out_x (2, N, bx) uint32, acc_y (2, N, by)
// uint32, amt_y (by,) int32, dig_y (2l*N, by) int8 (4-byte aligned); N a
// multiple of TN and of 32 / kYTile, 2l*N < 2^15, 1 <= bgbit <= 8, lo 0
// or 1.  The plan: nx X tiles and ny Y blocks, `smem` bytes of dynamic
// shared memory a block; they must be this kernel's (ceil(bx / TB) * N/TN
// * 2, ceil(by / kYTile) * 2, at least pipe_smem_bytes(N) and at most the
// card's).  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for other arguments).
extern "C" int tfhe_pipe_step(const void* digits_x, const void* band,
                              const void* acc_x, void* out_x,
                              const void* acc_y, const void* amt_y,
                              void* dig_y, int n, int bx, int by, int l,
                              int bgbit, unsigned int offset, int lo, int nx,
                              int ny, int smem, void* stream) {
  if (n % TN || 2 * l * n >= (1 << 15) || bx < 0 || by < 0 ||
      !rotdec_col::plan_ok(kYTile, n) || (uintptr_t)dig_y % 4 ||
      nx != ((bx + TB - 1) / TB) * (n / TN) * 2 ||
      ny != ((by + kYTile - 1) / kYTile) * 2 ||
      (size_t)smem < pipe_smem_bytes(n) || smem > rotdec_col::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (nx + ny == 0) return 0;
  const bool vec = rotdec_col::vec_ok(acc_y, dig_y, by);
  return dispatch_nd_lo(1, lo, [&](auto, auto lo_c) {
    constexpr int LO = decltype(lo_c)::value;
    return launch_tile(pipe_kernel<LO>, dim3(nx + ny), (size_t)smem,
                       (cudaStream_t)stream, (const int8_t*)digits_x,
                       (const int32_t*)band, (const uint32_t*)acc_x,
                       (uint32_t*)out_x, (const uint32_t*)acc_y,
                       (const int32_t*)amt_y, (int8_t*)dig_y, n, bx, by, l,
                       bgbit, (uint32_t)offset, nx, vec);
  });
}

// The blocks of pipe_kernel<lo> that one SM of the current device holds
// at `smem` bytes of dynamic shared memory a block
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.  Returns
// a CUDA error code.
extern "C" int tfhe_pipe_occupancy(int lo, int smem, int* blocks) {
  return dispatch_nd_lo(1, lo, [&](auto, auto lo_c) {
    constexpr int LO = decltype(lo_c)::value;
    auto kernel = pipe_kernel<LO>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, kernel, kExtprodThreads, (size_t)smem);
    return (int)e;
  });
}
