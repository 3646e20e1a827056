"""K9's launch plan and addressing (ops/cuda_pipe.pipe_plan, csrc/pipe.cu)
on the CPU.

A CUDA kernel cannot run here, so these cases check what surrounds it and a
model of it:

* the plan of every profile that route (c) serves (``engine.PREFER_PIPE``:
  single-limb digits, no extension) fits the card's shared memory at
  halves of 1 to 2048, equal or not, and the plan refuses what the kernel
  does not take;
* a model of pipe_kernel's block id -> task map gives every X tile and
  every (Y tile, channel) block exactly one block of the grid, the X
  tiles first;
* a numpy model of a Y block (rotdec_col.cuh rotdec_tile as pipe_kernel
  runs it: 128 threads, one channel of a tile of 16 ciphertexts)
  writes every digit once, equal to the plain K1 (cuda_t
  .rotate_decompose_t_ref), with each thread's read order the one the
  bank-conflict-free gather needs, and every warp's shared-memory gather
  free of bank conflicts.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import params  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_pipe, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32  # noqa: E402

THREADS = 128                  # pipe.cu: kExtprodThreads
TILE = 64                      # extprod_tile.cuh TN and TB
HALVES = [(1, 1), (3, 3), (17, 17), (2047, 2047), (2048, 2048),
          (2048, 2047), (2047, 2048), (1, 0), (0, 3), (2048, 1)]


def _route_c_profiles():
    return sorted({p.name: p for p in params.PROFILES.values()
                   if p.poly_extend_factor == 1 and p.digit_limbs == 1
                   }.items())


@pytest.mark.parametrize("bx,by", HALVES)
def test_plan_fits_every_route_c_profile(bx, by):
    """Y tiles of 16 (K1's width), the launch's shared memory the larger of
    the tile's 27,184 bytes and a Y block's column of N + 1 words a
    ciphertext, within the card's 232,448; the block counts cover both
    halves."""
    profiles = dict(_route_c_profiles())
    assert {"80bit", "80bit_fast", "110bit", "110bit_fast", "128bit",
            "128bit_fast", "test_fast", "test_block", "test_nibble",
            "test_pbs"} == profiles.keys()
    for _, p in profiles.items():
        plan = cuda_pipe.pipe_plan(p.n, bx, by)
        assert plan.tb == 16
        assert plan.smem == max(cuda_pipe.TILE_SMEM, 4 * (p.n + 1) * 16)
        assert plan.smem <= cuda_t.SMEM_LIMIT
        assert plan.x_blocks == -(-bx // TILE) * (p.n // TILE) * 2
        assert plan.y_blocks == -(-by // 16) * 2
    at_1024 = cuda_pipe.pipe_plan(1024, 2048, 2048)
    assert (at_1024.smem, at_1024.x_blocks,
            at_1024.y_blocks) == (65600, 1024, 256)


def test_plan_refuses_what_the_kernel_does_not_take():
    """An N that is not a multiple of the tile's 64, a negative half, and
    a column beyond the card's shared memory (N 4096 at 16 words a row;
    N 2048 fits)."""
    for args, what in (((96, 8, 8), "multiple of 64"),
                       ((1024, -1, 8), "halves"),
                       ((1024, 8, -1), "halves"),
                       ((4096, 8, 8), "shared memory")):
        with pytest.raises(ValueError, match=what):
            cuda_pipe.pipe_plan(*args)
    assert cuda_pipe.pipe_plan(2048, 8, 8).smem == 4 * 2049 * 16


# ---------------------------------------------------------------------------
# The block id -> task map of pipe_kernel.
# ---------------------------------------------------------------------------

def task_map(n, bx, by, plan):
    """pipe_kernel's task of each block id of its x_blocks + y_blocks
    grid: ("x", (b tile, n tile, channel)) for ids below x_blocks, else
    ("y", (Y tile, channel))."""
    xbt, ytiles = -(-bx // TILE), -(-by // plan.tb)
    tasks = []
    for i in range(plan.x_blocks + plan.y_blocks):
        if i < plan.x_blocks:
            tasks.append(("x", (i % xbt, (i // xbt) % (n // TILE),
                                i // (xbt * (n // TILE)))))
        else:
            t = i - plan.x_blocks
            tasks.append(("y", (t % ytiles, t // ytiles)))
    return tasks


@pytest.mark.parametrize("n", [1024, 128])
@pytest.mark.parametrize("bx,by", HALVES)
def test_task_map_covers_every_tile_once(bx, by, n):
    """Every X tile (b tile, n tile, channel) and every (Y tile, channel)
    is the task of exactly one block."""
    plan = cuda_pipe.pipe_plan(n, bx, by)
    tasks = task_map(n, bx, by, plan)
    xs = [t for kind, t in tasks if kind == "x"]
    ys = [t for kind, t in tasks if kind == "y"]
    assert sorted(xs) == sorted(itertools.product(
        range(-(-bx // TILE)), range(n // TILE), range(2)))
    assert sorted(ys) == sorted(itertools.product(range(-(-by // plan.tb)),
                                                  range(2)))


@pytest.mark.parametrize("n,bx,by,y_ids", [
    (1024, 2048, 2048, range(1024, 1280)),
    (1024, 2047, 2048, range(1024, 1280)),
    (128, 17, 33, range(4, 10))])
def test_block_order_places_the_y_blocks(n, bx, by, y_ids):
    """Halves of 2048 (or 2047) at N 1024, 256 Y blocks and 1024 X tiles:
    the Y blocks are ids 1024-1279, after every X tile; at N 128, halves
    of 17 and 33, ids 4-9 after the 4 X tiles."""
    plan = cuda_pipe.pipe_plan(n, bx, by)
    tasks = task_map(n, bx, by, plan)
    assert [i for i, (kind, _) in enumerate(tasks)
            if kind == "y"] == list(y_ids)


# ---------------------------------------------------------------------------
# A Y block: rotdec_col.cuh rotdec_tile at 128 threads, k 1, nd 1.
# ---------------------------------------------------------------------------

def _bank_degree(addrs):
    addrs = np.unique(addrs)
    return int(np.bincount(addrs % 32).max()) if len(addrs) else 0


def y_blocks_model(p, acc, amounts, tb, degrees):
    """Every Y block of one launch (tile of ``tb`` ciphertexts, channel):
    the staged column, each thread's rows (tid / P, + 128 / P, ...), its
    4 ciphertexts from w0 = 4 (tid % P) read in the order (t + g) & 3, g =
    (tid / P / R) & 3.  Returns (digits (2L*N, B) int64, times each digit
    was written); appends each warp's gather bank-conflict degree to
    ``degrees``."""
    n, l, bg = p.n, p.l, p.bgbit
    b = acc.shape[2]
    per_row, cycle = tb // 4, 32 // tb
    out = np.zeros((2 * l * n, b), np.int64)
    hits = np.zeros((2 * l * n, b), np.int64)
    tid = np.arange(THREADS)
    w0, g = 4 * (tid % per_row), (tid // per_row // cycle) & 3
    for tile, c in itertools.product(range(-(-b // tb)), range(2)):
        b0 = tile * tb
        live_tb = min(tb, b - b0)
        col = np.zeros((n, tb), np.uint32)
        col[:, :live_tb] = acc[c, :, b0:b0 + live_tb]
        am = np.zeros(tb, np.int64)
        am[:live_tb] = amounts[b0:b0 + live_tb] % (2 * n)
        rr, flip = am % n, am >= n
        for ni0 in range(0, n, THREADS // per_row):
            ni = ni0 + tid // per_row
            assert (g == (ni // cycle) & 3).all()      # one order a thread
            for t in range(4):
                w = w0 + ((t + g) & 3)
                live = (w < live_tb) & (ni < n)
                s = ni - rr[w]
                wrapped = s < 0
                s = np.where(wrapped, s + n, s)
                xr = col[s % n, w]
                xr = np.where(wrapped != flip[w], ~xr, xr)
                tmp = (xr - col[ni % n, w] + np.uint32(p.decomposition_offset)
                       ).astype(np.int64)
                for warp in range(0, THREADS, 32):
                    lanes = slice(warp, warp + 32)
                    degrees.append(_bank_degree(
                        (s * tb + w)[lanes][live[lanes]]))
                for lv in range(l):
                    d = ((tmp >> (32 - (lv + 1) * bg)) & ((1 << bg) - 1)
                         ) - (1 << (bg - 1))
                    rows = (c * l + lv) * n + ni
                    out[rows[live], b0 + w[live]] = d[live]
                    hits[rows[live], b0 + w[live]] += 1
    return out, hits


@pytest.mark.parametrize("name,b", [("128bit_fast", 16), ("128bit_fast", 37),
                                    ("128bit", 17), ("128bit", 8),
                                    ("110bit_fast", 33), ("80bit", 5),
                                    ("test_fast", 3), ("test_pbs", 19)])
def test_y_block_model_matches_plain(name, b):
    """128bit_fast (bgbit 8, l 2), 128bit (bgbit 6, l 3), other route-(c)
    profiles and test_fast (N 128); ragged last tiles, a half narrower
    than a tile; amounts 0, N, 2N - 1, 2N among them: each digit written
    once, equal to plain K1, every gather conflict free."""
    p = params.get_params(name)
    tb = cuda_pipe.Y_TILE
    rng = np.random.default_rng(b + tb)
    acc = rng.integers(0, 2 ** 32, (2, p.n, b), dtype=np.uint64
                       ).astype(np.uint32)
    amounts = rng.integers(0, 2 * p.n + 1, b).astype(np.int32)
    amounts[:4] = [0, p.n, 2 * p.n - 1, 2 * p.n][:b]
    degrees = []
    got, hits = y_blocks_model(p, acc, amounts, tb, degrees)
    want = cuda_t.rotate_decompose_t_ref(p, from_numpy_u32(acc, "cpu"),
                                         torch.from_numpy(amounts))
    assert (hits == 1).all()
    np.testing.assert_array_equal(got, want.numpy())
    assert max(degrees) == 1
