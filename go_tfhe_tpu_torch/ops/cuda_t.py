"""The blind-rotation step's two kernels, transposed layout: polynomial
coefficients major, ciphertext batch fastest (port of
``go_tfhe_tpu/ops/pallas_t.py:59-265``).

Layouts (the JAX package's, words as int32):
  acc     (2, N, B)         — channel-major accumulators
  digits  (ND*2L*N, B) int8 — limb-major rows [(i, c, lv)] * N + n
  band    (2, 2L, 2N) int32 — this port's own band (:func:`pack_bsk_band_t`)

Each kernel has a wrapper and a plain PyTorch version beside it:

* K1 :func:`rotate_decompose_t` / :func:`rotate_decompose_t_ref` —
  ``csrc/rotdec_t.cu``;
* K2 :func:`extprod_t` / :func:`extprod_t_ref` — ``csrc/extprod_t.cu``,
  and at small batches ``csrc/extprod_t_small.cu``
  (:func:`takes_small_form`);
* K1 + K2's small form in one launch, :func:`step_t_small` /
  :func:`step_t_small_ref` — ``csrc/step_t_small.cu``, the blind
  rotation's step at small batches (:func:`takes_fused_step`).

:func:`extprod_t_mm` computes K2's function through ``torch._int_mm`` (the
library form, a yardstick of speed for the card); no path of the port calls
it.

A wrapper runs the plain version for CPU tensors and launches the CUDA
kernel for CUDA tensors, on their card (:func:`launch`); it never falls
back from one to the other.  Each launch adds one to
``launch_counts[<wrapper name>]``, which also counts the
extended-LUT kernels K4/K5 (ops/cuda_ext_t.py), the row-major kernels
K6 (ops/cuda_ext.py), K7 (ops/cuda_rotate.py) and K8 (ops/cuda_extprod.py),
the fused step K3 (ops/cuda_step.py) and the pipelined step K9
(ops/cuda_pipe.py).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

# band_limb_drop is the profile's rule; the wrappers' callers take it here.
from ..params import TFHEParams, band_limb_drop  # noqa: F401
from ..utils import tracing
from ..utils.torus import TORUS
from . import _build
from .decompose import gadget_decompose
from .polymul import (ext_band_from_trgsw, matmul_mod32,
                      split_balanced_limbs_i8, split_signed_limbs_i8,
                      toeplitz_from_band)
from .rotate import monomial_mul

# extprod_tile.cuh's output tile: N must be a multiple of its TN.
_EXTPROD_TN = 64
# The largest batch that K2 runs in its small form (:func:`takes_small_form`):
# on an H100 (PERF.md, K2's crossover) the small form is the faster up to
# B 32 and the tile from B 64, at the 128-bit shapes (N 1024, 2L 6, ND 1;
# 89 against 138 µs a step at B 32) and at uint5's (N 2048, 2L 2, ND 3; 158
# against 172 µs).
SMALL_BATCH_MAX = 32
# The largest batch whose blind-rotation steps run the fused step
# (:func:`takes_fused_step`).  On an H100, a step in a CUDA graph of 100
# (PERF.md §6), fused / K1 + K2's small form, µs: at the 128-bit shapes B 1
# 7.67 / 24.43, B 2 10.26 / 26.60, B 4 17.48 / 24.21, B 8 30.17 / 32.14,
# B 16 63.54 / 53.48, B 32 138.24 / 104.26; at uint5's 9.47 / 41.34, 14.38
# / 41.84, 26.63 / 35.35, 52.49 / 52.07, 108.02 / 85.80, 273.75 / 178.50.
# Every block of the fused step makes its ciphertexts' digits, 2N/16 times
# over, so its cost grows with B faster than K1's one pass: the two tie at
# B 8 (uint5) and the pair is the faster from B 16.
FUSED_BATCH_MAX = 4
# The H100's dynamic shared memory per block (opt-in limit), and the widths
# of a rotate + decompose tile (csrc/rotdec_col.cuh).
SMEM_LIMIT = 232448
_TILE_WIDTHS = (4, 8, 16, 32)
# The staged-row kernel (csrc/rotdec_row.cuh): the shared memory a block
# gets without opting in, and at most this many threads a block.
ROW_SMEM_LIMIT = 49152
_ROW_THREADS = 256

# Launches by wrapper name: utils/tracing.py's always-kept count (its
# "extprod_t_small" key is a sub-count of "extprod_t", and "step_t_small"
# one of "extprod_t_small").
launch_counts = tracing.launch_counts


def reset_launch_counts() -> None:
    """Zero the launch counts, and the key switches
    (``tracing.key_switch_counts``) whose share ``launch_counts
    ["key_switch"]`` is."""
    for name in launch_counts:
        launch_counts[name] = 0
    tracing.key_switch_counts.update(dict.fromkeys(
        tracing.key_switch_counts, 0))


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Launch the library's entry point ``entry`` with ``args`` and the
    stream on the card of the inputs, ``device``, and count it under
    ``launch_counts[name]``; raises on a launch error.

    Every wrapper launches through here.  The CUDA runtime launches on its
    current device, and so do the entry points' cudaFuncSetAttribute
    calls, so ``device`` is made current for the call and its own current
    stream is passed: a tensor on ``cuda:1`` launches on card 1 whichever
    card the caller has current.

    The launch's first on each card records its host seconds, and while
    the recorder is on the counter ``launch.host_ns`` adds the launch's
    (utils/tracing.py)."""
    t0 = time.perf_counter_ns() if tracing.active else 0
    lib = _build.load_library()
    key = (entry, device.index)
    first = key not in tracing.first_launches
    if first:
        t_first = time.perf_counter()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launch_counts[name] += 1
    if first:
        tracing.first_launches[key] = time.perf_counter() - t_first
    if t0:
        tracing.count("launch.host_ns", time.perf_counter_ns() - t0)


def pack_bsk_band_t(bsk: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Raw BSK (n0, 2L, 2, N) int32 words -> K2's bands (n0, 2, 2L, 2N).

    band[i, c, r, x] = D'[x] for BSK row r, channel c, where
    D = concat(-K, K) (so the negacyclic product reads D[N + n - j]) and
    D' = D - sum_{l < lo} limb_l(D) * 2^(8l) removes the ``lo`` lowest
    balanced base-256 limbs that the TPU kernel drops
    (``kernel_limb_drop``).  For on-grid keys (key_grid_bits >= 8*lo)
    those limbs are zero and D' == D."""
    d = ext_band_from_trgsw(bsk)                  # (n0, 2L, 2, 2N)
    if lo:
        limbs = split_balanced_limbs_i8(d, lo).to(TORUS)
        for l in range(lo):
            d = d - (limbs[l] << (8 * l))
    return d.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# K1: rotate + decompose.
# ---------------------------------------------------------------------------

def rotate_decompose_t_ref(p: TFHEParams, acc: torch.Tensor,
                           amounts: torch.Tensor) -> torch.Tensor:
    """Plain K1: gather rotation, gadget_decompose, signed limb split.

    acc (2, N, B) int32 words; amounts (B,) int32 in [0, 2N].  Returns
    (ND*2L*N, B) int8 digit limbs of X^amount . acc - acc."""
    _, n, b = acc.shape
    nd = p.digit_limbs
    x = acc.permute(2, 0, 1)                                   # (B, 2, N)
    rot = monomial_mul(x, amounts[:, None])
    digits = gadget_decompose(rot - x, p)                      # (B, 2L, N)
    if nd == 1:
        limbs = digits[None].to(torch.int8)
    else:
        limbs = split_signed_limbs_i8(digits, nd)              # (nd, B, 2L, N)
    return limbs.permute(0, 2, 3, 1).reshape(nd * 2 * p.l * n, b).contiguous()


class RotdecPlan(NamedTuple):
    """The launch of a staged-column rotate + decompose kernel (K1, K4;
    csrc/rotdec_col.cuh): ``tb`` ciphertexts a tile (a block stages the
    tile's whole column), ``two_pass`` (K4: the digits go in 128-byte runs
    to a scratch buffer, then one more kernel writes the digit rows),
    ``smem`` dynamic shared-memory bytes a block."""
    tb: int
    two_pass: bool
    smem: int


def column_plan(name: str, rows: int, n: int, b: int, tb: int,
                two_pass: bool = False) -> RotdecPlan:
    """A block staging ``rows`` rows of ``tb`` words and a rotation word a
    ciphertext for each N of them; raises ValueError where the kernel does
    not take it (csrc/rotdec_col.cuh plan_ok, the shared-memory limit)."""
    if b < 1:
        raise ValueError(f"{name}: empty batch")
    if tb not in _TILE_WIDTHS or n % (32 // tb):
        raise ValueError(f"{name}: tile width {tb} at N={n}; the kernel "
                         f"takes {_TILE_WIDTHS} with N a multiple of 32/tb")
    smem = 4 * (rows + rows // n) * tb
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory a block "
                         f"(tb={tb}); the card allows {SMEM_LIMIT}")
    return RotdecPlan(tb, two_pass, smem)


class RowPlan(NamedTuple):
    """The launch of the staged-row rotate + decompose kernel (K7, K6;
    csrc/rotdec_row.cuh): ``grid`` (x, y, z) blocks of ``threads`` threads,
    each staging ``rows`` source rows of N words (and their rotations) in
    ``smem`` bytes of shared memory."""
    grid: tuple
    threads: int
    rows: int
    smem: int


def row_plan(name: str, n: int, grid: tuple, rows: int, at_once: int,
             words: int) -> RowPlan:
    """Blocks that stage ``rows`` rows of N (``words`` words with the
    rotations) and work on ``at_once`` rows at a time, 4 coefficients a
    thread: N/4 threads a row, up to 256 a block; raises ValueError where
    the kernel does not take it (csrc/rotdec_row.cuh plan_ok)."""
    if grid[0] < 1:
        raise ValueError(f"{name}: empty batch")
    if n < 128 or n % 128:
        raise ValueError(f"{name}: N={n}; the kernel takes N a multiple of "
                         "128")
    smem = 4 * words
    if smem > ROW_SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory a block; "
                         f"the kernel takes {ROW_SMEM_LIMIT}")
    per_row = n // 4
    threads = min(_ROW_THREADS,
                  per_row * min(at_once, max(1, _ROW_THREADS // per_row)))
    return RowPlan(grid, threads, rows, smem)


def rotdec_t_plan(n: int, b: int) -> RotdecPlan:
    """K1's launch: a block stages one channel of a tile of 16, N rows of
    16 words (64 KB at N 1024, three blocks an SM; 128 KB at 2048)."""
    return column_plan("rotate_decompose_t", n, n, b, 16)


def rotate_decompose_t(p: TFHEParams, acc: torch.Tensor,
                       amounts: torch.Tensor) -> torch.Tensor:
    """K1 (replaces pallas_t.rotate_decompose_t): see the ref's contract."""
    if acc.device.type == "cpu":
        return rotate_decompose_t_ref(p, acc, amounts)
    _, n, b = acc.shape
    _check("acc", acc, TORUS, (2, n, b), acc.device)
    _check("amounts", amounts, torch.int32, (b,), acc.device)
    plan = rotdec_t_plan(n, b)
    nd = p.digit_limbs
    out = torch.empty((nd * 2 * p.l * n, b), dtype=torch.int8,
                      device=acc.device)
    launch("rotate_decompose_t", "tfhe_rotdec_t", acc.device,
           acc.data_ptr(), amounts.data_ptr(), out.data_ptr(), n, b, p.l,
           p.bgbit, p.decomposition_offset, nd, plan.tb)
    return out


# ---------------------------------------------------------------------------
# K2: external product.
# ---------------------------------------------------------------------------

def extprod_t_ref(digits: torch.Tensor, band: torch.Tensor,
                  acc: torch.Tensor, nd: int = 1, lo: int = 0
                  ) -> torch.Tensor:
    """Plain K2: exact Toeplitz contraction.

    digits (ND*2L*N, B) int8 limb-major; band (2, 2L, 2N) int32 from
    :func:`pack_bsk_band_t` (its ``lo`` drop folded in); acc (2, N, B).
    Returns acc + sum_{r,j} d[r,j] * band[c, r, N+n-j] mod 2^32, with
    d = sum_i limb_i * 256^i.  The same value as the TPU kernel's limb-pair
    dots: pairs of weight >= 2^32 vanish mod 2^32.  ``lo`` (the key limbs
    the band was packed without, which the kernel skips) changes no value
    and is ignored.  Runs on any device (polymul.matmul_mod32: float64
    products of 16-bit halves)."""
    _, l2, n2 = band.shape
    n = n2 // 2
    b = digits.shape[1]
    limbs = digits.reshape(nd, l2 * n, b).to(TORUS)
    d = limbs[0]
    for i in range(1, nd):
        d = d + limbs[i] * (1 << (8 * i))
    t = toeplitz_from_band(band)                    # (2, 2L, N, N) [c,r,j,n]
    t = t.permute(0, 3, 1, 2).reshape(2, n, l2 * n)
    return acc + matmul_mod32(t, d)


def extprod_t(digits: torch.Tensor, band: torch.Tensor, acc: torch.Tensor,
              nd: int = 1, lo: int = 0) -> torch.Tensor:
    """K2 (replaces pallas_t.extprod_t): see the ref's contract; ``lo``
    must be the band's (:func:`band_limb_drop`).  Returns a new (2, N, B)
    tensor; ``acc`` is not modified.  Launches the small-batch form where
    :func:`takes_small_form` says so for the batch and the form's block
    fits the shapes (:func:`small_form_fits`), else the tensor-core tile;
    both give the same words."""
    if acc.device.type == "cpu":
        return extprod_t_ref(digits, band, acc, nd, lo)
    return _extprod_t_launch(digits, band, acc, nd, lo)


def _extprod_t_launch(digits: torch.Tensor, band: torch.Tensor,
                      acc: torch.Tensor, nd: int, lo: int,
                      small: bool | None = None) -> torch.Tensor:
    """One K2 launch on CUDA tensors: of the form the shapes choose, or of
    the one ``small`` names (timing both forms at one batch, to place the
    crossover, names them)."""
    _, n, b = acc.shape
    l2 = band.shape[1]
    check_tile("extprod_t", n, l2, lo)
    _check("acc", acc, TORUS, (2, n, b), acc.device)
    _check("band", band, TORUS, (2, l2, 2 * n), acc.device)
    _check("digits", digits, torch.int8, (nd * l2 * n, b), acc.device)
    if small is None:
        small = takes_small_form(b) and small_form_fits(acc.device, n, b,
                                                        l2, nd)
    out = torch.empty_like(acc)
    entry = "tfhe_extprod_t_small" if small else "tfhe_extprod_t"
    launch("extprod_t", entry, acc.device, digits.data_ptr(),
           band.data_ptr(), acc.data_ptr(), out.data_ptr(), n, b, l2, nd, lo)
    if small:
        launch_counts["extprod_t_small"] += 1
    return out


def takes_small_form(b: int) -> bool:
    """Whether a K2 call of batch ``b`` takes the small form: at most
    :data:`SMALL_BATCH_MAX` ciphertexts.  N, 2L and ND do not enter: the
    crossover measured the same at the 128-bit and uint5 shapes."""
    return b <= SMALL_BATCH_MAX


# (card index, N, B, 2L, ND) -> whether the small form's block fits.
_small_fits: dict = {}


def small_form_fits(device: torch.device, n: int, b: int, l2: int,
                    nd: int) -> bool:
    """Whether K2's small form takes these shapes on ``device``'s card:
    the kernel's own rule (``tfhe_extprod_t_small_fits``: its block's
    shared memory within the card's), asked once for each shape."""
    key = (device.index, n, b, l2, nd)
    if key not in _small_fits:
        with torch.cuda.device(device):
            _small_fits[key] = bool(
                _build.load_library().tfhe_extprod_t_small_fits(n, b, l2, nd))
    return _small_fits[key]


def check_tile(name: str, n: int, rows: int, lo: int) -> None:
    """What extprod_tile.cuh takes: N a multiple of its TN, ``lo`` 0 or 1,
    and rows*N < 2^15 for the band rows it contracts (2L, or bs*2L in a
    block step), so that no s32 sum of a limb-pair weight (at most 4 pairs
    x rows*N products of magnitude <= 2^14) can overflow."""
    if n % _EXTPROD_TN:
        raise ValueError(f"{name}: N={n} is not a multiple of {_EXTPROD_TN}")
    if lo not in (0, 1):
        raise ValueError(f"{name}: lo={lo}; the kernel skips 0 or 1 key limbs")
    if 4 * rows * n * (1 << 14) >= 1 << 31:
        raise ValueError(f"{name}: R*N = {rows * n} terms could overflow the "
                         "kernel's s32 limb-pair sums (needs < 2^15)")


# ---------------------------------------------------------------------------
# K1 + K2's small form in one launch: the blind rotation's step at small
# batches.
# ---------------------------------------------------------------------------

def step_t_small_ref(p: TFHEParams, acc: torch.Tensor, amounts: torch.Tensor,
                     band: torch.Tensor) -> torch.Tensor:
    """Plain fused step: K1's plain version, then K2's.

    acc (2, N, B) int32 words; amounts (B,) int32 in [0, 2N]; band
    (2, 2L, 2N) from :func:`pack_bsk_band_t`.  Returns the new (2, N, B)
    accumulator acc + sum_{r,j} d[r,j] * band[c, r, N+n-j] mod 2^32, d the
    digits of X^amount . acc - acc."""
    digits = rotate_decompose_t_ref(p, acc, amounts)
    return extprod_t_ref(digits, band, acc, p.digit_limbs)


def step_t_small(p: TFHEParams, acc: torch.Tensor, amounts: torch.Tensor,
                 band: torch.Tensor) -> torch.Tensor:
    """K1 followed by K2's small form, in one launch
    (``csrc/step_t_small.cu``): see the ref's contract; the same words as
    :func:`rotate_decompose_t` then :func:`extprod_t`.  Returns a new
    tensor; ``acc`` is not modified.  The shapes must be ones that
    :func:`fused_fits` accepts.

    A launch counts under ``step_t_small``, and as the K2 launch of the
    small form that it also is, under ``extprod_t`` and
    ``extprod_t_small``; not under ``rotate_decompose_t``."""
    if acc.device.type == "cpu":
        return step_t_small_ref(p, acc, amounts, band)
    _, n, b = acc.shape
    l2 = 2 * p.l
    _check("acc", acc, TORUS, (2, n, b), acc.device)
    _check("amounts", amounts, torch.int32, (b,), acc.device)
    _check("band", band, TORUS, (2, l2, 2 * n), acc.device)
    out = torch.empty_like(acc)
    launch("step_t_small", "tfhe_step_t_small", acc.device, acc.data_ptr(),
           amounts.data_ptr(), band.data_ptr(), out.data_ptr(), n, b, p.l,
           p.bgbit, p.decomposition_offset)
    launch_counts["extprod_t"] += 1
    launch_counts["extprod_t_small"] += 1
    return out


def takes_fused_step(device: torch.device, p: TFHEParams, b: int) -> bool:
    """Whether a blind rotation's steps at batch ``b`` run
    :func:`step_t_small`: on a card, at most :data:`FUSED_BATCH_MAX`
    ciphertexts (where it is the faster; N, 2L and ND do not enter), where
    the kernel takes the shapes (:func:`fused_fits`); else K1 and K2
    apart."""
    return device.type == "cuda" and b <= FUSED_BATCH_MAX and fused_fits(
        device, p, b)


# (card index, N, B, L, bgbit) -> whether the fused step's block fits.
_fused_fits: dict = {}


def fused_fits(device: torch.device, p: TFHEParams, b: int) -> bool:
    """Whether :func:`step_t_small` takes profile ``p``'s shapes at batch
    ``b`` on ``device``'s card: the kernel's own rule
    (``tfhe_step_t_small_fits``: K2's small-form block within the card's
    shared memory, a gadget of at most 32 bits), asked once for each
    shape."""
    key = (device.index, p.n, b, p.l, p.bgbit)
    if key not in _fused_fits:
        with torch.cuda.device(device):
            _fused_fits[key] = bool(_build.load_library(
            ).tfhe_step_t_small_fits(p.n, b, p.l, p.bgbit))
    return _fused_fits[key]


# ---------------------------------------------------------------------------
# K2's function in library calls: the yardstick of its speed.
# ---------------------------------------------------------------------------

def toeplitz_limbs_i8(band: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """K2's band (2, 2L, 2N) -> (4-lo, 2*N, 2L*N) int8: for each balanced key
    limb l >= lo (polymul.split_balanced_limbs_i8), the Toeplitz matrices of
    both channels, row (c, n), column (r, j): limb_l(band[c, r, N+n-j])."""
    _, l2, n2 = band.shape
    n = n2 // 2
    limbs = split_balanced_limbs_i8(band, 4)[lo:]           # (4-lo, 2, 2L, 2N)
    t = toeplitz_from_band(limbs)                 # (4-lo, 2, 2L, N, N) [j, n]
    return t.permute(0, 1, 4, 2, 3).reshape(4 - lo, 2 * n, l2 * n
                                            ).contiguous()


def extprod_t_mm(digits: torch.Tensor, band: torch.Tensor,
                 acc: torch.Tensor, nd: int = 1, lo: int = 0,
                 key: torch.Tensor | None = None) -> torch.Tensor:
    """K2's function through ``torch._int_mm`` (s8 x s8 -> s32), on any
    device; the contract of :func:`extprod_t_ref`, ``lo`` the band's.

    For digit limb i, one product of the stacked key limbs lo <= l < 4 - i
    (:func:`toeplitz_limbs_i8`, or ``key`` if already built) and the limb's
    (2L*N, B) digit plane, the batch padded to a multiple of 8 (the card's
    int8 GEMM needs it); product l, of weight 2^(8(i+l)), is shifted and
    added mod 2^32.  Exact: an s32 sum has 2L*N terms of magnitude <= 2^14.
    Used only to time the kernel against the library."""
    _, n, b = acc.shape
    l2 = band.shape[1]
    if key is None:
        key = toeplitz_limbs_i8(band, lo)
    d = digits.reshape(nd, l2 * n, b)
    pad = -b % 8
    if pad:
        d = torch.nn.functional.pad(d, (0, pad))
    out = acc.reshape(2 * n, b).clone()
    for i in range(nd):
        nl = 4 - lo - i                    # key limbs l with i + l < 4
        if nl <= 0:
            break
        prod = torch._int_mm(key[:nl].reshape(nl * 2 * n, l2 * n),
                             d[i].contiguous())
        prod = prod.view(nl, 2 * n, b + pad)[..., :b]
        for t in range(nl):
            out += prod[t] << (8 * (i + lo + t))
    return out.view(2, n, b)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")

