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
* K2 :func:`extprod_t` / :func:`extprod_t_ref` — ``csrc/extprod_t.cu``.

:func:`extprod_t_mm` computes K2's function through ``torch._int_mm`` (the
library form, a yardstick of speed for the card); no path of the port calls
it.

A wrapper runs the plain version for CPU tensors and launches the CUDA
kernel for CUDA tensors; it never falls back from one to the other.  Each
launch adds one to ``launch_counts[<wrapper name>]``, which also counts the
extended-LUT kernels K4/K5 (ops/cuda_ext_t.py), the row-major kernels
K6 (ops/cuda_ext.py), K7 (ops/cuda_rotate.py) and K8 (ops/cuda_extprod.py),
the fused step K3 (ops/cuda_step.py) and the pipelined step K9
(ops/cuda_pipe.py).
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS
from . import _build
from .decompose import gadget_decompose
from .polymul import (ext_band_from_trgsw, matmul_mod32,
                      split_balanced_limbs_i8, split_signed_limbs_i8,
                      toeplitz_from_band)
from .rotate import monomial_mul

# extprod_tile.cuh's output tile: N must be a multiple of its TN.
_EXTPROD_TN = 64

launch_counts = {"rotate_decompose_t": 0, "extprod_t": 0,
                 "rotate_decompose_ext_t": 0, "extprod_ext_t": 0,
                 "rotate_decompose_ext": 0, "rotate_decompose": 0,
                 "extprod": 0, "fused_rotate_step": 0, "pipe_step": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def band_limb_drop(p: TFHEParams) -> int:
    """The key limbs that the bands of a profile's keys are packed without
    (:func:`pack_bsk_band_t`'s ``lo``) and that K2/K5/K9 skip: the TPU
    kernel's ``kernel_limb_drop`` for single-limb digits, else 0."""
    return p.kernel_limb_drop if p.digit_limbs == 1 else 0


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


def rotate_decompose_t(p: TFHEParams, acc: torch.Tensor,
                       amounts: torch.Tensor) -> torch.Tensor:
    """K1 (replaces pallas_t.rotate_decompose_t): see the ref's contract."""
    if acc.device.type == "cpu":
        return rotate_decompose_t_ref(p, acc, amounts)
    _, n, b = acc.shape
    _check("acc", acc, TORUS, (2, n, b), acc.device)
    _check("amounts", amounts, torch.int32, (b,), acc.device)
    nd = p.digit_limbs
    out = torch.empty((nd * 2 * p.l * n, b), dtype=torch.int8,
                      device=acc.device)
    lib = _build.load_library()
    with torch.cuda.device(acc.device):
        rc = lib.tfhe_rotdec_t(
            acc.data_ptr(), amounts.data_ptr(), out.data_ptr(), n, b, p.l,
            p.bgbit, p.decomposition_offset, nd,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rotdec_t kernel launch failed: CUDA error {rc}")
    launch_counts["rotate_decompose_t"] += 1
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
    tensor; ``acc`` is not modified."""
    if acc.device.type == "cpu":
        return extprod_t_ref(digits, band, acc, nd, lo)
    _, n, b = acc.shape
    l2 = band.shape[1]
    check_tile("extprod_t", n, l2, lo)
    _check("acc", acc, TORUS, (2, n, b), acc.device)
    _check("band", band, TORUS, (2, l2, 2 * n), acc.device)
    _check("digits", digits, torch.int8, (nd * l2 * n, b), acc.device)
    out = torch.empty_like(acc)
    lib = _build.load_library()
    with torch.cuda.device(acc.device):
        rc = lib.tfhe_extprod_t(
            digits.data_ptr(), band.data_ptr(), acc.data_ptr(),
            out.data_ptr(), n, b, l2, nd, lo,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"extprod_t kernel launch failed: CUDA error {rc}")
    launch_counts["extprod_t"] += 1
    return out


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

