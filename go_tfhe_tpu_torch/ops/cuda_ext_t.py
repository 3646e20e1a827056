"""The extended-LUT blind-rotation step's two kernels, transposed layout
(port of ``go_tfhe_tpu/ops/pallas_t.py:272-489``).

An extended look-up table (poly_extend_factor k > 1) has size k*N; the
accumulator is the big polynomial interleaved into k blocks
(ops/rotate.monomial_mul_blocks).  Layouts (the JAX package's, words as
int32):
  acc     (2, k*N, B)           — channel-major; block r in rows [rN, (r+1)N)
  digits  (k*ND*2L*N, B) int8   — block-major row groups, each in K1's
                                  limb-major layout: ((r*ND + i)*2L + c*L +
                                  lv)*N + n
  band    (2, 2L, 2N) int32     — K2's band (cuda_t.pack_bsk_band_t); every
                                  block contracts against the same band

Each kernel has a wrapper and a plain PyTorch version beside it:

* K4 :func:`rotate_decompose_ext_t` / :func:`rotate_decompose_ext_t_ref` —
  ``csrc/rotdec_ext_t.cu``;
* K5 :func:`extprod_ext_t` / :func:`extprod_ext_t_ref` —
  ``csrc/extprod_ext_t.cu``.

:func:`extprod_ext_t_mm` computes K5's function through ``torch._int_mm``
(the library form, a yardstick of speed); no path of the port calls it.

As for K1/K2 (ops/cuda_t.py), a wrapper runs the plain version for CPU
tensors and launches the CUDA kernel for CUDA tensors, and each launch adds
one to ``cuda_t.launch_counts[<wrapper name>]``.
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS
from .cuda_t import (_TILE_WIDTHS, SMEM_LIMIT, RotdecPlan, _check,
                     check_tile, column_plan, extprod_t_mm, extprod_t_ref,
                     launch)
from .decompose import gadget_decompose
from .polymul import split_signed_limbs_i8
from .rotate import monomial_mul_blocks


def ext_t_fits(p: TFHEParams) -> bool:
    """The JAX dispatch's predicate (pallas_t.ext_t_fits: the TPU kernel's
    VMEM footprint, ~4 live copies of the (2, kN) working set plus the
    digits, for 128 ciphertexts within 80 MB) for the transposed extended
    kernels: true for uint6 and uint7 (and their centered variants), false
    for uint8's k = 9, which the JAX package sends to the row-major kernels
    (ROADMAP Queue 2 K6/K8).  The port routes by the same predicate, so
    each profile reaches the counterpart of its TPU kernel."""
    k, n = p.poly_extend_factor, p.n
    bytes_per_row = 4 * (2 * k * n * 4) + k * p.digit_limbs * 2 * p.l * n
    return 128 * bytes_per_row <= 80 << 20


# ---------------------------------------------------------------------------
# K4: rotate + decompose of the interleaved big accumulator.
# ---------------------------------------------------------------------------

def rotate_decompose_ext_t_ref(p: TFHEParams, acc: torch.Tensor,
                               amounts: torch.Tensor) -> torch.Tensor:
    """Plain K4: monomial_mul_blocks, gadget_decompose, signed limb split,
    block-major relayout.

    acc (2, k*N, B) int32 words; amounts (B,) int32 in [0, 2kN] (taken mod
    2kN, so 2kN is the identity).  Returns (k*ND*2L*N, B) int8 digit limbs
    of X^amount . acc - acc."""
    k, n, nd = p.poly_extend_factor, p.n, p.digit_limbs
    b = acc.shape[2]
    x = acc.reshape(2, k, n, b).permute(3, 1, 0, 2)             # (B, k, 2, N)
    rot = monomial_mul_blocks(x, amounts, k)
    digits = gadget_decompose(rot - x, p)                       # (B, k, 2L, N)
    if nd == 1:
        limbs = digits[None].to(torch.int8)
    else:
        limbs = split_signed_limbs_i8(digits, nd)               # (nd, B, k, 2L, N)
    return limbs.permute(2, 0, 3, 4, 1).reshape(
        k * nd * 2 * p.l * n, b).contiguous()


def rotdec_ext_t_plan(n: int, k: int, b: int) -> RotdecPlan:
    """K4's launch: a block stages one channel of a tile, the whole k*N-row
    column.  Where B % 4 == 0 (and N % 32 == 0): two passes, tiles of 4
    ciphertexts (64 KB at uint6, 128 KB at uint7 a block) whose digits go
    to a scratch buffer in 128-byte runs, then one more kernel writes the
    digit rows.  Else one pass with the widest tile that fits, writing tb
    bytes of each digit row a block."""
    name, rows = "rotate_decompose_ext_t", k * n
    if b % 4 == 0 and n % 32 == 0:
        return column_plan(name, rows, n, b, 4, True)
    tb = max([w for w in _TILE_WIDTHS if n % (32 // w) == 0
              and 4 * (rows + k) * w <= SMEM_LIMIT], default=4)
    return column_plan(name, rows, n, b, tb)


def rotate_decompose_ext_t(p: TFHEParams, acc: torch.Tensor,
                           amounts: torch.Tensor) -> torch.Tensor:
    """K4 (replaces pallas_t.rotate_decompose_ext_t): see the ref's
    contract."""
    if acc.device.type == "cpu":
        return rotate_decompose_ext_t_ref(p, acc, amounts)
    k, n, nd = p.poly_extend_factor, p.n, p.digit_limbs
    b = acc.shape[2]
    _check("acc", acc, TORUS, (2, k * n, b), acc.device)
    _check("amounts", amounts, torch.int32, (b,), acc.device)
    plan = rotdec_ext_t_plan(n, k, b)
    out = torch.empty((k * nd * 2 * p.l * n, b), dtype=torch.int8,
                      device=acc.device)
    scratch = torch.empty_like(out) if plan.two_pass else None
    launch("rotate_decompose_ext_t", "tfhe_rotdec_ext_t", acc.device,
           acc.data_ptr(), amounts.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), n, k, b, p.l,
           p.bgbit, p.decomposition_offset, nd, plan.tb)
    return out


# ---------------------------------------------------------------------------
# K5: block-wise external product.
# ---------------------------------------------------------------------------

def _blocks_in_batch(contract, digits, band, acc, k, nd, lo):
    """K2's contraction ``contract`` for each of the k blocks against the
    same band, with the blocks folded into the batch."""
    _, kn, b = acc.shape
    n = kn // k
    d = digits.reshape(k, -1, b).permute(1, 0, 2).reshape(-1, k * b)
    a = acc.reshape(2, k, n, b).permute(0, 2, 1, 3).reshape(2, n, k * b)
    out = contract(d, band, a, nd, lo)                          # (2, N, k*B)
    return out.reshape(2, n, k, b).permute(0, 2, 1, 3).reshape(2, kn, b)


def extprod_ext_t_ref(digits: torch.Tensor, band: torch.Tensor,
                      acc: torch.Tensor, k: int, nd: int = 1, lo: int = 0
                      ) -> torch.Tensor:
    """Plain K5: K2's contraction (cuda_t.extprod_t_ref) for each of the k
    blocks against the same band, with the blocks folded into the batch.

    digits (k*ND*2L*N, B) int8 block-major; band (2, 2L, 2N) int32;
    acc (2, k*N, B).  Returns acc + the block-wise external product.
    ``lo`` changes no value and is ignored, as in extprod_t_ref."""
    return _blocks_in_batch(extprod_t_ref, digits, band, acc, k, nd, lo)


def extprod_ext_t_mm(digits: torch.Tensor, band: torch.Tensor,
                     acc: torch.Tensor, k: int, nd: int = 1, lo: int = 0
                     ) -> torch.Tensor:
    """K5's function through ``torch._int_mm`` (cuda_t.extprod_t_mm with
    the blocks folded into the batch), on any device; the contract of
    :func:`extprod_ext_t_ref`.  Used only to time the kernel against the
    library."""
    return _blocks_in_batch(extprod_t_mm, digits, band, acc, k, nd, lo)


def extprod_ext_t(digits: torch.Tensor, band: torch.Tensor,
                  acc: torch.Tensor, k: int, nd: int = 1, lo: int = 0
                  ) -> torch.Tensor:
    """K5 (replaces pallas_t.extprod_ext_t): see the ref's contract;
    ``lo`` must be the band's (cuda_t.band_limb_drop).  Returns a new
    (2, k*N, B) tensor; ``acc`` is not modified."""
    if acc.device.type == "cpu":
        return extprod_ext_t_ref(digits, band, acc, k, nd, lo)
    _, kn, b = acc.shape
    n = kn // k
    l2 = band.shape[1]
    if kn % k:
        raise ValueError(f"extprod_ext_t: {kn} rows are not k={k} blocks")
    check_tile("extprod_ext_t", n, l2, lo)
    _check("acc", acc, TORUS, (2, kn, b), acc.device)
    _check("band", band, TORUS, (2, l2, 2 * n), acc.device)
    _check("digits", digits, torch.int8, (k * nd * l2 * n, b), acc.device)
    out = torch.empty_like(acc)
    launch("extprod_ext_t", "tfhe_extprod_ext_t", acc.device,
           digits.data_ptr(), band.data_ptr(), acc.data_ptr(),
           out.data_ptr(), n, k, b, l2, nd, lo)
    return out
