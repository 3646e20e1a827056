"""K7: the row-major rotate + decompose with a block count (port of
``go_tfhe_tpu/ops/pallas_rotate.py``), the first kernel of the block blind
rotation's step (ops/blindrotate.blind_rotate_block).

Layouts (the JAX package's, words as int32):
  acc      (2, B, N)                — channel-major, coefficients contiguous
  amounts  (bs, B) or (B,) int32    — per block bit, in [0, 2N]
  digits   (B, ND*bs*2L*N) int8     — limb-major, then block bit, channel,
                                      level: column
                                      (i*bs*2L + (j*2 + c)*L + lv)*N + n

For each of the bs block bits the SAME accumulator rotates by that bit's
amount, so one external product (K8, ops/cuda_extprod.py) contracts all
bs*2L digit rows against the block's bands at once.  bs = 1 is the
per-bit step of the block rotation's ragged tail.

:func:`rotate_decompose` launches ``csrc/rotdec.cu`` (the staged-row
kernel, ``csrc/rotdec_row.cuh``, a block for a few accumulator rows;
:func:`rotdec_plan`) on CUDA tensors and runs :func:`rotate_decompose_ref`
on CPU tensors; each launch adds one to
``cuda_t.launch_counts["rotate_decompose"]``.
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS
from . import _build
from .cuda_t import RowPlan, _check, launch_counts, row_plan
from .decompose import gadget_decompose
from .polymul import split_signed_limbs_i8
from .rotate import monomial_mul


def _block_amounts(amounts: torch.Tensor) -> torch.Tensor:
    return amounts[None] if amounts.dim() == 1 else amounts


def rotate_decompose_ref(p: TFHEParams, acc: torch.Tensor,
                         amounts: torch.Tensor) -> torch.Tensor:
    """Plain K7: gather rotation per block bit, gadget_decompose, signed
    limb split, limb-major relayout.

    acc (2, B, N) int32 words; amounts (bs, B) or (B,) int32 in [0, 2N]
    (2N is the identity).  Returns (B, ND*bs*2L*N) int8 digit limbs of
    X^amount . acc - acc."""
    amounts = _block_amounts(amounts)
    bs, b = amounts.shape
    nd, n = p.digit_limbs, acc.shape[-1]
    x = acc.transpose(0, 1)                                     # (B, 2, N)
    rot = monomial_mul(x[:, None], amounts.t()[:, :, None])     # (B, bs, 2, N)
    digits = gadget_decompose(rot - x[:, None], p)              # (B, bs, 2L, N)
    if nd == 1:
        limbs = digits[None].to(torch.int8)
    else:
        limbs = split_signed_limbs_i8(digits, nd)            # (nd, B, bs, 2L, N)
    return limbs.transpose(0, 1).reshape(b, nd * bs * 2 * p.l * n
                                         ).contiguous()


def rotdec_plan(n: int, b: int, bs: int) -> RowPlan:
    """K7's launch: a block stages 16 KB of consecutive accumulator rows
    (channel-major rows c*B + b; 4 at N 1024) and their bs rotations, in two
    halves, and works on a half's rows at once where N/4 < 256."""
    rows = max(1, 4096 // n)
    return row_plan("rotate_decompose", n, (-(-2 * b // rows), 1, 1), rows,
                    -(-rows // 2), rows * (n + bs))


def rotate_decompose(p: TFHEParams, acc: torch.Tensor,
                     amounts: torch.Tensor) -> torch.Tensor:
    """K7 (replaces pallas_rotate.rotate_decompose_pallas): see the ref's
    contract."""
    if acc.device.type == "cpu":
        return rotate_decompose_ref(p, acc, amounts)
    amounts = _block_amounts(amounts)
    bs, b = amounts.shape
    nd, n = p.digit_limbs, acc.shape[-1]
    _check("acc", acc, TORUS, (2, b, n), acc.device)
    _check("amounts", amounts, torch.int32, (bs, b), acc.device)
    plan = rotdec_plan(n, b, bs)
    out = torch.empty((b, nd * bs * 2 * p.l * n), dtype=torch.int8,
                      device=acc.device)
    lib = _build.load_library()
    with torch.cuda.device(acc.device):
        rc = lib.tfhe_rotdec(
            acc.data_ptr(), amounts.data_ptr(), out.data_ptr(), n, b, bs,
            p.l, p.bgbit, p.decomposition_offset, nd, plan.rows,
            plan.threads,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rotdec kernel launch failed: CUDA error {rc}")
    launch_counts["rotate_decompose"] += 1
    return out
