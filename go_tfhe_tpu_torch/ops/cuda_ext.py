"""K6: the row-major rotate + decompose of the interleaved big accumulator
(port of ``go_tfhe_tpu/ops/pallas_ext.py``), the first kernel of the
row-major extended-LUT step (ops/blindrotate.blind_rotate_extended_rm),
which serves the profiles that fail ``ext_t_fits``: uint8 and
uint8_centered (k = 9).

Layouts (the JAX package's, words as int32):
  acc      (2, B, k*N)          — channel-major; block r in columns
                                  [rN, (r+1)N) of each ciphertext's row
  amounts  (B,) int32           — in [0, 2kN], taken mod 2kN
  digits   (B, k*ND*2L*N) int8  — block-major, then limb, channel, level:
                                  column (r*ND*2L + i*2L + c*L + lv)*N + n

``digits.reshape(B*k, ND*2L*N)`` is K8's digit input (ops/cuda_extprod.py)
with the k blocks folded into the batch: every block contracts against the
same band.

:func:`rotate_decompose_ext` launches ``csrc/rotdec_ext.cu`` (the
staged-row kernel, ``csrc/rotdec_row.cuh``, one block per ciphertext and
output block; :func:`rotdec_ext_plan`) on CUDA tensors and runs
:func:`rotate_decompose_ext_ref` on CPU tensors; each launch adds one to
``cuda_t.launch_counts["rotate_decompose_ext"]``.
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS
from .cuda_ext_t import rotate_decompose_ext_t_ref
from .cuda_t import RowPlan, _check, launch, row_plan


def rotate_decompose_ext_ref(p: TFHEParams, acc: torch.Tensor,
                             amounts: torch.Tensor) -> torch.Tensor:
    """Plain K6: plain K4 (cuda_ext_t.rotate_decompose_ext_t_ref) in the
    row-major layout; K4's digit rows are K6's columns, in the same order.

    acc (2, B, k*N) int32 words; amounts (B,) int32 in [0, 2kN] (2kN is the
    identity).  Returns (B, k*ND*2L*N) int8 digit limbs of
    X^amount . acc - acc."""
    return rotate_decompose_ext_t_ref(p, acc.transpose(1, 2),
                                      amounts).t().contiguous()


def rotdec_ext_plan(n: int, k: int, b: int) -> RowPlan:
    """K6's launch: a block for each (ciphertext, output block) stages, for
    each channel in turn, its own block and its rotation source block, N
    words each, and the rotation."""
    return row_plan("rotate_decompose_ext", n, (b, k, 1), 2, 1, 4 * n + 1)


def rotate_decompose_ext(p: TFHEParams, acc: torch.Tensor,
                         amounts: torch.Tensor) -> torch.Tensor:
    """K6 (replaces pallas_ext.rotate_decompose_ext_pallas): see the ref's
    contract."""
    if acc.device.type == "cpu":
        return rotate_decompose_ext_ref(p, acc, amounts)
    k, n, nd = p.poly_extend_factor, p.n, p.digit_limbs
    b = acc.shape[1]
    _check("acc", acc, TORUS, (2, b, k * n), acc.device)
    _check("amounts", amounts, torch.int32, (b,), acc.device)
    plan = rotdec_ext_plan(n, k, b)
    out = torch.empty((b, k * nd * 2 * p.l * n), dtype=torch.int8,
                      device=acc.device)
    launch("rotate_decompose_ext", "tfhe_rotdec_ext", acc.device,
           acc.data_ptr(), amounts.data_ptr(), out.data_ptr(), n, k, b, p.l,
           p.bgbit, p.decomposition_offset, nd, plan.threads)
    return out
