"""Signed gadget decomposition (port of ``go_tfhe_tpu/ops/decompose.py``).

    tmp      = x + offset                        (wraps mod 2^32)
    digit_i  = ((tmp >> (32-(i+1)*BGBIT)) & (Bg-1)) - Bg/2

Row order matches the external product: [A digits level 0..L-1, then B
digits level 0..L-1] (evaluator/evaluator.go:59-61).
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import i32


def gadget_decompose(x: torch.Tensor, p: TFHEParams) -> torch.Tensor:
    """x: (..., C, N) int32 words -> (..., C*L, N) int32 digits in
    [-Bg/2, Bg/2).  (The mask keeps only bits below 32 - shift, so the
    arithmetic shift acts as a logical one.)"""
    tmp = x + i32(p.decomposition_offset)
    digits = [((tmp >> (32 - (i + 1) * p.bgbit)) & (p.bg - 1)) - p.half_bg
              for i in range(p.l)]
    d = torch.stack(digits, dim=-2)                # (..., C, L, N)
    lead = x.shape[:-2]
    c, n = x.shape[-2], x.shape[-1]
    return d.reshape(lead + (c * p.l, n))
