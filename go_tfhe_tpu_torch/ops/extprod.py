"""External product and CMUX on TRLWE ciphertexts, batched and exact
(port of ``go_tfhe_tpu/ops/extprod.py``).

external_product: gadget decomposition, then one contraction of the digits
against the TRGSW's signed D band through its materialized Toeplitz
(:func:`.polymul.negacyclic_extprod_toeplitz`: three float64 products,
exact mod 2^32).  This is the JAX package's portable step, the one its
blind rotations run off the TPU; the port's blind rotations run the Hopper
kernels instead, and this form serves the portable rotations of
:mod:`.blindrotate`.

CMUX(cond, ct0, ct1) = ct0 + cond (*) (ct1 - ct0)
(trgsw/trgsw.go:173-194, evaluator/evaluator.go:85-106).
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from .decompose import gadget_decompose
from .polymul import negacyclic_extprod_toeplitz


def external_product(p: TFHEParams, band: torch.Tensor,
                     trlwe: torch.Tensor) -> torch.Tensor:
    """band (x) trlwe: band (2L, 2, 2N) int32 D band
    (polymul.ext_band_from_trgsw), trlwe (..., 2, N) int32 words ->
    (..., 2, N) int32 words."""
    digits = gadget_decompose(trlwe, p)            # (..., 2L, N)
    return negacyclic_extprod_toeplitz(digits, band)


def cmux(p: TFHEParams, band: torch.Tensor, ct0: torch.Tensor,
         ct1: torch.Tensor) -> torch.Tensor:
    """if cond == 0: ct0 else ct1, homomorphically:
    ct0 + cond (x) (ct1 - ct0)."""
    return ct0 + external_product(p, band, ct1 - ct0)
