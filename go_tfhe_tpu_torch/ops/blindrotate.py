"""Blind rotation — the bootstrap hot loop, batched over ciphertexts
(port of ``go_tfhe_tpu/ops/blindrotate.py:50-63, 410-448``).

Per input LWE coefficient the accumulator is rotated by the mod-switched
coefficient and CMUXed with the corresponding bootstrapping-key row; the
lwe_n steps are sequential and throughput comes from the batch axis.  One
code path serves both devices: the two step kernels (ops/cuda_t.py) run
their plain versions on CPU tensors and the Hopper kernels on CUDA tensors.

Mod switch (evaluator/evaluator.go:116,122):
    b~ = 2N - ((b + 2^(31-NBIT-1)) >> (32-NBIT-1))
    a~ =      ((a + 2^(31-NBIT-1)) >> (32-NBIT-1))
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import shr
from .cuda_t import (extprod_t, extprod_t_ref, rotate_decompose_t,
                     rotate_decompose_t_ref)
from .rotate import monomial_mul


def mod_switch_2n(x: torch.Tensor, p: TFHEParams, theta: int = 0
                  ) -> torch.Tensor:
    """Torus -> [0, 2N] rounding mod-switch; returns int32.  ``theta > 0``
    rounds to multiples of 2^theta (the PBSmanyLUT coarse mod switch)."""
    shift = p.mod_switch_shift + theta
    coarse = shr(x + (1 << (shift - 1)), shift)
    return coarse << theta


def blind_rotate_t(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                   testvec: torch.Tensor, theta: int = 0,
                   plain: bool = False) -> torch.Tensor:
    """Blind-rotate a batch of LWE ciphertexts.

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands (cuda_t.pack_bsk_band_t).
    ct:      (B, n_lwe+1) int32 words.
    testvec: (2, N) or (B, 2, N) int32 words.
    plain:   run the kernels' plain versions on any device (to hold the
             kernels against them on the card).
    Returns (B, 2, N) int32 TRLWE accumulators.
    """
    rotate_decompose = rotate_decompose_t_ref if plain else rotate_decompose_t
    extprod = extprod_t_ref if plain else extprod_t
    n_lwe, nd = p.lwe_n, p.digit_limbs
    b = ct.shape[0]
    b_tilda = 2 * p.n - mod_switch_2n(ct[:, n_lwe], p, theta)      # (B,)
    tv = testvec.expand(b, 2, p.n)
    acc = monomial_mul(tv, b_tilda[:, None])                       # (B, 2, N)
    acc = acc.permute(1, 2, 0).contiguous()                        # (2, N, B)
    a_tilda = mod_switch_2n(ct[:, :n_lwe], p, theta).t().contiguous()
    for i in range(n_lwe):
        digits = rotate_decompose(p, acc, a_tilda[i])
        acc = extprod(digits, bands[i], acc, nd)
    return acc.permute(2, 0, 1).contiguous()                       # (B, 2, N)
