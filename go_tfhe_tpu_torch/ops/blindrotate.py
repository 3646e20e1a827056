"""Blind rotation — the bootstrap hot loop, batched over ciphertexts
(port of ``go_tfhe_tpu/ops/blindrotate.py:50-79, 221-255, 410-448``).

Per input LWE coefficient the accumulator is rotated by the mod-switched
coefficient and CMUXed with the corresponding bootstrapping-key row; the
lwe_n steps are sequential and throughput comes from the batch axis.  One
code path serves both devices: the two step kernels (ops/cuda_t.py) run
their plain versions on CPU tensors and the Hopper kernels on CUDA tensors.

Mod switch (evaluator/evaluator.go:116,122):
    b~ = 2N - ((b + 2^(31-NBIT-1)) >> (32-NBIT-1))
    a~ =      ((a + 2^(31-NBIT-1)) >> (32-NBIT-1))

Extended look-up tables (poly_extend_factor k > 1) rotate an interleaved
big accumulator of k blocks over [0, 2kN] (:func:`blind_rotate_extended_t`,
kernels in ops/cuda_ext_t.py).
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import shr, wrap_i32
from .cuda_ext_t import (extprod_ext_t, extprod_ext_t_ref,
                         rotate_decompose_ext_t, rotate_decompose_ext_t_ref)
from .cuda_t import (extprod_t, extprod_t_ref, rotate_decompose_t,
                     rotate_decompose_t_ref)
from .rotate import monomial_mul, monomial_mul_blocks


def mod_switch_2n(x: torch.Tensor, p: TFHEParams, theta: int = 0
                  ) -> torch.Tensor:
    """Torus -> [0, 2N] rounding mod-switch; returns int32.  ``theta > 0``
    rounds to multiples of 2^theta (the PBSmanyLUT coarse mod switch)."""
    shift = p.mod_switch_shift + theta
    coarse = shr(x + (1 << (shift - 1)), shift)
    return coarse << theta


def mod_switch_general(x: torch.Tensor, modulus: int) -> torch.Tensor:
    """Torus -> [0, modulus] rounding mod switch for any modulus <= 2^17:
    floor((x*M + 2^31) / 2^32), computed as the JAX package computes it in
    uint32 words (16-bit halves; every product and sum wraps mod 2^32),
    here in int64 with explicit masks.  Returns int32."""
    if modulus > 1 << 17:
        raise ValueError(f"modulus {modulus} > 2^17")
    mask = 0xFFFFFFFF
    x = x.to(torch.int64) & mask
    a_hi, a_lo = x >> 16, x & 0xFFFF
    acc = a_hi * modulus + (((a_lo * modulus) & mask) >> 16) + (1 << 15)
    return wrap_i32((acc & mask) >> 16)


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


def blind_rotate_extended_t(p: TFHEParams, bands: torch.Tensor,
                            ct: torch.Tensor, lut_blocks: torch.Tensor,
                            plain: bool = False) -> torch.Tensor:
    """Blind rotation over an extended look-up table of size k*N
    (``go_tfhe_tpu/ops/blindrotate.py:221-255``).

    bands:      (n_lwe, 2, 2L, 2N) int32 K2 bands; every block contracts
                against the same band.
    ct:         (B, n_lwe+1) int32 words.
    lut_blocks: (k, 2, N) or (B, k, 2, N) int32 trivial TRLWE blocks.
    plain:      run the kernels' plain versions on any device.
    Returns (B, k, 2, N); the bootstrap reads block 0 at index 0.
    """
    rotate_decompose = (rotate_decompose_ext_t_ref if plain
                        else rotate_decompose_ext_t)
    extprod = extprod_ext_t_ref if plain else extprod_ext_t
    n_lwe, k, n, nd = p.lwe_n, p.poly_extend_factor, p.n, p.digit_limbs
    big = 2 * k * n
    b = ct.shape[0]
    b_tilda = big - mod_switch_general(ct[:, n_lwe], big)           # (B,)
    acc = monomial_mul_blocks(lut_blocks.expand(b, k, 2, n), b_tilda, k)
    # (B, k, 2, N) -> (2, k*N, B): block r in rows [rN, (r+1)N)
    acc = acc.permute(2, 1, 3, 0).reshape(2, k * n, b).contiguous()
    a_tilda = mod_switch_general(ct[:, :n_lwe], big).t().contiguous()
    for i in range(n_lwe):
        digits = rotate_decompose(p, acc, a_tilda[i])
        acc = extprod(digits, bands[i], acc, k, nd)
    return acc.reshape(2, k, n, b).permute(3, 1, 0, 2).contiguous()
