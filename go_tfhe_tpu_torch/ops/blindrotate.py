"""Blind rotation — the bootstrap hot loop, batched over ciphertexts
(port of ``go_tfhe_tpu/ops/blindrotate.py:39-79, 162-255, 338-531``).

Per input LWE coefficient the accumulator is rotated by the mod-switched
coefficient and CMUXed with the corresponding bootstrapping-key row; the
lwe_n steps are sequential and throughput comes from the batch axis.  One
code path serves both devices: the two step kernels (ops/cuda_t.py) run
their plain versions on CPU tensors and the Hopper kernels on CUDA tensors.

Mod switch (evaluator/evaluator.go:116,122):
    b~ = 2N - ((b + 2^(31-NBIT-1)) >> (32-NBIT-1))
    a~ =      ((a + 2^(31-NBIT-1)) >> (32-NBIT-1))

Extended look-up tables (poly_extend_factor k > 1) rotate an interleaved
big accumulator of k blocks over [0, 2kN]: :func:`blind_rotate_extended_t`
(transposed, K4 + K5, ops/cuda_ext_t.py) for the profiles that pass
``ext_t_fits``, :func:`blind_rotate_extended_rm` (row-major, K6 + K8,
ops/cuda_ext.py and ops/cuda_extprod.py) for uint8.

Block-binary keys (Hamming weight <= 1 per block of ``block_size`` bits)
may take :func:`blind_rotate_block`: one step per block, K7 + K8
(ops/cuda_rotate.py, ops/cuda_extprod.py).

:func:`blind_rotate_tpu` is the per-bit rotation in the row-major layout:
K7 at bs = 1 + K8 per step, or the fused step K3 (ops/cuda_step.py) with
:data:`FUSED_STEP`.  The half-batch pipelined rotation (K1 + K9) is
ops/cuda_pipe.blind_rotate_pipe.

Every function reads the K2 bands (cuda_t.pack_bsk_band_t), the port's one
band layout.
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import shr, wrap_i32
from .cuda_ext import rotate_decompose_ext, rotate_decompose_ext_ref
from .cuda_ext_t import (extprod_ext_t, extprod_ext_t_ref,
                         rotate_decompose_ext_t, rotate_decompose_ext_t_ref)
from .cuda_extprod import extprod, extprod_ref
from .cuda_rotate import rotate_decompose, rotate_decompose_ref
from .cuda_step import fused_rotate_step, fused_rotate_step_ref
from .cuda_t import (band_limb_drop, extprod_t, extprod_t_ref,
                     rotate_decompose_t, rotate_decompose_t_ref)
from .rotate import monomial_mul, monomial_mul_blocks

# Run blind_rotate_tpu's steps through the fused step kernel K3 instead of
# K7 + K8.  Off by default, as in the JAX package
# (go_tfhe_tpu/ops/blindrotate.py:39-47), whose reason is a TPU
# measurement: Mosaic ran the fused kernel's rotation and contraction one
# after the other.  On an H100 the unfused step is ahead too (K7 + K8
# 10,953 vs K3 3,344 gates/s at 128bit_fast, batch 4096; PERF.md): K3
# recomputes a batch tile's digits in each of the 2*N/64 blocks that read
# it.
FUSED_STEP = False


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
    n_lwe, nd, lo = p.lwe_n, p.digit_limbs, band_limb_drop(p)
    b = ct.shape[0]
    b_tilda = 2 * p.n - mod_switch_2n(ct[:, n_lwe], p, theta)      # (B,)
    tv = testvec.expand(b, 2, p.n)
    acc = monomial_mul(tv, b_tilda[:, None])                       # (B, 2, N)
    acc = acc.permute(1, 2, 0).contiguous()                        # (2, N, B)
    a_tilda = mod_switch_2n(ct[:, :n_lwe], p, theta).t().contiguous()
    for i in range(n_lwe):
        digits = rotate_decompose(p, acc, a_tilda[i])
        acc = extprod(digits, bands[i], acc, nd, lo)
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
    lo = band_limb_drop(p)
    big = 2 * k * n
    b = ct.shape[0]
    b_tilda = big - mod_switch_general(ct[:, n_lwe], big)           # (B,)
    acc = monomial_mul_blocks(lut_blocks.expand(b, k, 2, n), b_tilda, k)
    # (B, k, 2, N) -> (2, k*N, B): block r in rows [rN, (r+1)N)
    acc = acc.permute(2, 1, 3, 0).reshape(2, k * n, b).contiguous()
    a_tilda = mod_switch_general(ct[:, :n_lwe], big).t().contiguous()
    for i in range(n_lwe):
        digits = rotate_decompose(p, acc, a_tilda[i])
        acc = extprod(digits, bands[i], acc, k, nd, lo)
    return acc.reshape(2, k, n, b).permute(3, 1, 0, 2).contiguous()


def blind_rotate_extended_rm(p: TFHEParams, bands: torch.Tensor,
                             ct: torch.Tensor, lut_blocks: torch.Tensor,
                             plain: bool = False) -> torch.Tensor:
    """Row-major blind rotation over an extended look-up table
    (``go_tfhe_tpu/ops/blindrotate.py:162-218``, blind_rotate_extended_tpu),
    bit-exact with :func:`blind_rotate_extended_t`.  Per step, K6 rotates
    and decomposes the (2, B, k*N) big accumulator, and K8 contracts the
    digits with the k blocks folded into the batch (every block against
    the same band) and adds the result into the accumulator.

    bands:      (n_lwe, 2, 2L, 2N) int32 K2 bands.
    ct:         (B, n_lwe+1) int32 words.
    lut_blocks: (k, 2, N) or (B, k, 2, N) int32 trivial TRLWE blocks.
    plain:      run the kernels' plain versions on any device.
    Returns (B, k, 2, N); the bootstrap reads block 0 at index 0.
    """
    rotate_decompose_e = (rotate_decompose_ext_ref if plain
                          else rotate_decompose_ext)
    contract = extprod_ref if plain else extprod
    n_lwe, k, n, nd = p.lwe_n, p.poly_extend_factor, p.n, p.digit_limbs
    lo = band_limb_drop(p)
    big = 2 * k * n
    b = ct.shape[0]
    b_tilda = big - mod_switch_general(ct[:, n_lwe], big)           # (B,)
    acc = monomial_mul_blocks(lut_blocks.expand(b, k, 2, n), b_tilda, k)
    # (B, k, 2, N) -> (2, B, k*N): block r in columns [rN, (r+1)N)
    acc = acc.permute(2, 0, 1, 3).reshape(2, b, k * n).contiguous()
    a_tilda = mod_switch_general(ct[:, :n_lwe], big).t().contiguous()
    for i in range(n_lwe):
        digits = rotate_decompose_e(p, acc, a_tilda[i])
        acc = contract(digits.view(b * k, -1), bands[i],
                       acc.view(2, b * k, n), nd, lo).view(2, b, k * n)
    return acc.view(2, b, k, n).permute(1, 2, 0, 3).contiguous()


def block_bands(p: TFHEParams, bands: torch.Tensor) -> torch.Tensor:
    """The K2 bands of the full blocks as K8 reads them in a block step:
    (full, 2, bs*2L, 2N), rows block-bit-major (block bit j, then its 2L
    BSK rows), the order of ``go_tfhe_tpu/ops/blindrotate.py:497-503`` and
    of K7's digit rows.  A copy of the first full*bs bands, made once per
    blind rotation."""
    bs, l2 = p.block_size, 2 * p.l
    full = p.lwe_n // bs
    w = bands.shape[-1]
    return bands[:full * bs].reshape(full, bs, 2, l2, w).transpose(1, 2
                                                                   ).reshape(
        full, 2, bs * l2, w)


def blind_rotate_block(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                       testvec: torch.Tensor, plain: bool = False
                       ) -> torch.Tensor:
    """Block blind rotation (``go_tfhe_tpu/ops/blindrotate.py:451-531``,
    blind_rotate_block_tpu; bit-exact with the portable blind_rotate_block,
    :258-310, on keys whose dropped limbs are zero).  Needs a block-binary
    lv0 key: with at most one key bit set per block,
    X^(sum_j s_j a_j) = 1 + sum_j s_j (X^(a_j) - 1), so one step per block
    of bs = block_size bits is

        acc' = acc + sum_j BSK[j] (x) (X^(a_j) acc - acc):

    K7 rotates the same accumulator by the block's bs amounts and
    decomposes, K8 contracts the bs*2L digit rows against the block's bands
    (:func:`block_bands`) and adds into the accumulator.  ceil(n_lwe / bs)
    sequential steps instead of n_lwe; a ragged tail of n_lwe mod bs bits
    runs per-bit steps (K7 with bs = 1, K8 over 2L rows).

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands.
    ct:      (B, n_lwe+1) int32 words.
    testvec: (2, N) or (B, 2, N) int32 words.
    plain:   run the kernels' plain versions on any device.
    Returns (B, 2, N) int32 TRLWE accumulators.
    """
    rotate = rotate_decompose_ref if plain else rotate_decompose
    contract = extprod_ref if plain else extprod
    n_lwe, bs, nd = p.lwe_n, p.block_size, p.digit_limbs
    lo = band_limb_drop(p)
    full, rem = divmod(n_lwe, bs)
    b = ct.shape[0]
    b_tilda = 2 * p.n - mod_switch_2n(ct[:, n_lwe], p)             # (B,)
    acc = monomial_mul(testvec.expand(b, 2, p.n), b_tilda[:, None])
    acc = acc.transpose(0, 1).contiguous()                          # (2, B, N)
    a_tilda = mod_switch_2n(ct[:, :n_lwe], p).t().contiguous()      # (n_lwe, B)
    a_blk = a_tilda[:full * bs].view(full, bs, b)
    band_blk = block_bands(p, bands)
    for i in range(full):
        digits = rotate(p, acc, a_blk[i])
        acc = contract(digits, band_blk[i], acc, nd, lo)
    for idx in range(full * bs, n_lwe):                # ragged tail, per bit
        digits = rotate(p, acc, a_tilda[idx])
        acc = contract(digits, bands[idx], acc, nd, lo)
    return acc.transpose(0, 1).contiguous()                         # (B, 2, N)


def blind_rotate_tpu(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                     testvec: torch.Tensor, plain: bool = False
                     ) -> torch.Tensor:
    """Per-bit blind rotation in the row-major layout
    (``go_tfhe_tpu/ops/blindrotate.py:338-407``), bit-exact with
    :func:`blind_rotate_t`.  The accumulator lives as (2, B, N); per step,
    the fused kernel K3 when :data:`FUSED_STEP` is set and the digits fit
    int8 (the JAX package's condition, :386-387), else K7 at bs = 1 and K8
    with the accumulator (multi-limb profiles with K7/K8's ``nd`` limbs).
    The TPU's ``tb``/``tn`` tiling arguments are not ported.

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands (cuda_t.pack_bsk_band_t).
    ct:      (B, n_lwe+1) int32 words.
    testvec: (2, N) or (B, 2, N) int32 words.
    plain:   run the kernels' plain versions on any device.
    Returns (B, 2, N) int32 TRLWE accumulators.
    """
    step = fused_rotate_step_ref if plain else fused_rotate_step
    rotate = rotate_decompose_ref if plain else rotate_decompose
    contract = extprod_ref if plain else extprod
    n_lwe, nd, lo = p.lwe_n, p.digit_limbs, band_limb_drop(p)
    int8_ok = 2 * p.l * p.n * min(p.half_bg, 128) * 128 < 1 << 31
    fused = FUSED_STEP and p.digits_fit_int8 and int8_ok
    b = ct.shape[0]
    b_tilda = 2 * p.n - mod_switch_2n(ct[:, n_lwe], p)             # (B,)
    acc = monomial_mul(testvec.expand(b, 2, p.n), b_tilda[:, None])
    acc = acc.transpose(0, 1).contiguous()                          # (2, B, N)
    a_tilda = mod_switch_2n(ct[:, :n_lwe], p).t().contiguous()     # (n_lwe, B)
    for i in range(n_lwe):
        if fused:
            acc = step(p, acc, a_tilda[i], bands[i])
        else:
            acc = contract(rotate(p, acc, a_tilda[i]), bands[i], acc, nd,
                           lo)
    return acc.transpose(0, 1).contiguous()                         # (B, 2, N)
