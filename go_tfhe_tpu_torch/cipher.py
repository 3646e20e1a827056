"""Ciphertexts: encryption, decryption, phase, message encoding, the linear
operations (port of ``go_tfhe_tpu/cipher.py:38-191``).

Layouts as in the JAX package, words as int32:

* TLWE  level 0: ``(..., lwe_n+1)``, last word = b  (tlwe/tlwe.go:11)
* TLWE  level 1: ``(..., n+1)``
* TRLWE level 1: ``(..., 2, N)``, [0]=A poly, [1]=B poly
* TRGSW level 1: ``(..., 2L, 2, N)``, rows [A-gadget x L, B-gadget x L]

Every encryption draws from an explicit ``torch.Generator`` and returns
tensors on the key's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.polymul import negacyclic_mul_binary
from .params import TFHEParams
from .utils.rng import gaussian_torus, uniform_torus
from .utils.torus import TORUS, f64_to_torus, from_numpy_u32, i32, wrap_i32

BOOL_TRUE_MU = i32(int(f64_to_torus(0.125)))    # tlwe/tlwe.go:56
BOOL_FALSE_MU = i32(int(f64_to_torus(-0.125)))  # tlwe/tlwe.go:58


# ---------------------------------------------------------------------------
# LWE (level 0 and level 1 share the layout and the code).
# ---------------------------------------------------------------------------

def _lwe_inner(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """sum_i a[i]*key[i] mod 2^32 for a binary key (exact int64 sum)."""
    return wrap_i32((a * key).sum(dim=-1, dtype=torch.int64))


def lwe_encrypt_torus(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                      key: torch.Tensor) -> torch.Tensor:
    """Encrypt torus plaintext(s) mu (any shape S, int32 words) under a
    binary LWE key: uniform mask a, b = <a,s> + mu + e
    (tlwe/tlwe.go:36-50).  Returns (S, n+1)."""
    mu = mu.to(device=key.device, dtype=TORUS)
    n = key.shape[0]
    a = uniform_torus(gen, mu.shape + (n,), key.device)
    b = gaussian_torus(gen, mu, alpha, mu.shape) + _lwe_inner(a, key)
    return torch.cat([a, b[..., None]], dim=-1)


def lwe_phase(ct: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """b - <a, s>  (the noisy plaintext)."""
    n = key.shape[0]
    return ct[..., n] - _lwe_inner(ct[..., :n], key)


def lwe_encrypt_bool(gen: torch.Generator, bits, alpha: float,
                     key: torch.Tensor) -> torch.Tensor:
    """Boolean encoding +-1/8 (tlwe/tlwe.go:52-61)."""
    bits = torch.as_tensor(bits, dtype=torch.bool, device=key.device)
    mu = torch.where(bits, BOOL_TRUE_MU, BOOL_FALSE_MU).to(TORUS)
    return lwe_encrypt_torus(gen, mu, alpha, key)


def lwe_decrypt_bool(ct: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Sign of the phase (tlwe/tlwe.go:64-73)."""
    return lwe_phase(ct, key) >= 0


# ---------------------------------------------------------------------------
# Messages of a modulus-m space (programmable bootstrapping).
# ---------------------------------------------------------------------------

def encode_message(message, modulus: int) -> np.ndarray:
    """LWE message encoding m -> m * 2^31/modulus as uint32 words
    (tlwe/programmable_encrypt.go:12-26, computed exactly in float64)."""
    m = np.mod(np.asarray(message, np.int64), modulus)
    scale = float(1 << 31) / float(modulus)
    return f64_to_torus(m.astype(np.float64) * scale / float(1 << 32))


def lwe_encrypt_message(gen: torch.Generator, message, modulus: int,
                        alpha: float, key: torch.Tensor) -> torch.Tensor:
    """Encrypt message(s) of Z_modulus (host ints or an array) under a
    binary LWE key; on the key's device."""
    return lwe_encrypt_torus(
        gen, from_numpy_u32(encode_message(message, modulus), key.device),
        alpha, key)


def lwe_decrypt_message(ct: torch.Tensor, modulus: int,
                        key: torch.Tensor) -> torch.Tensor:
    """DivRound decode (tlwe/programmable_encrypt.go:32-54) of the uint32
    phase: scale = 2^31 // modulus, msg = ((phase + scale/2) // scale) mod
    modulus, with the phase read unsigned (int64) and the sum wrapped mod
    2^32 as in uint32 arithmetic.  Returns int32 messages."""
    phase = lwe_phase(ct, key).to(torch.int64) & 0xFFFFFFFF
    scale = (1 << 31) // modulus
    decoded = ((phase + scale // 2) & 0xFFFFFFFF) // scale
    return (decoded % modulus).to(torch.int32)


# Linear ops (tlwe/tlwe.go:76-134): int32 words wrap mod 2^32 as uint32 do.
# A multiplier is taken mod 2^32 as the int32 word with the same bits
# (utils.torus.i32), as every torus constant of the port is.

def lwe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def lwe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def lwe_neg(a: torch.Tensor) -> torch.Tensor:
    return -a


def lwe_add_mul(a: torch.Tensor, b: torch.Tensor, multiplier: int
                ) -> torch.Tensor:
    return a + b * i32(multiplier)


def lwe_sub_mul(a: torch.Tensor, b: torch.Tensor, multiplier: int
                ) -> torch.Tensor:
    return a - b * i32(multiplier)


# ---------------------------------------------------------------------------
# TRLWE and TRGSW.
# ---------------------------------------------------------------------------

def trlwe_encrypt_torus(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                        key: torch.Tensor, grid_bits: int = 0
                        ) -> torch.Tensor:
    """mu: (..., N) int32 words -> (..., 2, N): a uniform,
    b = Gaussian(mu) + a * s (negacyclic)  (trlwe/trlwe.go:28-50).

    ``grid_bits`` > 0 produces the ciphertext on the 2^grid_bits torus
    subgrid (TFHEParams.key_grid_bits): the mask is uniform on the grid
    and only the b-side noise is rounded to it; ``mu`` must be on it."""
    mu = mu.to(device=key.device, dtype=TORUS)
    a = uniform_torus(gen, mu.shape, key.device)
    noisy_mu = gaussian_torus(gen, mu, alpha, mu.shape)
    if grid_bits:
        keep = ~((1 << grid_bits) - 1)
        a = a & keep
        noisy_mu = (noisy_mu + (1 << (grid_bits - 1))) & keep
    b = noisy_mu + negacyclic_mul_binary(a, key)
    return torch.stack([a, b], dim=-2)


def trlwe_phase(ct: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """B - A * s: (..., 2, N) -> (..., N)."""
    return ct[..., 1, :] - negacyclic_mul_binary(ct[..., 0, :], key)


def trlwe_encrypt_bool(gen: torch.Generator, bits, alpha: float,
                       key: torch.Tensor) -> torch.Tensor:
    """Bits (..., N) in the +-1/8 encoding -> (..., 2, N)."""
    bits = torch.as_tensor(bits, dtype=torch.bool, device=key.device)
    mu = torch.where(bits, BOOL_TRUE_MU, BOOL_FALSE_MU).to(TORUS)
    return trlwe_encrypt_torus(gen, mu, alpha, key)


def trlwe_decrypt_bool(ct: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Sign of each phase coefficient (trlwe/trlwe.go:66-81)."""
    return trlwe_phase(ct, key) >= 0


def trgsw_encrypt_torus(gen: torch.Generator, p_torus: torch.Tensor,
                        alpha: float, key: torch.Tensor, prm: TFHEParams
                        ) -> torch.Tensor:
    """Encrypt torus scalar(s) as TRGSW: 2L zero-TRLWEs + gadget on the
    diagonal (trgsw/trgsw.go:32-57).  p_torus: shape S (typically key
    bits).  Returns (S, 2L, 2, N), on the 2^key_grid_bits grid (the gadget
    powers lie on it: key_grid_bits <= tail_bits)."""
    p_t = p_torus.to(device=key.device, dtype=TORUS)
    shape = tuple(p_t.shape)
    zeros = torch.zeros(shape + (2 * prm.l, prm.n), dtype=TORUS,
                        device=key.device)
    ct = trlwe_encrypt_torus(gen, zeros, alpha, key,
                             grid_bits=prm.key_grid_bits)  # (S, 2L, 2, N)
    g = torch.tensor([i32(v) for v in prm.gadget_powers], dtype=TORUS,
                     device=key.device)
    add = p_t[..., None] * g                               # (S, L)
    ct[..., :prm.l, 0, 0] += add
    ct[..., prm.l:, 1, 0] += add
    return ct
