"""Randomness on the torus from an explicit ``torch.Generator``
(port of ``go_tfhe_tpu/utils/rng.py``).

Every draw runs on the generator's own device and the result moves to
``device``.  The numbers differ from ``jax.random``'s; what matches is the
distribution: uniform 32-bit masks, Gaussian noise of standard deviation
``stddev`` torus units, uniform binary keys.
"""

from __future__ import annotations

import torch

from .torus import TORUS, MOD32, wrap_i32


def uniform_torus(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform torus elements (rng.Uint32() in tlwe/tlwe.go:42)."""
    x = torch.randint(-(1 << 31), 1 << 31, tuple(shape), dtype=TORUS,
                      generator=gen, device=gen.device)
    return x.to(device)


def gaussian_torus(gen: torch.Generator, mu: torch.Tensor, stddev: float,
                   shape) -> torch.Tensor:
    """mu + F64ToTorus(N(0,1) * stddev)  (utils/utils.go:31-34), drawn in
    float64 and truncated toward zero as Go's int64() does; on ``mu``'s
    device."""
    noise = torch.randn(tuple(shape), dtype=torch.float64, generator=gen,
                        device=gen.device) * stddev
    t = torch.trunc(torch.fmod(noise, 1.0) * float(MOD32)).to(torch.int64)
    return mu + wrap_i32(t).to(mu.device)


def binary_key(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """Uniform binary secret key bits in {0,1} (key/key.go:25-39)."""
    x = torch.randint(0, 2, (n,), dtype=TORUS, generator=gen,
                      device=gen.device)
    return x.to(device)


def block_binary_key(gen: torch.Generator, n: int, block_size: int,
                     device) -> torch.Tensor:
    """Block-binary secret key bits (``go_tfhe_tpu/utils/rng.py:34-53``):
    Hamming weight <= 1 per block of ``block_size`` bits, each block
    uniform over its block_size + 1 patterns of weight <= 1.  A ragged
    final block of r = n mod block_size bits is sampled the same way over
    its r + 1 patterns."""
    bs = block_size
    full, rem = divmod(n, bs)
    u = torch.randint(0, bs + 1, (full,), generator=gen, device=gen.device)
    bits = (u[:, None] == torch.arange(bs, device=gen.device)).reshape(-1)
    if rem:
        v = torch.randint(0, rem + 1, (1,), generator=gen, device=gen.device)
        bits = torch.cat([bits, v == torch.arange(rem, device=gen.device)])
    return bits.to(TORUS).to(device)
