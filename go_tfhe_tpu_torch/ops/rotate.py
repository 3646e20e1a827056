"""Negacyclic monomial multiplication  p(X) -> X^k * p(X)
(port of ``go_tfhe_tpu/ops/rotate.py``).

Wrapped coefficients take the reference's cheap negation ``^Torus(0) - a``
(bitwise NOT), as in the JAX package, which keeps bit-exact parity.
"""

from __future__ import annotations

import torch

from ..utils.torus import torus_not


def monomial_mul(poly: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Multiply polynomials by X^k (negacyclic, NOT-negation).

    poly: (..., N) int32 words.
    k:    integer tensor broadcastable to poly.shape[:-1]; interpreted
          mod 2N.
    """
    n = poly.shape[-1]
    k2 = torch.remainder(k.to(torch.int64), 2 * n)
    r = torch.remainder(k2, n)[..., None]
    flip = (k2 >= n)[..., None]
    i = torch.arange(n, device=poly.device)
    src = torch.remainder(i - r, n)
    shape = torch.broadcast_shapes(poly.shape, src.shape)
    gathered = torch.gather(poly.expand(shape), -1, src.expand(shape))
    neg = (i < r) ^ flip
    return torch.where(neg, torus_not(gathered), gathered)


def monomial_mul_log(poly: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Rotation by X^k composed from static rotations by 2^j selected by the
    bits of k (the JAX package's TPU form).  Bit-exact with
    :func:`monomial_mul`: each wraparound applies x -> ~x, and w wraps give
    x for even w and ~x for odd w, as the single rotation does."""
    n = poly.shape[-1]
    k = k.to(torch.int64)
    out = poly
    for j in range(n.bit_length()):                # shifts 1, 2, ..., N
        s = 1 << j
        if s < n:
            rolled = torch.cat([torus_not(out[..., n - s:]),
                                out[..., :n - s]], dim=-1)
        else:                                      # X^N == -1
            rolled = torus_not(out)
        bit = (((k >> j) & 1) > 0)[..., None]
        out = torch.where(bit, rolled, out)
    return out
