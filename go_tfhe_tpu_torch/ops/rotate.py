"""Negacyclic monomial multiplication  p(X) -> X^k * p(X), and its
extended (interleaved k-block) form (port of ``go_tfhe_tpu/ops/rotate.py``).

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


def monomial_mul_blocks(acc: torch.Tensor, t: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """Rotate an extended (degree k*N) negacyclic polynomial by X^t
    (``go_tfhe_tpu/ops/rotate.py:48-74``).

    The big polynomial is stored interleaved as k blocks,
    big[j] == block[j % k][j // k]; rotation by X^t is a block permutation
    plus per-block negacyclic Y = X^k rotations:

        out_block[r'] = Y^q * block[r],  r = (r'-t) mod k,  q = (t+r-r')/k

    acc: (..., k, C, N) int32 words.
    t:   integer tensor broadcastable to acc.shape[:-3]; taken mod 2kN.
    """
    n = acc.shape[-1]
    t = torch.remainder(t.to(torch.int64), 2 * k * n)
    lead = torch.broadcast_shapes(acc.shape[:-3], t.shape)
    acc = acc.expand(lead + acc.shape[-3:])
    r_out = torch.arange(k, device=acc.device)
    r_src = torch.remainder(r_out - t[..., None], k)              # (..., k)
    q = (t[..., None] + r_src - r_out) // k                       # exact, >= 0
    idx = r_src.expand(lead + (k,))[..., None, None].expand(acc.shape)
    gathered = torch.gather(acc, -3, idx)
    return monomial_mul(gathered, q[..., None])                   # over (C, N)


def _block_rotate_static(acc: torch.Tensor, shift: int, k: int
                         ) -> torch.Tensor:
    """Rotate the interleaved big polynomial by X^shift, shift a Python
    integer in [0, 2kN) (``go_tfhe_tpu/ops/rotate.py:77-102``).

    acc: (..., k, C, N).  With s = shift % k and q = shift // k:
    out_block[r'] = Y^(q+1) block[r'-s+k] for r' < s, Y^q block[r'-s]
    otherwise — static slices and concatenations only."""
    n = acc.shape[-1]
    s, q = shift % k, shift // k

    def rot_y(x: torch.Tensor, amount: int) -> torch.Tensor:
        amount %= 2 * n
        a = amount % n
        if a:
            x = torch.cat([torus_not(x[..., n - a:]), x[..., :n - a]],
                          dim=-1)
        return torus_not(x) if amount >= n else x

    hi = rot_y(acc[..., :k - s, :, :], q)          # plain:  Y^q
    if not s:
        return hi
    lo = rot_y(acc[..., k - s:, :, :], q + 1)      # wraps: Y^(q+1)
    return torch.cat([lo, hi], dim=-3)


def monomial_mul_blocks_log(acc: torch.Tensor, t: torch.Tensor, k: int
                            ) -> torch.Tensor:
    """Rotation of the extended polynomial by X^t composed from static
    rotations by 2^j selected by the bits of t (the JAX package's TPU form,
    ``go_tfhe_tpu/ops/rotate.py:105-124``).  Bit-exact with
    :func:`monomial_mul_blocks` for every t: each wraparound applies
    x -> ~x, and wrap parity composes as in :func:`monomial_mul_log`.

    acc: (..., k, C, N) int32 words;  t: integer tensor broadcastable to
    acc.shape[:-3]; taken mod 2kN."""
    n = acc.shape[-1]
    big = 2 * k * n
    t = torch.remainder(t.to(torch.int64), big)
    out = acc
    for j in range((big - 1).bit_length()):
        rolled = _block_rotate_static(out, (1 << j) % big, k)
        bit = (((t >> j) & 1) > 0)[..., None, None, None]
        out = torch.where(bit, rolled, out)
    return out


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
