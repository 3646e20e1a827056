"""Homomorphic comparisons over message-encoded integers (port of
``go_tfhe_tpu/models/comparators.py``; no reference equivalent).

Values are LWE messages in a modulus-m space (cipher.lwe_encrypt_message)
restricted to [0, m/2): the difference a - b then has torus phase
(a-b)/(2m) strictly inside (-1/2, 1/2), so its sign decides the
comparison: one gate-style bootstrap with the constant test vector per
comparison.  A +1/(4m) half-segment bias keeps the a == b case off the
decision boundary.

Outputs are standard +-1/8 boolean ciphertexts, composable with every
gate.
"""

from __future__ import annotations

import torch

from .. import engine, gates
from ..keys import CloudKey
from ..utils.torus import f64_to_torus, i32


def ge(ck: CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor,
       m: int | None = None) -> torch.Tensor:
    """Boolean ciphertext of (a >= b); a, b message-encoded in [0, m/2).
    The gate bootstrap's constant test vector extracts the sign."""
    m = ck.params.message_modulus if m is None else m
    d = ct_a - ct_b
    d[..., -1] += i32(int(f64_to_torus(1.0 / (4 * m))))
    return engine.bootstrap(ck, d)


def le(ck: CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor,
       m: int | None = None) -> torch.Tensor:
    """Boolean ciphertext of (a <= b)."""
    return ge(ck, ct_b, ct_a, m)


def gt(ck: CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor,
       m: int | None = None) -> torch.Tensor:
    """Boolean ciphertext of (a > b) = NOT(a <= b); the NOT is free."""
    return gates.NOT(le(ck, ct_a, ct_b, m))


def lt(ck: CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor,
       m: int | None = None) -> torch.Tensor:
    """Boolean ciphertext of (a < b) = NOT(a >= b)."""
    return gates.NOT(ge(ck, ct_a, ct_b, m))


def eq(ck: CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor,
       m: int | None = None) -> torch.Tensor:
    """Boolean ciphertext of (a == b) = (a >= b) AND (b >= a):
    2 comparison bootstraps + 1 gate bootstrap."""
    return gates.AND(ck, ge(ck, ct_a, ct_b, m), ge(ck, ct_b, ct_a, m))


def neq(ck: CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor,
        m: int | None = None) -> torch.Tensor:
    """Boolean ciphertext of (a != b) = NAND of the two one-sided
    comparisons (same 3 bootstraps as eq)."""
    return gates.NAND(ck, ge(ck, ct_a, ct_b, m), ge(ck, ct_b, ct_a, m))
