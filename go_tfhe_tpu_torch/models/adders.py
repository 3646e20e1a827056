"""Homomorphic adders (port of ``go_tfhe_tpu/models/adders.py``).

* Ripple-carry adder over encrypted bit vectors (the reference documents
  this as README code only, README.md:78-115).
* The one-bootstrap many-LUT full adder and its ripple.
* PBS nibble adder: 8-bit addition in 3 programmable bootstraps using a
  messageModulus-32 profile (examples/add_two_numbers/main.go:44-136).

All functions broadcast over leading batch axes: ``a_bits``/``b_bits`` of
shape (..., nbits, lwe_n+1) add (...) independent pairs of numbers at once.
The look-up tables are built once per profile on the host and placed on
the ciphertexts' device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import engine, gates, lut
from ..keys import CloudKey
from ..params import TFHEParams
from ..utils.torus import TORUS, from_numpy_u32, to_numpy_u32


def half_adder(ck: CloudKey, a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, carry) = (a XOR b, a AND b)."""
    return gates.XOR(ck, a, b), gates.AND(ck, a, b)


def full_adder(ck: CloudKey, a: torch.Tensor, b: torch.Tensor,
               carry_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-bit full adder (README.md:78-115):
    s = (a^b)^cin;  cout = (a&b) | (cin & (a^b))."""
    axb = gates.XOR(ck, a, b)
    s = gates.XOR(ck, axb, carry_in)
    c1 = gates.AND(ck, a, b)
    c2 = gates.AND(ck, carry_in, axb)
    carry_out = gates.OR(ck, c1, c2)
    return s, carry_out


def ripple_carry_add(ck: CloudKey, a_bits: torch.Tensor,
                     b_bits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add two little-endian encrypted bit vectors.

    a_bits, b_bits: (..., nbits, lwe_n+1).  Returns (sum_bits, carry_out).
    5 bootstraps per bit position (the bit chain is sequential; the batch
    axes are where the card's parallelism comes from)."""
    nbits = a_bits.shape[-2]
    batch = a_bits.shape[:-2]
    carry = gates.constant(ck.params, False, batch, device=a_bits.device)
    outs = []
    for i in range(nbits):
        s, carry = full_adder(ck, a_bits[..., i, :], b_bits[..., i, :], carry)
        outs.append(s)
    return torch.stack(outs, dim=-2), carry


# ---------------------------------------------------------------------------
# Many-LUT full adder: one bootstrap per bit.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sum_carry_table(p: TFHEParams) -> np.ndarray:
    """The many-LUT full adder's (2, N) table, built once per profile
    (host uint32 words): sum = s & 1 at extraction index 0, carry =
    s >> 1 at index 1, both in the modulus-8 encoding."""
    gen = lut.Generator(p, 8, device="cpu")
    return to_numpy_u32(gen.gen_multi_lut(
        [lambda x: x & 1, lambda x: (x >> 1) & 1], theta=1))


def full_adder_manylut(ck: CloudKey, a: torch.Tensor, b: torch.Tensor,
                       carry_in: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-bit full adder in ONE bootstrap via multi-LUT extraction
    (engine.bootstrap_many), vs 5 bootstraps for the boolean-gate form.

    Inputs are bits encrypted as messages in the modulus-8 space
    (bitutils.encrypt_bits_messages): the linear sum a+b+cin has phase
    (a+b+cin)/16 in [0, 1/4], entirely inside the first torus half, so
    both output functions avoid the negacyclic antisymmetry constraint
    that blocks XOR in the +-1/8 boolean encoding.  One coarse (theta=1)
    blind rotation; extraction index 0 is the sum bit, index 1 the carry,
    both re-encoded in the same modulus-8 space so stages chain."""
    mlut = from_numpy_u32(_sum_carry_table(ck.params), a.device)
    out = engine.bootstrap_many(ck, a + b + carry_in, mlut, k=2, theta=1)
    return out[0], out[1]


def ripple_add_manylut(ck: CloudKey, a_bits: torch.Tensor,
                       b_bits: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ripple-carry addition at ONE bootstrap per bit position (vs 5 for
    :func:`ripple_carry_add`) using the many-LUT full adder.

    a_bits, b_bits: (..., nbits, lwe_n+1), bits encrypted as modulus-8
    messages.  Returns (sum_bits, carry_out) in the same encoding."""
    mlut = from_numpy_u32(_sum_carry_table(ck.params), a_bits.device)
    nbits = a_bits.shape[-2]
    batch = a_bits.shape[:-2]
    carry = torch.zeros(batch + (ck.params.lwe_n + 1,), dtype=TORUS,
                        device=a_bits.device)
    outs = []
    for i in range(nbits):
        t = a_bits[..., i, :] + b_bits[..., i, :] + carry
        res = engine.bootstrap_many(ck, t, mlut, k=2, theta=1)
        outs.append(res[0])
        carry = res[1]
    return torch.stack(outs, dim=-2), carry


# ---------------------------------------------------------------------------
# PBS nibble adder (examples/add_two_numbers/main.go).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _adder_tables(p: TFHEParams) -> Tuple[np.ndarray, np.ndarray]:
    """The nibble method's tables (host uint32 words), built once per
    profile: low sum mod 16 and carry (x >= 16)."""
    gen = lut.Generator(p, 32, device="cpu")
    return (to_numpy_u32(gen.gen_lut(lambda x: x % 16)),
            to_numpy_u32(gen.gen_lut(lambda x: 1 if x >= 16 else 0)))


def make_adder_luts(ck: CloudKey, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LUTs of the nibble method (examples/add_two_numbers/main.go:
    54-76): sum mod 16 and carry, on ``device`` (the key's by default).
    Requires message_modulus >= 32 (e.g. the uint5 profile)."""
    device = ck.testvec.device if device is None else device
    return tuple(from_numpy_u32(t, device) for t in _adder_tables(ck.params))


def add8_pbs(ck: CloudKey, ct_a_low: torch.Tensor, ct_a_high: torch.Tensor,
             ct_b_low: torch.Tensor, ct_b_high: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """8-bit addition with 3 bootstraps
    (examples/add_two_numbers/main.go:98-136).

    Nibbles are LWE-message encryptions with modulus 32 (Uint5 encoding).
    Returns (ct_sum_low, ct_sum_high), message encryptions of the result
    nibbles.  Batched over leading axes."""
    lut_sum, lut_carry = make_adder_luts(ck, ct_a_low.device)
    temp_low = ct_a_low + ct_b_low                          # homomorphic add
    sum_low = lut.bootstrap_lut(ck, temp_low, lut_sum)      # PBS 1
    carry = lut.bootstrap_lut(ck, temp_low, lut_carry)      # PBS 2
    temp_high = ct_a_high + ct_b_high + carry
    sum_high = lut.bootstrap_lut(ck, temp_high, lut_sum)    # PBS 3
    return sum_low, sum_high
