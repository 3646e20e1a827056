"""Bit packing and bit-level encryption (port of ``go_tfhe_tpu/bitutils.py``;
reference: bitutils/bitutils.go).

Bits are little-endian (LSB first) like the Go API.  The integer helpers
are host numpy.  ``encrypt_bits`` / ``decrypt_bits`` are single batched
calls, replacing the reference's per-bit loop (bitutils/bitutils.go:85-100);
they draw from a ``torch.Generator`` and return tensors on the key's
device, as :mod:`cipher` does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cipher


def to_bits(val: int, size: int) -> np.ndarray:
    """bitutils/bitutils.go:56-62: LSB-first bool vector."""
    v = np.asarray(val, np.uint64)
    return ((v >> np.arange(size, dtype=np.uint64)) & 1).astype(bool)


def from_bits(bits) -> int:
    """bitutils/bitutils.go:10-52: LSB-first bits -> integer."""
    bits = np.asarray(bits, bool)
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def u8_to_bits(v: int) -> np.ndarray:
    return to_bits(v, 8)


def u16_to_bits(v: int) -> np.ndarray:
    return to_bits(v, 16)


def u32_to_bits(v: int) -> np.ndarray:
    return to_bits(v, 32)


def u64_to_bits(v: int) -> np.ndarray:
    return to_bits(v, 64)


def bits_to_u8(bits) -> int:
    return from_bits(bits) & 0xFF


def bits_to_u16(bits) -> int:
    return from_bits(bits) & 0xFFFF


def bits_to_u32(bits) -> int:
    return from_bits(bits) & 0xFFFFFFFF


def bits_to_u64(bits) -> int:
    return from_bits(bits) & 0xFFFFFFFFFFFFFFFF


def encrypt_bits(gen: torch.Generator, bits, alpha: float,
                 key: torch.Tensor) -> torch.Tensor:
    """(..., nbits) bools -> (..., nbits, lwe_n+1) ciphertexts, one call."""
    return cipher.lwe_encrypt_bool(gen, bits, alpha, key)


def decrypt_bits(cts: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    return cipher.lwe_decrypt_bool(cts, key)


def encrypt_bits_messages(gen: torch.Generator, bits, alpha: float,
                          key: torch.Tensor) -> torch.Tensor:
    """Bits encrypted as modulus-8 messages, the encoding the many-LUT
    full adder consumes (models/adders.full_adder_manylut: the sum phase
    (a+b+cin)/16 stays in the first torus half).  (..., nbits) ints/bools
    -> (..., nbits, lwe_n+1)."""
    return cipher.lwe_encrypt_message(gen, np.asarray(bits, np.int64), 8,
                                      alpha, key)


def decrypt_bits_messages(cts: torch.Tensor, key: torch.Tensor
                          ) -> torch.Tensor:
    """Inverse of :func:`encrypt_bits_messages`: boolean bits (message & 1
    guards against a carried-in 2 from adder outputs)."""
    return (cipher.lwe_decrypt_message(cts, 8, key) & 1) > 0
