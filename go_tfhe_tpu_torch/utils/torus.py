"""Torus words as ``torch.int32`` (port of ``go_tfhe_tpu/utils/torus.py``).

The torus T = R/Z is discretized to 32 bits and all arithmetic wraps mod
2^32.  The JAX package carries words as ``uint32``; this port carries the
same bits as ``int32``, whose add, subtract and multiply wrap identically in
two's complement.  Only three operations see the difference:

* right shifts are arithmetic, so a logical shift is
  ``(x >> s) & ((1 << (32 - s)) - 1)`` (:func:`shr`);
* comparisons are signed (the decrypt sign test ``to_signed(phase) >= 0``
  becomes ``phase >= 0``);
* Python constants >= 2^31 must be brought into int32 range (:func:`i32`).

numpy ``uint32`` arrays cross over with ``.view(np.int32)``
(:func:`from_numpy_u32`, :func:`to_numpy_u32`).
"""

from __future__ import annotations

import numpy as np
import torch

TORUS = torch.int32
MOD32 = 1 << 32


# ---------------------------------------------------------------------------
# Host-side (exact, float64) — matches Go bit-for-bit.
# ---------------------------------------------------------------------------

def f64_to_torus(d) -> np.uint32:
    """utils/utils.go:11-14: Torus(int64(math.Mod(d, 1.0) * 2^32))."""
    d = np.asarray(d, dtype=np.float64)
    t = np.fmod(d, 1.0) * float(MOD32)
    return (np.trunc(t).astype(np.int64)).astype(np.uint32)


def torus_to_f64(t) -> np.float64:
    """utils/utils.go:17-19: float64(t) / 2^32, in [0, 1)."""
    return np.asarray(t, dtype=np.uint64).astype(np.float64) / float(MOD32)


def f64_to_torus_vec(d) -> np.ndarray:
    """utils/utils.go:22-28."""
    return f64_to_torus(np.asarray(d, dtype=np.float64))


# ---------------------------------------------------------------------------
# int32 words.
# ---------------------------------------------------------------------------

def i32(v: int) -> int:
    """A Python integer mod 2^32 as the int32 value with the same bits."""
    v %= MOD32
    return v - MOD32 if v >= 1 << 31 else v


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words by a static 0 <= s < 32."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 integers -> int32 words congruent mod 2^32."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(TORUS)


def to_signed(x: torch.Tensor) -> torch.Tensor:
    """Bit-preserving uint32 -> int32 view: the identity on int32 words,
    kept so that ported code reads like the JAX package."""
    return x


def to_unsigned(x: torch.Tensor) -> torch.Tensor:
    """Bit-preserving int32 -> uint32 view: the identity on int32 words."""
    return x


def torus_not(x: torch.Tensor) -> torch.Tensor:
    """The reference's cheap negation ``^Torus(0) - a`` == bitwise NOT ==
    -a-1 (mod 2^32); NOT the exact negation -a."""
    return ~x


def from_numpy_u32(a, device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor with the same bits on ``device``."""
    a = np.asarray(a, dtype=np.uint32)
    words = np.ascontiguousarray(a).view(np.int32).reshape(a.shape)
    return torch.from_numpy(words.copy()).to(device)


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array with the same bits."""
    return x.detach().cpu().contiguous().numpy().view(np.uint32)
