"""Look-up tables and programmable bootstrapping (PBS) (port of
``go_tfhe_tpu/lut.py``).

A look-up table is a trivial TRLWE ciphertext (A = 0) whose B polynomial
encodes the function (lut/lut.go:14-17, lut/generator.go:94-99); the PBS is
the bootstrap engine with the table as its test vector
(evaluator/programmable_bootstrap.go:93-115).  Table building is host-side
numpy, float64-exact like the Go code and the JAX package; a
:class:`Generator` returns int32 words on the device it was given, the
card unless it was given ``device="cpu"``.

Tables are (2, N) for plain profiles and (k, 2, N) for extended ones
(poly_extend_factor k > 1): the size-kN table interleaved into k blocks.
A batch of tables, (..., 2, N) or (..., k, 2, N), applies one table per
ciphertext in one call.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from . import engine
from .keys import CloudKey
from .params import TFHEParams
from .utils.torus import f64_to_torus, from_numpy_u32, torus_to_f64


def _div_round(a: int, b: int) -> int:
    """lut/generator.go:171-173."""
    return (a + b // 2) // b


class Encoder:
    """Message-space encoder (lut/encoder.go:9-37): scale = 1/(2m)."""

    def __init__(self, message_modulus: int, scale: float | None = None):
        self.message_modulus = message_modulus
        self.scale = (1.0 / (2 * message_modulus)) if scale is None else scale

    def encode(self, message: int) -> np.uint32:
        """message -> T(message * scale)  (lut/encoder.go:47-75)."""
        message = message % self.message_modulus
        return f64_to_torus(float(message) * self.scale)

    def encode_with_custom_scale(self, message: int, scale: float
                                 ) -> np.uint32:
        message = message % self.message_modulus
        return f64_to_torus(float(message) * scale)

    def decode(self, value) -> int:
        """lut/encoder.go:88-102: round(f/scale) to the nearest message."""
        f = float(torus_to_f64(np.uint32(value)))
        return int(f / self.scale + 0.5) % self.message_modulus

    def decode_bool(self, value) -> bool:
        return self.decode(value) != 0


class Generator:
    """Look-up table generator (lut/generator.go:10-28), with extended
    tables when ``poly_extend_factor > 1`` (the size-kN table interleaved
    into k trivial TRLWE blocks, big[j] -> block[j % k][j // k], the layout
    of ops/rotate.monomial_mul_blocks)."""

    def __init__(self, p: TFHEParams, message_modulus: int | None = None,
                 scale: float | None = None, device="cuda"):
        m = p.message_modulus if message_modulus is None else message_modulus
        self.params = p
        self.encoder = Encoder(m, scale)
        self.poly_degree = p.n
        self.extend_factor = p.poly_extend_factor
        self.lut_size = p.lut_size
        self.device = device

    # -- core table construction (lut/generator.go:56-100) ------------------

    def _build_np(self, values_torus: np.ndarray) -> np.ndarray:
        """values_torus: per-message torus encodings, shape (m,).  Returns
        the uint32 table, (2, N) or (k, 2, N)."""
        m = len(values_torus)
        size = self.lut_size
        raw = np.zeros((size,), np.uint32)
        for x in range(m):
            start = _div_round(x * size, m)
            end = _div_round((x + 1) * size, m)
            raw[start:end] = values_torus[x]
        offset = _div_round(size, 2 * m)
        rotated = np.roll(raw, -offset)          # rotated[i] = raw[i+offset]
        rotated[size - offset:] = (-rotated[size - offset:].astype(np.int64)
                                   ).astype(np.uint32)
        k = self.extend_factor
        if k == 1:
            lut = np.zeros((2, size), np.uint32)
            lut[1] = rotated
        else:
            lut = np.zeros((k, 2, self.poly_degree), np.uint32)
            lut[:, 1, :] = rotated.reshape(self.poly_degree, k).T
        return lut

    def _build(self, values_torus: np.ndarray) -> torch.Tensor:
        return from_numpy_u32(self._build_np(values_torus), self.device)

    def gen_lut(self, f: Callable[[int], int]) -> torch.Tensor:
        """f: message -> message; returns the trivial TRLWE table."""
        vals = np.asarray([self.encoder.encode(f(x))
                           for x in range(self.encoder.message_modulus)],
                          np.uint32)
        return self._build(vals)

    def gen_lut_full(self, f: Callable[[int], int]) -> torch.Tensor:
        """f: message -> raw torus value (lut/generator.go:102-141)."""
        vals = np.asarray([np.uint32(f(x))
                           for x in range(self.encoder.message_modulus)],
                          np.uint32)
        return self._build(vals)

    def gen_lut_custom(self, f: Callable[[int], int], message_modulus: int,
                       scale: float) -> torch.Tensor:
        """lut/generator.go:143-155; a local Encoder, so a shared Generator
        stays reentrant."""
        enc = Encoder(message_modulus, scale)
        vals = np.asarray([enc.encode(f(x)) for x in range(message_modulus)],
                          np.uint32)
        return self._build(vals)

    def gen_multi_lut(self, fns, theta: int, encoders=None) -> torch.Tensor:
        """Interleaved multi-function table for engine.bootstrap_many: one
        2^theta-coarse blind rotation evaluates up to 2^theta functions,
        read out by sample extraction at indices 0..len(fns)-1
        (``go_tfhe_tpu/lut.py:134-188``: table[s*2^theta + t] =
        table_t[s*2^theta], each f_t's table built as a single LUT).

        fns: k <= 2^theta functions message -> message; ``encoders``: an
        optional Encoder per function (default ``self.encoder``).
        Returns a (2, N) trivial TRLWE test vector."""
        k = len(fns)
        if not 1 <= k <= 1 << theta:
            raise ValueError(f"{k} functions need 1 <= k <= 2^{theta}")
        if self.extend_factor != 1:
            raise ValueError("many-LUT is not supported on extended (k*N) "
                             "profiles")
        n = self.poly_degree
        m = self.encoder.message_modulus
        offset = _div_round(n, 2 * m)
        if offset % (1 << theta):
            raise ValueError(
                f"half-segment rotation {offset} not 2^{theta}-aligned; "
                f"need (N/(2m)) % 2^theta == 0")
        encs = [self.encoder] * k if encoders is None else list(encoders)
        if len(encs) != k:
            raise ValueError(f"{len(encs)} encoders for {k} functions")
        tables = []
        for f, enc in zip(fns, encs):
            vals = np.asarray([enc.encode(f(x)) for x in range(m)],
                              np.uint32)
            tables.append(self._build_np(vals)[1])             # B row (n,)
        idx = np.arange(n)
        base = (idx >> theta) << theta
        res = idx & ((1 << theta) - 1)
        raw = np.zeros((n,), np.uint32)
        for t in range(1 << theta):
            src = tables[min(t, k - 1)]
            sel = res == t
            raw[sel] = src[base[sel]]
        lut = np.zeros((2, n), np.uint32)
        lut[1] = raw
        return from_numpy_u32(lut, self.device)

    def mod_switch(self, x) -> int:
        """Torus -> [0, lut_size) with rounding (lut/generator.go:157-168).
        Go's math.Round rounds half away from zero (x >= 0 here, so
        floor(x+0.5)); Python's round() would round exact halves to even."""
        scaled = float(np.uint32(x)) / float(1 << 32) * self.lut_size
        return int(math.floor(scaled + 0.5)) % self.lut_size


# ---------------------------------------------------------------------------
# Programmable bootstrapping.
# ---------------------------------------------------------------------------

def bootstrap_lut(ck: CloudKey, ct: torch.Tensor, lut: torch.Tensor
                  ) -> torch.Tensor:
    """PBS with a precomputed table (evaluator/programmable_bootstrap.go:
    50-115).  lut: (2, N) / (k, 2, N) shared, or one per ciphertext."""
    return engine.bootstrap(ck, ct, testvec=lut)


def bootstrap_func(ck: CloudKey, ct: torch.Tensor, f: Callable[[int], int],
                   message_modulus: int) -> torch.Tensor:
    """PBS evaluating f on the message space
    (evaluator/programmable_bootstrap.go:16-30); the table is built on the
    ciphertexts' device."""
    gen = Generator(ck.params, message_modulus, device=ct.device)
    return bootstrap_lut(ck, ct, gen.gen_lut(f))
