"""Boolean gate API, batched natively (port of ``go_tfhe_tpu/gates.py:23-90``).

Every gate takes ciphertexts with arbitrary leading batch axes.
Gate = affine preparation + bootstrap (gates/gates.go:26-114).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import engine, lut
from .keys import CloudKey
from .params import TFHEParams
from .utils.torus import from_numpy_u32, to_numpy_u32


def NAND(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_nand(a, b))


def AND(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_and(a, b))


def OR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_or(a, b))


def XOR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_xor(a, b))


def XNOR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_xnor(a, b))


def NOR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_nor(a, b))


def ANDNY(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NOT(a) AND b."""
    return engine.bootstrap(ck, engine.prepare_andny(a, b))


def ANDYN(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a AND NOT(b)."""
    return engine.bootstrap(ck, engine.prepare_andyn(a, b))


def ORNY(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NOT(a) OR b."""
    return engine.bootstrap(ck, engine.prepare_orny(a, b))


def ORYN(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a OR NOT(b)."""
    return engine.bootstrap(ck, engine.prepare_oryn(a, b))


@functools.lru_cache(maxsize=None)
def _and_or_table(p: TFHEParams) -> np.ndarray:
    """AND_OR's multi-LUT, built once per profile (host uint32 words)."""
    gen = lut.Generator(p, 8, device="cpu")
    out_enc = lut.Encoder(8, 1.0 / 8)          # 1 -> +1/8, 7 -> -1/8
    return to_numpy_u32(gen.gen_multi_lut(
        [lambda x: 1 if x == 4 else 7,         # AND: only t = +1/4
         lambda x: 1 if x in (0, 4) else 7],   # OR: t = 0 or +1/4
        theta=1, encoders=[out_enc, out_enc]))


def and_or_lut(p: TFHEParams, device) -> torch.Tensor:
    """The (2, N) multi-LUT of :func:`AND_OR` on ``device``."""
    return from_numpy_u32(_and_or_table(p), device)


def AND_OR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(a AND b, a OR b) from ONE bootstrap via multi-LUT extraction
    (engine.bootstrap_many, theta = 1).

    Both gates are sign-threshold functions of the same phase t = a + b in
    {-1/4, 0, +1/4}; on the modulus-8 message grid t lands on message
    centers 0 / 4 / "virtual 12", whose readout is the negated message-4
    entry, the False encoding both need there.  Outputs are standard
    +-1/8 booleans."""
    out = engine.bootstrap_many(ck, a + b, and_or_lut(ck.params, a.device),
                                k=2, theta=1)
    return out[0], out[1]
