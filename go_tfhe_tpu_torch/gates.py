"""Boolean gate API, batched natively (port of ``go_tfhe_tpu/gates.py:23-64``).

Every gate takes ciphertexts with arbitrary leading batch axes.
Gate = affine preparation + bootstrap (gates/gates.go:26-114).
"""

from __future__ import annotations

import torch

from . import engine
from .keys import CloudKey


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
