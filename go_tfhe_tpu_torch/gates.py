"""Boolean gate API, batched natively (port of ``go_tfhe_tpu/gates.py``).

Every gate takes ciphertexts with arbitrary leading batch axes.
Gate = affine preparation + bootstrap (gates/gates.go:26-114).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import engine, lut
from .cipher import BOOL_TRUE_MU
from .keys import CloudKey
from .ops.keyswitch import identity_key_switch
from .params import TFHEParams
from .utils.torus import TORUS, f64_to_torus, from_numpy_u32, i32, to_numpy_u32
from .utils.tracing import span


def _entry(gate):
    """The gate inside the span ``entry.gate`` (utils/tracing.py), with
    the gate's name and batch, on the device of its last ciphertext."""
    name = gate.__name__

    @functools.wraps(gate)
    def traced(*args, **kwargs):
        ct = next(x for x in reversed((*args, *kwargs.values()))
                  if isinstance(x, torch.Tensor))
        with span("entry.gate", ct.device, gate=name,
                  batch=ct.numel() // ct.shape[-1]):
            return gate(*args, **kwargs)
    return traced


@_entry
def NAND(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_nand(a, b))


@_entry
def AND(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_and(a, b))


@_entry
def OR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_or(a, b))


@_entry
def XOR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_xor(a, b))


@_entry
def XNOR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_xnor(a, b))


@_entry
def NOR(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_nor(a, b))


@_entry
def ANDNY(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NOT(a) AND b."""
    return engine.bootstrap(ck, engine.prepare_andny(a, b))


@_entry
def ANDYN(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a AND NOT(b)."""
    return engine.bootstrap(ck, engine.prepare_andyn(a, b))


@_entry
def ORNY(ck: CloudKey, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NOT(a) OR b."""
    return engine.bootstrap(ck, engine.prepare_orny(a, b))


@_entry
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


@_entry
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


@_entry
def NOT(a: torch.Tensor) -> torch.Tensor:
    """Negation, no bootstrap (gates/gates.go:117-119)."""
    return -a


def COPY(a: torch.Tensor) -> torch.Tensor:
    """gates/gates.go:122-126."""
    return a.clone()


@_entry
def MUX(ck: CloudKey, sel: torch.Tensor, then_ct: torch.Tensor,
        else_ct: torch.Tensor) -> torch.Tensor:
    """sel ? then : else in two bootstraps and one key switch
    (``go_tfhe_tpu/gates.py:103-124``; the reference composes three full
    gates, gates/gates.go:107-114).

    The branches u1 = sel AND then, u2 = NOT(sel) AND else are disjoint,
    so their OR is exact linear algebra: u1 + u2 + 1/8 maps {one true: 0,
    none: -1/4} to +-1/8.  Both branch bootstraps skip the key switch;
    the level-1 sum gets one.  Its noise is sqrt(2) times one
    bootstrap's."""
    u1 = engine.bootstrap_without_key_switch(
        ck, engine.prepare_and(sel, then_ct))
    u2 = engine.bootstrap_without_key_switch(
        ck, engine.prepare_andny(sel, else_ct))
    summed = u1 + u2
    summed[..., -1] += BOOL_TRUE_MU                # T(1/8)
    return identity_key_switch(ck.params, ck.ksk, summed)


def MUX_3GATE(ck: CloudKey, sel: torch.Tensor, then_ct: torch.Tensor,
              else_ct: torch.Tensor) -> torch.Tensor:
    """The reference's 3-gate MUX composition (gates/gates.go:107-114)."""
    and_ab = AND(ck, sel, then_ct)
    and_nac = AND(ck, NOT(sel), else_ct)
    return OR(ck, and_ab, and_nac)


def constant(p: TFHEParams, value, batch_shape=(), device="cuda"
             ) -> torch.Tensor:
    """Trivial (noiseless) ciphertext of a constant boolean on ``device``
    (gates/gates.go:61-69: mu = T(1/8) if true else 1 - T(1/8))."""
    t = int(f64_to_torus(0.125))
    value = torch.broadcast_to(
        torch.as_tensor(value, dtype=torch.bool, device=device),
        tuple(batch_shape))
    mu = torch.where(value, i32(t), i32(1 - t)).to(TORUS)
    ct = torch.zeros(tuple(value.shape) + (p.lwe_n + 1,), dtype=TORUS,
                     device=device)
    ct[..., p.lwe_n] = mu
    return ct
