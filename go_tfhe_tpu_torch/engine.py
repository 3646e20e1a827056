"""The bootstrap engine (port of ``go_tfhe_tpu/engine.py:126-132, 201-244,
337-389``).

One code path serves both devices: blind rotation (ops/blindrotate.py)
-> sample extraction -> identity key switch, as the JAX package's
``_bootstrap_core_t``.  The step kernels inside the blind rotation run
their plain versions on CPU tensors and the Hopper kernels on CUDA tensors.
The kernels mask a ragged batch themselves, so no batch padding is needed.

Served so far: per-bit blind rotation of plain profiles (poly_extend_factor
== 1) with uniform binary keys.  Extended look-up tables, block-binary keys
and ``bootstrap_many`` raise ``NotImplementedError`` on every device.
"""

from __future__ import annotations

import torch

from .keys import CloudKey
from .ops.blindrotate import blind_rotate_t
from .ops.keyswitch import identity_key_switch
from .ops.sample_extract import sample_extract
from .utils.torus import f64_to_torus, i32

# Affine-preparation bias constants (evaluator/gates_helper.go, gates/gates.go).
_T_EIGHTH = i32(int(f64_to_torus(0.125)))
_T_NEG_EIGHTH = i32(int(f64_to_torus(-0.125)))
_T_QUARTER = i32(int(f64_to_torus(0.25)))


def _check_served(ck: CloudKey) -> None:
    p = ck.params
    if p.poly_extend_factor > 1:
        raise NotImplementedError(
            f"profile {p.name!r}: extended look-up tables (poly_extend_factor "
            f"{p.poly_extend_factor}) are not ported yet (ROADMAP Queue 1 "
            "item 8)")
    if ck.block_binary:
        raise NotImplementedError(
            "block-binary keys and block blind rotation are not ported yet "
            "(ROADMAP Queue 1 item 9)")


def _bootstrap(ck: CloudKey, ct: torch.Tensor, testvec, key_switch: bool,
               plain: bool) -> torch.Tensor:
    _check_served(ck)
    p = ck.params
    tv = ck.testvec if testvec is None else testvec
    lead = ct.shape[:-1]
    ct2 = ct.reshape(-1, ct.shape[-1])
    if tv.dim() > 2:
        tv = tv.reshape(-1, 2, p.n)
    rotated = blind_rotate_t(p, ck.bands, ct2, tv, plain=plain)
    lv1 = sample_extract(rotated, 0)
    out = identity_key_switch(p, ck.ksk, lv1) if key_switch else lv1
    return out.reshape(lead + out.shape[-1:])


def bootstrap(ck: CloudKey, ct: torch.Tensor, testvec=None,
              plain: bool = False) -> torch.Tensor:
    """Full gate bootstrap: (..., lwe_n+1) -> (..., lwe_n+1)
    (evaluator/evaluator.go:139-148).  ``plain`` runs the step kernels'
    plain versions on any device (blindrotate.blind_rotate_t)."""
    return _bootstrap(ck, ct, testvec, key_switch=True, plain=plain)


def bootstrap_without_key_switch(ck: CloudKey, ct: torch.Tensor,
                                 testvec=None) -> torch.Tensor:
    """Blind rotate + sample extract only; the result is under the level-1
    key (gates/gates.go:145-149)."""
    return _bootstrap(ck, ct, testvec, key_switch=False, plain=False)


def bootstrap_many(ck: CloudKey, ct: torch.Tensor, multi_lut, k: int,
                   theta: int = 1, key_switch: bool = True) -> torch.Tensor:
    """PBSmanyLUT (engine.bootstrap_many in the JAX package)."""
    raise NotImplementedError(
        "bootstrap_many (multi-LUT extraction) is not ported yet "
        "(ROADMAP Queue 1 item 7)")


# ---------------------------------------------------------------------------
# Gate preparations (affine pre-bootstrap combos).
# ---------------------------------------------------------------------------

def _with_bias(x: torch.Tensor, bias: int) -> torch.Tensor:
    x = x.clone()
    x[..., -1] += bias
    return x


def prepare_nand(a, b):
    """-(a+b) + 1/8  (evaluator/gates_helper.go:10-21)."""
    return _with_bias(-(a + b), _T_EIGHTH)


def prepare_and(a, b):
    """(a+b) - 1/8  (evaluator/gates_helper.go:24-35)."""
    return _with_bias(a + b, _T_NEG_EIGHTH)


def prepare_or(a, b):
    """(a+b) + 1/8  (evaluator/gates_helper.go:38-49)."""
    return _with_bias(a + b, _T_EIGHTH)


def prepare_xor(a, b):
    """(a+2b) + 1/4  (evaluator/gates_helper.go:52-63)."""
    return _with_bias(a + b * 2, _T_QUARTER)


def prepare_xnor(a, b):
    """(a-2b) + 1/4  (gates/gates.go:52-58)."""
    return _with_bias(a - b * 2, _T_QUARTER)


def prepare_nor(a, b):
    """-(a+b) - 1/8  (gates/gates.go:72-76)."""
    return _with_bias(-(a + b), _T_NEG_EIGHTH)


def prepare_andny(a, b):
    """(-a+b) - 1/8: NOT(a) AND b  (gates/gates.go:79-83)."""
    return _with_bias(b - a, _T_NEG_EIGHTH)


def prepare_andyn(a, b):
    """(a-b) - 1/8: a AND NOT(b)  (gates/gates.go:86-90)."""
    return _with_bias(a - b, _T_NEG_EIGHTH)


def prepare_orny(a, b):
    """(-a+b) + 1/8: NOT(a) OR b  (gates/gates.go:93-97)."""
    return _with_bias(b - a, _T_EIGHTH)


def prepare_oryn(a, b):
    """(a-b) + 1/8: a OR NOT(b)  (gates/gates.go:100-104)."""
    return _with_bias(a - b, _T_EIGHTH)
