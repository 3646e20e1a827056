"""The bootstrap engine (port of ``go_tfhe_tpu/engine.py:43-50, 77-93,
106-156, 168-321, 337-389``).

One code path serves both devices: blind rotation (ops/blindrotate.py)
-> sample extraction -> identity key switch, as the JAX package's
``_bootstrap_core_t``.  The step kernels inside the blind rotation run
their plain versions on CPU tensors and the Hopper kernels on CUDA tensors.
The kernels mask a ragged batch themselves, so no batch padding is needed.

Routing (:func:`_route`) follows the JAX package's TPU dispatch
(``_tpu_core_choice``), so each (profile, key) reaches the counterpart of
the TPU kernel the JAX package reaches there.  A key's ``transposed`` flag
(keys.CloudKey) stands for the JAX key's reversed band: True (the default)
where the JAX key carries it, False where it carries only the row-major
band.  In the dispatch's order:

* extended profiles that pass ``ext_t_fits`` (uint6, uint7 and their
  centered variants, the toy ``test_ext2/3``) with a transposed key:
  ``blind_rotate_extended_t``, K4 + K5, as ``_bootstrap_core_ext_t``;
* other extended profiles and keys (uint8 and uint8_centered, k = 9):
  ``blind_rotate_extended_rm``, K6 + K8, as ``_bootstrap_core_ext_tpu``;
* block-binary keys on a profile with block_size > 1 whose N the TPU
  kernels do not tile (N % 256 != 0, ``_use_tpu_path``), whatever the
  flags: ``blind_rotate_block``, K7 + K8, as the portable
  ``_bootstrap_core_block`` that the JAX dispatch takes there (the two are
  bit-exact);
* block-binary keys on a profile with block_size > 1 and single-limb
  digits, when :data:`PREFER_BLOCK_ROTATION` is set or the key is not
  transposed: ``blind_rotate_block``, K7 + K8, as
  ``_bootstrap_core_block_tpu``;
* transposed keys on single-limb-digit profiles when :data:`PREFER_PIPE`
  is set: ``blind_rotate_pipe``, K1 + K9 (ops/cuda_pipe.py), as
  ``_bootstrap_core_pipe``;
* other transposed keys (the default for block-binary keys too):
  ``blind_rotate_t``, K1 + K2, as ``_bootstrap_core_t``;
* other keys: ``blind_rotate_tpu``, K7 + K8 per bit, or K3 with
  ``blindrotate.FUSED_STEP``, as ``_bootstrap_core_tpu``.

``bootstrap_many`` runs ``blind_rotate_t`` for every key, as the JAX
package does for transposed keys (for the others it runs the portable
many-LUT core, whose values are the same).  (On its CPU backend the JAX
package always runs block-binary keys through the portable block
rotation; the port follows the TPU's choice on every device.)

The JAX package's portable cores are named routes that :func:`_route`
never picks: ``engine._bootstrap(ck, ct, tv, key_switch, plain, route=...)``
with ``route`` "blind_rotate" (``_bootstrap_core``),
"blind_rotate_extended" (``_bootstrap_core_ext``) or
"blind_rotate_block_portable" (``_bootstrap_core_block``), and
``bootstrap_many(..., route="blind_rotate")`` (``_bootstrap_core_many``).
They read the D bands that keys.prepare_bootstrap_kernels builds from
``ck.bsk`` on each call, launch no kernel, and run the same form on every
device (``plain`` does not apply to them).
"""

from __future__ import annotations

import warnings

import torch

from .keys import CloudKey, prepare_bootstrap_kernels
from .ops.blindrotate import (blind_rotate, blind_rotate_block,
                              blind_rotate_block_portable,
                              blind_rotate_extended, blind_rotate_extended_rm,
                              blind_rotate_extended_t, blind_rotate_t,
                              blind_rotate_tpu)
from .ops.cuda_ext_t import ext_t_fits
from .ops.cuda_pipe import blind_rotate_pipe
from .ops.keyswitch import identity_key_switch
from .ops.sample_extract import sample_extract
from .utils.torus import f64_to_torus, i32
from .utils.tracing import count, span

# Affine-preparation bias constants (evaluator/gates_helper.go, gates/gates.go).
_T_EIGHTH = i32(int(f64_to_torus(0.125)))
_T_NEG_EIGHTH = i32(int(f64_to_torus(-0.125)))
_T_QUARTER = i32(int(f64_to_torus(0.25)))


# Route block-binary keys through the block blind rotation (K7 + K8)
# instead of the per-bit path (K1 + K2).  Off by default, as in the JAX
# package (go_tfhe_tpu/engine.py:43-50), whose reason is a TPU measurement:
# there the per-bit transposed path beat the block kernel (8,205 vs 7,886
# gates/s at 128bit_fast), the block kernel's launch-count advantage no
# longer paying for its costlier rotation.  On an H100 at 700 W it is the
# other way round since both products run on the s8 tensor cores: the
# block path takes a third of the steps and its K8 needs no digit
# transposition (11,573 vs 6,903 gates/s on the same block-binary keys,
# batch 4096; PERF.md).  The default stays the JAX package's; set this
# True to take the block path.
PREFER_BLOCK_ROTATION = False

# Route transposed keys on single-limb-digit profiles through the
# half-batch pipelined rotation (K1 + K9) instead of K1 + K2.  Off by
# default, as in the JAX package (go_tfhe_tpu/engine.py:52-62), whose
# reason is a TPU measurement: Mosaic did not overlap the two halves'
# rotation and contraction.  The H100's numbers are in PERF.md.
PREFER_PIPE = False


_ROTATIONS = {f.__name__: f for f in (blind_rotate_t, blind_rotate_block,
                                      blind_rotate_extended_t,
                                      blind_rotate_extended_rm,
                                      blind_rotate_tpu, blind_rotate_pipe)}
# The portable rotations (the JAX package's off-TPU cores), on D bands.
_PORTABLE = {f.__name__: f for f in (blind_rotate, blind_rotate_extended,
                                     blind_rotate_block_portable)}


def _route(ck: CloudKey) -> str:
    """The blind rotation that ``bootstrap`` runs for this key: the name of
    a function of ops/blindrotate.py or ops/cuda_pipe.py (see the module
    docstring)."""
    p = ck.params
    if p.poly_extend_factor > 1:
        return ("blind_rotate_extended_t" if ck.transposed and ext_t_fits(p)
                else "blind_rotate_extended_rm")
    # At an N that the TPU kernels do not tile (_use_tpu_path) the JAX
    # dispatch runs its portable block rotation, whatever the flags.
    if ck.block_binary and p.block_size > 1 and (
            p.n % 256 or (p.digit_limbs == 1 and (PREFER_BLOCK_ROTATION
                                                  or not ck.transposed))):
        return "blind_rotate_block"
    if not ck.transposed:
        return "blind_rotate_tpu"
    if PREFER_PIPE and p.digit_limbs == 1:
        return "blind_rotate_pipe"
    return "blind_rotate_t"


def _bootstrap(ck: CloudKey, ct: torch.Tensor, testvec, key_switch: bool,
               plain: bool, route: str | None = None) -> torch.Tensor:
    """The bootstrap through the blind rotation ``route`` (a name of
    :data:`_ROTATIONS` or :data:`_PORTABLE`; :func:`_route`'s by
    default)."""
    p = ck.params
    k = p.poly_extend_factor
    tv = ck.testvec if testvec is None else testvec
    # tv is (2, N) shared / (..., 2, N) per-ct for plain profiles,
    # (k, 2, N) / (..., k, 2, N) for extended ones.
    tv_shape = (2, p.n) if k == 1 else (k, 2, p.n)
    lead = ct.shape[:-1]
    ct2 = ct.reshape(-1, ct.shape[-1])
    if tv.dim() > len(tv_shape):
        tv = tv.reshape((-1,) + tv_shape)
    route = route or _route(ck)
    dev = ct.device
    with span("engine.bootstrap", dev, route=route, batch=ct2.shape[0],
              key_switch=key_switch):
        with span("engine.rotation", dev):
            if route in _PORTABLE:
                rotated = _PORTABLE[route](
                    p, prepare_bootstrap_kernels(ck.bsk, p), ct2, tv)
            else:
                rotated = _ROTATIONS[route](p, ck.bands, ct2, tv,
                                            plain=plain)
            count("rotation.steps", p.lwe_n)
        if k > 1:                           # big-poly coefficient 0
            rotated = rotated[:, 0]
        with span("engine.sample_extract", dev):
            lv1 = sample_extract(rotated, 0)
        out = identity_key_switch(p, ck.ksk, lv1) if key_switch else lv1
    return out.reshape(lead + out.shape[-1:])


def bootstrap(ck: CloudKey, ct: torch.Tensor, testvec=None,
              plain: bool = False) -> torch.Tensor:
    """Full bootstrap: (..., lwe_n+1) -> (..., lwe_n+1)
    (evaluator/evaluator.go:139-148).  ``testvec``: the cloud key's test
    vector by default, else a look-up table, shared or per ciphertext
    (lut.Generator).  ``plain`` runs the step kernels' plain versions on
    any device."""
    return _bootstrap(ck, ct, testvec, key_switch=True, plain=plain)


def bootstrap_without_key_switch(ck: CloudKey, ct: torch.Tensor,
                                 testvec=None) -> torch.Tensor:
    """Blind rotate + sample extract only; the result is under the level-1
    key (gates/gates.go:145-149)."""
    return _bootstrap(ck, ct, testvec, key_switch=False, plain=False)


def bootstrap_many(ck: CloudKey, ct: torch.Tensor, multi_lut: torch.Tensor,
                   k: int, theta: int = 1, key_switch: bool = True,
                   plain: bool = False, route: str = "blind_rotate_t"
                   ) -> torch.Tensor:
    """k function outputs from ONE blind rotation (PBSmanyLUT,
    ``go_tfhe_tpu/engine.py:269-321``).

    The mod switch rounds to multiples of 2^theta, the test vector
    interleaves the k functions by residue (lut.Generator.gen_multi_lut),
    and sample extraction at indices 0..k-1 reads them out; the blind
    rotation, and so the kernel launches, are those of one bootstrap.

    ct: (..., lwe_n+1); multi_lut: (2, N) shared or (..., 2, N) per
    ciphertext.  Returns (k, ..., lwe_n+1): output t is f_t of the common
    phase.  The coarse mod switch multiplies its rounding noise by
    2^theta: the JAX package measured 5/1024 wrong at theta = 2 with
    messageModulus 8 at 128bit_fast (NOISE_MANY_r05.json), hence the
    warning from theta = 2 on.  ``route`` "blind_rotate" runs the portable
    rotation on D bands instead (``_bootstrap_core_many``)."""
    p = ck.params
    if p.poly_extend_factor != 1:
        raise ValueError("many-LUT needs a plain (N) profile, not "
                         f"{p.name!r}")
    if not 1 <= k <= 1 << theta:
        raise ValueError(f"k={k} functions need 1 <= k <= 2^theta "
                         f"(theta={theta})")
    if theta >= 2:
        warnings.warn(
            f"bootstrap_many with theta={theta}: the 2^theta-coarse mod "
            "switch multiplies its rounding noise; at messageModulus 8 "
            "and 128bit_fast theta = 2 measured 5/1024 wrong outputs",
            stacklevel=2)
    lead = ct.shape[:-1]
    ct2 = ct.reshape(-1, ct.shape[-1])
    tv = multi_lut.reshape(-1, 2, p.n) if multi_lut.dim() > 2 else multi_lut
    if route not in ("blind_rotate", "blind_rotate_t"):
        raise ValueError(f"bootstrap_many: no route {route!r}")
    dev = ct.device
    with span("engine.bootstrap", dev, route=route, batch=ct2.shape[0],
              key_switch=key_switch):
        with span("engine.rotation", dev):
            if route == "blind_rotate":
                rotated = blind_rotate(p, prepare_bootstrap_kernels(ck.bsk, p),
                                       ct2, tv, theta=theta)
            else:
                rotated = blind_rotate_t(p, ck.bands, ct2, tv, theta=theta,
                                         plain=plain)
            count("rotation.steps", p.lwe_n)
        with span("engine.sample_extract", dev):
            lv1 = torch.stack([sample_extract(rotated, t) for t in range(k)])
        out = identity_key_switch(p, ck.ksk, lv1) if key_switch else lv1
    return out.reshape((k,) + lead + out.shape[-1:])


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
