"""Identity key switching: TLWE level 1 (dim N) -> level 0 (dim n_lwe)
(port of ``go_tfhe_tpu/ops/keyswitch.py``), and the digit-table
contraction it shares with proxy re-encryption (``proxyreenc.reencrypt``).

    out = [0,...,0, b]  -  sum_{i,j} KSK[i, j, digit(i,j)]
        = [0,...,0, b]  -  onehot(digits) . KSK            (mod 2^32)

On a card :func:`digit_table_switch` launches ``csrc/keyswitch.cu``, one
hand-written gather-and-sum over the int32 table: each ciphertext's digits
made in registers, the n*t rows they pick summed in wrapping u32 adds,
nothing of the table converted (:func:`switch_kernel`).  Off a card, or
where the kernel's own rule refuses the shape (:func:`takes_kernel`), it
runs the plain version :func:`digit_table_switch_ref`; both give the same
words.  ``utils.tracing.key_switch_counts`` counts every call, and
``launch_counts["key_switch"]`` the kernel's launches.

The plain version: torch has no integer matmul on CUDA, and a bf16 GEMM
may reduce in reduced precision, so it takes the float32 form: a float32
one-hot against the table split into four balanced int8 limbs
(float32-exact), folded into the output columns, multiplied with TF32 off
(polymul.exact_f32_matmul).  Each output is a sum of at most n*t nonzero
terms of magnitude <= 128, so every partial sum is an integer below 2^24
and exact; the limbs recombine mod 2^32.  The batch is processed in chunks
of ``_CHUNK`` rows to bound the one-hot's memory.

Digits (trgsw/keyswitch.go:26-29):
    aBar       = a[i] + 2^(32-(1+basebit*t))
    digit(i,j) = (aBar >> (32-(j+1)*basebit)) & (base-1)
Table[..., 0, :] rows are zero (keygen), so the unconditional contraction
equals the reference's skip of digit 0; both forms sum the digit-0 rows
too, so they agree on any table.
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS, i32
from ..utils.tracing import key_switch_counts, note_peak, span
from . import _build
from .cuda_t import _check, launch
from .polymul import exact_f32_matmul, split_balanced_limbs_i8

_KS_LIMBS = 4
_CHUNK = 4096


def _digits(a: torch.Tensor, basebit: int, t: int) -> torch.Tensor:
    """a: (..., n) int32 words -> (..., n, t) int32 digits in
    [0, 2^basebit).  The arithmetic shift is exact under the mask: it keeps
    (j+1)*basebit >= basebit low bits."""
    a_bar = a + i32(1 << (32 - (1 + basebit * t)))
    d = [(a_bar >> (32 - (j + 1) * basebit)) & ((1 << basebit) - 1)
         for j in range(t)]
    return torch.stack(d, dim=-1)


def ks_digits(p: TFHEParams, a: torch.Tensor) -> torch.Tensor:
    """a: (..., N) int32 words -> (..., N, t) int32 digits in [0, base)."""
    return _digits(a, p.basebit, p.iks_t)


def digit_table_switch(table: torch.Tensor, ct: torch.Tensor, basebit: int,
                       t: int, plain: bool = False) -> torch.Tensor:
    """The digit-table contraction: table (n, t, 2^basebit, w) int32
    words, ct (..., n+1) -> (..., w), out = -sum_{i,j} table[i, j,
    digit(i,j)] with out[..., w-1] += ct's body.  ``identity_key_switch``
    (the KSK, n = N, w = lwe_n + 1) and ``proxyreenc.reencrypt`` (a
    re-encryption key, n = w - 1) both run it.  The kernel where
    :func:`takes_kernel` says so, else (and with ``plain``) the plain
    version; every call adds one to ``key_switch_counts["switches"]``, a
    kernel launch one to ``launch_counts["key_switch"]``."""
    key_switch_counts["switches"] += 1
    if not plain and takes_kernel(table, ct, basebit, t):
        return switch_kernel(table, ct, basebit, t)
    return digit_table_switch_ref(table, ct, basebit, t)


def takes_kernel(table: torch.Tensor, ct: torch.Tensor, basebit: int,
                 t: int) -> bool:
    """Whether a call takes the kernel: ciphertexts on a card, of n+1
    words, and a shape that the kernel's own rule takes
    (:func:`kernel_fits`)."""
    n, w = table.shape[0], table.shape[-1]
    if ct.device.type != "cuda" or ct.shape[-1] != n + 1:
        return False
    return kernel_fits(ct.device, n, t, basebit, w, ct.numel() // (n + 1))


# (card index, n, t, basebit, w, B) -> whether the kernel takes the shape.
_fits: dict = {}


def kernel_fits(device: torch.device, n: int, t: int, basebit: int, w: int,
                b: int) -> bool:
    """The kernel's own rule (``tfhe_key_switch_fits``: basebit 1-8 with
    basebit*t <= 31, w at most 2048, B >= 1, its grid and shared memory
    within the card's), asked once for each shape.  Raises where the card
    could not be asked (a failed CUDA query is a failed kernel, not a
    refused shape), and keeps no answer then."""
    key = (device.index, n, t, basebit, w, b)
    if key not in _fits:
        with torch.cuda.device(device):
            rc = _build.load_library().tfhe_key_switch_fits(n, t, basebit, w,
                                                            b)
        if rc < 0:
            raise RuntimeError(f"key_switch: the card's query failed: CUDA "
                               f"error {-rc}")
        _fits[key] = bool(rc)
    return _fits[key]


def switch_kernel(table: torch.Tensor, ct: torch.Tensor, basebit: int,
                  t: int) -> torch.Tensor:
    """One launch of the gather-and-sum kernel (``csrc/keyswitch.cu``) on
    CUDA tensors, of a shape that :func:`kernel_fits` takes: the plain
    version's words in a new (..., w) tensor, counted under
    ``launch_counts["key_switch"]``; the output is the tensor it holds
    beside its inputs (``key_switch.transient_bytes``)."""
    n, w = table.shape[0], table.shape[-1]
    lead = ct.shape[:-1]
    flat = ct.reshape(-1, n + 1).contiguous()
    b, dev = flat.shape[0], ct.device
    _check("table", table, TORUS, (n, t, 1 << basebit, w), dev)
    _check("ct", flat, TORUS, (b, n + 1), dev)
    out = torch.empty((b, w), dtype=TORUS, device=dev)
    with span("key_switch.gather", dev):
        launch("key_switch", "tfhe_key_switch", dev, table.data_ptr(),
               flat.data_ptr(), out.data_ptr(), n, t, basebit, w, b)
    note_peak("key_switch.transient_bytes", out.numel() * out.element_size())
    return out.reshape(lead + (w,))


def digit_table_switch_ref(table: torch.Tensor, ct: torch.Tensor,
                           basebit: int, t: int) -> torch.Tensor:
    """Plain :func:`digit_table_switch`: the float32 one-hot product
    against the table's float32 limb form (the module docstring)."""
    n, w = table.shape[0], table.shape[-1]
    base = 1 << basebit
    rows = n * t * base
    lead = ct.shape[:-1]
    flat = ct.reshape(-1, n + 1)
    with span("key_switch.limb_form", ct.device):
        limbs = split_balanced_limbs_i8(table.reshape(rows, w), _KS_LIMBS)
        table_f = torch.cat([limbs[i] for i in range(_KS_LIMBS)],
                            dim=-1).to(torch.float32)  # (rows, 4w)
    ar = torch.arange(base, device=ct.device, dtype=TORUS)
    outs, transient = [], 0
    with span("key_switch.contract", ct.device):
        for s in range(0, flat.shape[0], _CHUNK):
            part = flat[s:s + _CHUNK]
            digits = _digits(part[:, :n], basebit, t)  # (b, n, t)
            onehot = (digits[..., None] == ar).to(torch.float32)
            with exact_f32_matmul():
                acc = (onehot.reshape(-1, rows) @ table_f).to(TORUS)
            # the product's float32 output had acc's bytes
            transient = max(transient, sum(
                x.numel() * x.element_size()
                for x in (limbs, table_f, digits, onehot, acc)))
            tot = acc[:, :w]
            for i in range(1, _KS_LIMBS):
                tot = tot + (acc[:, i * w:(i + 1) * w] << (8 * i))
            out = -tot
            out[:, w - 1] += part[:, n]
            outs.append(out)
    note_peak("key_switch.transient_bytes", transient)
    return torch.cat(outs, dim=0).reshape(lead + (w,))


def identity_key_switch(p: TFHEParams, ksk: torch.Tensor,
                        ct_lv1: torch.Tensor, plain: bool = False
                        ) -> torch.Tensor:
    """ksk: (N, t, base, n_lwe+1) int32 words;  ct_lv1: (..., N+1).

    Returns (..., n_lwe+1) level-0 ciphertexts; ``plain`` runs the plain
    version on any device."""
    with span("key_switch", ct_lv1.device):
        return digit_table_switch(ksk, ct_lv1, p.basebit, p.iks_t, plain)
