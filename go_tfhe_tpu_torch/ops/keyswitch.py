"""Identity key switching: TLWE level 1 (dim N) -> level 0 (dim n_lwe)
(port of ``go_tfhe_tpu/ops/keyswitch.py``), and the digit-table
contraction it shares with proxy re-encryption (``proxyreenc.reencrypt``).

    out = [0,...,0, b]  -  sum_{i,j} KSK[i, j, digit(i,j)]
        = [0,...,0, b]  -  onehot(digits) . KSK            (mod 2^32)

Exactness: torch has no integer matmul on CUDA, and a bf16 GEMM may reduce
in reduced precision.  This port takes the float32 form: a float32 one-hot
against the table split into four balanced int8 limbs (float32-exact),
folded into the output columns, multiplied with TF32 off
(polymul.exact_f32_matmul).  Each output is a sum of at most n*t nonzero
terms of magnitude <= 128, so every partial sum is an integer below 2^24
and exact; the limbs recombine mod 2^32.  The batch is processed in chunks
of ``_CHUNK`` rows to bound the one-hot's memory.

Digits (trgsw/keyswitch.go:26-29):
    aBar       = a[i] + 2^(32-(1+basebit*t))
    digit(i,j) = (aBar >> (32-(j+1)*basebit)) & (base-1)
Table[..., 0, :] rows are zero (keygen), so the unconditional contraction
equals the reference's skip of digit 0.
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS, i32
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
                       t: int) -> torch.Tensor:
    """The one-hot digit contraction: table (n, t, 2^basebit, w) int32
    words, ct (..., n+1) -> (..., w), with out[..., w-1] += ct's body.
    ``identity_key_switch`` (the KSK, n = N, w = lwe_n + 1) and
    ``proxyreenc.reencrypt`` (a re-encryption key, n = w - 1) both run it."""
    n, w = table.shape[0], table.shape[-1]
    base = 1 << basebit
    rows = n * t * base
    lead = ct.shape[:-1]
    flat = ct.reshape(-1, n + 1)
    limbs = split_balanced_limbs_i8(table.reshape(rows, w), _KS_LIMBS)
    table_f = torch.cat([limbs[i] for i in range(_KS_LIMBS)],
                        dim=-1).to(torch.float32)  # (rows, 4w)
    ar = torch.arange(base, device=ct.device, dtype=TORUS)
    outs = []
    for s in range(0, flat.shape[0], _CHUNK):
        part = flat[s:s + _CHUNK]
        digits = _digits(part[:, :n], basebit, t)  # (b, n, t)
        onehot = (digits[..., None] == ar).to(torch.float32)
        with exact_f32_matmul():
            acc = (onehot.reshape(-1, rows) @ table_f).to(TORUS)
        tot = acc[:, :w]
        for i in range(1, _KS_LIMBS):
            tot = tot + (acc[:, i * w:(i + 1) * w] << (8 * i))
        out = -tot
        out[:, w - 1] += part[:, n]
        outs.append(out)
    return torch.cat(outs, dim=0).reshape(lead + (w,))


def identity_key_switch(p: TFHEParams, ksk: torch.Tensor,
                        ct_lv1: torch.Tensor) -> torch.Tensor:
    """ksk: (N, t, base, n_lwe+1) int32 words;  ct_lv1: (..., N+1).

    Returns (..., n_lwe+1) level-0 ciphertexts."""
    return digit_table_switch(ksk, ct_lv1, p.basebit, p.iks_t)
