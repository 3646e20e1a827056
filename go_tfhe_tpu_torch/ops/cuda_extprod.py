"""K8: the row-major external product with the accumulator update fused
(port of ``go_tfhe_tpu/ops/pallas_extprod.py``), the second kernel of the
block blind rotation's step, of the row-major per-bit step and of the
row-major extended-LUT step (ops/blindrotate.blind_rotate_block,
blind_rotate_tpu, blind_rotate_extended_rm).

Layouts (the JAX package's, words as int32):
  digits  (B', ND*R*N) int8  — rows are ciphertexts (or ciphertext-blocks),
                               limb-major: column (i*R + r)*N + j
  band    (2, R, 2N) int32   — the port's one band layout, K2's
                               (cuda_t.pack_bsk_band_t, the ``lo`` drop
                               folded in); R = 2L, or bs*2L rows of a
                               block step (block bit, then its 2L rows)
  acc     (2, B', N)         — channel-major accumulators

:func:`extprod` launches ``csrc/extprod.cu`` (the tensor-core tile of
``csrc/extprod_tile.cuh`` with row-major digits) on CUDA tensors and runs
:func:`extprod_ref` on CPU tensors; each launch adds one to
``cuda_t.launch_counts["extprod"]``.  :func:`extprod_mm` computes K8's
function through ``torch._int_mm`` (the library form, a yardstick of speed
for the card); no path of the port calls it.
"""

from __future__ import annotations

import torch

from ..utils.torus import TORUS
from .cuda_t import (_check, check_tile, extprod_t_ref, launch,
                     toeplitz_limbs_i8)


def extprod_ref(digits: torch.Tensor, band: torch.Tensor,
                acc: torch.Tensor, nd: int = 1, lo: int = 0) -> torch.Tensor:
    """Plain K8: plain K2's exact Toeplitz contraction
    (cuda_t.extprod_t_ref) in the row-major layout.

    digits (B', ND*R*N) int8 limb-major; band (2, R, 2N) int32; acc
    (2, B', N).  Returns acc + sum_{r,j} d[b,r,j] * band[c, r, N+n-j]
    mod 2^32 with d = sum_i limb_i * 256^i: the TPU kernel's value, whose
    digit-limb x key-limb pairs of weight >= 2^32 vanish mod 2^32.  ``lo``
    (the key limbs the band was packed without, which the kernel skips)
    changes no value and is ignored."""
    return extprod_t_ref(digits.t(), band, acc.transpose(1, 2),
                         nd).transpose(1, 2).contiguous()


def extprod(digits: torch.Tensor, band: torch.Tensor, acc: torch.Tensor,
            nd: int = 1, lo: int = 0) -> torch.Tensor:
    """K8 (replaces pallas_extprod.extprod_pallas with ``acc``): see the
    ref's contract; ``lo`` must be the band's (cuda_t.band_limb_drop).
    Returns a new (2, B', N) tensor; ``acc`` is not modified."""
    if acc.device.type == "cpu":
        return extprod_ref(digits, band, acc, nd, lo)
    _, bp, n = acc.shape
    rows = band.shape[1]
    check_tile("extprod", n, rows, lo)
    _check("acc", acc, TORUS, (2, bp, n), acc.device)
    _check("band", band, TORUS, (2, rows, 2 * n), acc.device)
    _check("digits", digits, torch.int8, (bp, nd * rows * n), acc.device)
    if digits.data_ptr() % 16:
        raise ValueError("extprod: digits must be 16-byte aligned")
    out = torch.empty_like(acc)
    launch("extprod", "tfhe_extprod", acc.device, digits.data_ptr(),
           band.data_ptr(), acc.data_ptr(), out.data_ptr(), n, bp, rows, nd,
           lo)
    return out


def key_columns_i8(band: torch.Tensor, lo: int = 0, nd: int = 1) -> list:
    """K8's key operands for :func:`extprod_mm`: for each digit limb i, the
    Toeplitz limbs lo <= l < 4 - i of both channels
    (cuda_t.toeplitz_limbs_i8) as one (R*N, (4-lo-i)*2N) int8 matrix, row
    (r, j), column (l, c, n); empty when every pair of limb i vanishes."""
    key = toeplitz_limbs_i8(band, lo)                  # (4-lo, 2N, R*N)
    return [key[:4 - lo - i].flatten(0, 1).t().contiguous()
            for i in range(nd) if 4 - lo - i > 0]


def extprod_mm(digits: torch.Tensor, band: torch.Tensor, acc: torch.Tensor,
               nd: int = 1, lo: int = 0, key: list | None = None
               ) -> torch.Tensor:
    """K8's function through ``torch._int_mm`` (s8 x s8 -> s32), on any
    device; the contract of :func:`extprod_ref`, ``lo`` the band's.

    For digit limb i, one product of the limb's (B', R*N) digit plane (B'
    padded to a multiple of 8, and to more than 16 rows, as the card's
    int8 GEMM needs) and the stacked key limbs lo <= l < 4 - i
    (:func:`key_columns_i8`, or ``key`` if already built); product l, of
    weight 2^(8(i+l)), is shifted and added mod 2^32.  Exact: an s32 sum
    has R*N terms of magnitude <= 2^14.  Used only to time the kernel
    against the library."""
    _, bp, n = acc.shape
    rows = band.shape[1]
    if key is None:
        key = key_columns_i8(band, lo, nd)
    pad = max(-bp % 8, 24 - bp)
    d = digits.reshape(bp, nd, rows * n)
    if pad > 0:
        d = torch.nn.functional.pad(d, (0, 0, 0, 0, 0, pad))
    out = acc.clone()
    for i, k in enumerate(key):
        nl = k.shape[1] // (2 * n)         # key limbs l with i + l < 4
        prod = torch._int_mm(d[:, i], k)[:bp].view(bp, nl, 2, n)
        for t in range(nl):
            out += prod[:, t].transpose(0, 1) << (8 * (i + lo + t))
    return out
