"""K8: the row-major external product with the accumulator update fused
(port of ``go_tfhe_tpu/ops/pallas_extprod.py``), the second kernel of the
block blind rotation's step and of the row-major extended-LUT step
(ops/blindrotate.blind_rotate_block, blind_rotate_extended_rm).

Layouts (the JAX package's, words as int32):
  digits  (B', ND*R*N) int8  — rows are ciphertexts (or ciphertext-blocks),
                               limb-major: column (i*R + r)*N + j
  band    (2, R, 2N) int32   — the port's one band layout, K2's
                               (cuda_t.pack_bsk_band_t, the ``lo`` drop
                               folded in); R = 2L, or bs*2L rows of a
                               block step (block bit, then its 2L rows)
  acc     (2, B', N)         — channel-major accumulators

:func:`extprod` launches ``csrc/extprod.cu`` on CUDA tensors and runs
:func:`extprod_ref` on CPU tensors; each launch adds one to
``cuda_t.launch_counts["extprod"]``.
"""

from __future__ import annotations

import torch

from ..utils.torus import TORUS
from . import _build
from .cuda_t import _EXTPROD_TN, _check, extprod_t_ref, launch_counts


def extprod_ref(digits: torch.Tensor, band: torch.Tensor,
                acc: torch.Tensor, nd: int = 1) -> torch.Tensor:
    """Plain K8: plain K2's exact Toeplitz contraction
    (cuda_t.extprod_t_ref) in the row-major layout.

    digits (B', ND*R*N) int8 limb-major; band (2, R, 2N) int32; acc
    (2, B', N).  Returns acc + sum_{r,j} d[b,r,j] * band[c, r, N+n-j]
    mod 2^32 with d = sum_i limb_i * 256^i: the TPU kernel's value, whose
    digit-limb x key-limb pairs of weight >= 2^32 vanish mod 2^32."""
    return extprod_t_ref(digits.t(), band, acc.transpose(1, 2),
                         nd).transpose(1, 2).contiguous()


def extprod(digits: torch.Tensor, band: torch.Tensor, acc: torch.Tensor,
            nd: int = 1) -> torch.Tensor:
    """K8 (replaces pallas_extprod.extprod_pallas with ``acc``): see the
    ref's contract.  Returns a new (2, B', N) tensor; ``acc`` is not
    modified."""
    if acc.device.type == "cpu":
        return extprod_ref(digits, band, acc, nd)
    _, bp, n = acc.shape
    rows = band.shape[1]
    if n % _EXTPROD_TN:
        raise ValueError(f"extprod: N={n} is not a multiple of "
                         f"{_EXTPROD_TN}")
    _check("acc", acc, TORUS, (2, bp, n), acc.device)
    _check("band", band, TORUS, (2, rows, 2 * n), acc.device)
    _check("digits", digits, torch.int8, (bp, nd * rows * n), acc.device)
    if digits.data_ptr() % 4:
        raise ValueError("extprod: digits must be 4-byte aligned")
    out = torch.empty_like(acc)
    lib = _build.load_library()
    with torch.cuda.device(acc.device):
        rc = lib.tfhe_extprod(
            digits.data_ptr(), band.data_ptr(), acc.data_ptr(),
            out.data_ptr(), n, bp, rows, nd,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"extprod kernel launch failed: CUDA error {rc}")
    launch_counts["extprod"] += 1
    return out
