"""K3: one whole blind-rotation step in one kernel, row-major layout (port
of ``go_tfhe_tpu/ops/pallas_step.py``), the fused step of
ops/blindrotate.blind_rotate_tpu (``blindrotate.FUSED_STEP``).

Layouts (the JAX package's, words as int32):
  acc      (2, B, N)          — channel-major, coefficients contiguous
  amounts  (B,) int32         — in [0, 2N]; 2N is the identity
  band     (2, 2L, 2N) int32  — the port's one band layout
                                (cuda_t.pack_bsk_band_t, ``lo`` drop
                                folded in), not the TPU kernel's
                                prepended-pad ``pack_bsk_band``

Int8-digit profiles only (one digit limb, half_bg <= 128), as the TPU
kernel asserts (pallas_step.py:158).

:func:`fused_rotate_step` launches ``csrc/step.cu`` (the tensor-core tile
of ``csrc/extprod_tile.cuh`` with the rotation in its digit staging) on
CUDA tensors and runs :func:`fused_rotate_step_ref` on CPU tensors; each
launch adds one to ``cuda_t.launch_counts["fused_rotate_step"]``.
"""

from __future__ import annotations

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS
from .cuda_extprod import extprod_ref
from .cuda_rotate import rotate_decompose_ref
from .cuda_t import _check, band_limb_drop, check_tile, launch


def _check_profile(p: TFHEParams) -> None:
    if p.digit_limbs != 1 or p.half_bg > 128:
        raise ValueError(
            f"fused_rotate_step: profile {p.name!r} has digits that do not "
            f"fit int8 (bgbit {p.bgbit}, {p.digit_limbs} limbs)")


def fused_rotate_step_ref(p: TFHEParams, acc: torch.Tensor,
                          amounts: torch.Tensor, band: torch.Tensor
                          ) -> torch.Tensor:
    """Plain K3: plain K7 at bs = 1, then plain K8 with ``acc``.

    acc (2, B, N) int32 words; amounts (B,) int32 in [0, 2N]; band
    (2, 2L, 2N) int32.  Returns acc + BSK_i (x) decompose(X^a . acc - acc)
    mod 2^32 as a new tensor."""
    _check_profile(p)
    return extprod_ref(rotate_decompose_ref(p, acc, amounts), band, acc)


def fused_rotate_step(p: TFHEParams, acc: torch.Tensor, amounts: torch.Tensor,
                      band: torch.Tensor) -> torch.Tensor:
    """K3 (replaces pallas_step.fused_rotate_step): see the ref's contract;
    ``band`` packed without the profile's cuda_t.band_limb_drop key limbs
    (the kernel skips them).  Returns a new (2, B, N) tensor; ``acc`` is
    not modified (the TPU kernel aliases it: pallas_step.py:200).  Out of
    place because each block of the kernel reads whole accumulator rows for
    its rotations while other blocks write the same rows."""
    if acc.device.type == "cpu":
        return fused_rotate_step_ref(p, acc, amounts, band)
    _check_profile(p)
    _, b, n = acc.shape
    l2, lo = 2 * p.l, band_limb_drop(p)
    check_tile("fused_rotate_step", n, l2, lo)
    _check("acc", acc, TORUS, (2, b, n), acc.device)
    _check("amounts", amounts, torch.int32, (b,), acc.device)
    _check("band", band, TORUS, (2, l2, 2 * n), acc.device)
    if acc.data_ptr() % 16:
        raise ValueError("fused_rotate_step: acc must be 16-byte aligned")
    out = torch.empty_like(acc)
    launch("fused_rotate_step", "tfhe_fused_step", acc.device,
           acc.data_ptr(), amounts.data_ptr(), band.data_ptr(),
           out.data_ptr(), n, b, p.l, p.bgbit, p.decomposition_offset, lo)
    return out
