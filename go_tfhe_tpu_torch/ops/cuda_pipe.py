"""K9: the half-batch pipelined blind-rotation step (port of
``go_tfhe_tpu/ops/pallas_pipe.py``) and the blind rotation that drives it.

Layouts (K1/K2's transposed ones, ops/cuda_t.py; words as int32):
  acc     (2, N, B2)          — one half of the batch
  digits  (2L*N, B2) int8     — rows [(c, lv)] * N + n
  band    (2, 2L, 2N) int32   — the port's one band layout

One call contracts half X's digits (K2's arithmetic) and rotates and
decomposes half Y (K1's); the two halves share no data.  :func:`pipe_steps`
is the rotation's steps, the route ``blind_rotate_pipe`` of
ops/blindrotate.ROUTES.  The TPU kernel's
``rot_first`` and ``interleave`` only order instructions for Mosaic and
change no value; they are not ported.  Single-limb digits only
(pallas_pipe.py:183).

:func:`pipe_step` launches ``csrc/pipe.cu`` on CUDA tensors with the plan
of :func:`pipe_plan` and runs :func:`pipe_step_ref` on CPU tensors; each
launch adds one to ``cuda_t.launch_counts["pipe_step"]``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..params import TFHEParams
from ..utils.torus import TORUS
# blindrotate as a module (for its rotate): it imports pipe_steps from here.
from . import _build, blindrotate
from .cuda_t import (SMEM_LIMIT, _check, band_limb_drop, check_tile,
                     extprod_t_ref, launch, rotate_decompose_t_ref)

# extprod_tile.cuh's output tile (TN coefficients x TB ciphertexts) and its
# dynamic shared memory at one digit limb (extprod_smem_bytes<1>(); pipe.cu
# refuses a plan below its own count).
_TILE_N = 64
_TILE_B = 64
TILE_SMEM = 27184
# Ciphertexts a Y tile: pipe.cu's kYTile (K1's width, rotdec_t_plan).
Y_TILE = 16


class PipePlan(NamedTuple):
    """K9's launch (csrc/pipe.cu): ``tb`` ciphertexts a Y tile (a Y block
    stages one channel's N rows of them, K1's staged column);
    ``x_blocks`` 64 x 64 output tiles of X's product (both channels), then
    ``y_blocks`` (Y tile, channel) blocks, in one grid; ``smem`` dynamic
    shared-memory bytes a block (the larger of the two kinds' needs)."""
    tb: int
    x_blocks: int
    y_blocks: int
    smem: int


def pipe_plan(n: int, bx: int, by: int) -> PipePlan:
    """K9's launch at N and halves of bx (X) and by (Y) ciphertexts, every
    Y block after the X tiles (the short Y blocks fill the X tiles' last
    wave; interleaving and Y tiles of 8 measured slower, PERF.md §6).  The
    wrapper passes the block counts and the shared memory to pipe.cu,
    which refuses a plan that is not its own.  Raises ValueError for what
    the kernel does not take: N not a multiple of the tile's 64, a
    negative half, or more shared memory than the card allows a block."""
    if n % _TILE_N:
        raise ValueError(f"pipe_step: N={n} is not a multiple of {_TILE_N}")
    if bx < 0 or by < 0:
        raise ValueError(f"pipe_step: halves of {bx} and {by} ciphertexts")
    smem = max(TILE_SMEM, 4 * (n + 1) * Y_TILE)
    if smem > SMEM_LIMIT:
        raise ValueError(f"pipe_step: {smem} bytes of shared memory a block "
                         f"at N={n}; the card allows {SMEM_LIMIT}")
    return PipePlan(Y_TILE, -(-bx // _TILE_B) * (n // _TILE_N) * 2,
                    -(-by // Y_TILE) * 2, smem)


def occupancy(lo: int, smem: int) -> int:
    """The blocks of K9's kernel (``lo``) that one SM of the current card
    holds at ``smem`` bytes of dynamic shared memory a block
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor; no launch)."""
    blocks = ctypes.c_int(0)
    rc = _build.load_library().tfhe_pipe_occupancy(lo, smem,
                                                   ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"pipe_step occupancy query failed: CUDA error "
                           f"{rc}")
    return blocks.value


def _check_profile(p: TFHEParams) -> None:
    if p.digit_limbs != 1:
        raise ValueError(f"pipe_step: profile {p.name!r} has "
                         f"{p.digit_limbs}-limb digits; the pipelined step "
                         "is single-limb only")


def pipe_step_ref(p: TFHEParams, digits_x: torch.Tensor, band: torch.Tensor,
                  acc_x: torch.Tensor, acc_y: torch.Tensor,
                  amt_y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K9: plain K2 on half X, plain K1 on half Y.

    digits_x (2L*N, Bx) int8; band (2, 2L, 2N) int32; acc_x (2, N, Bx);
    acc_y (2, N, By); amt_y (By,) int32 in [0, 2N]; the band packed
    without the profile's cuda_t.band_limb_drop key limbs.  Returns
    (acc_x + digits_x (*) band, digits of X^amt_y . acc_y - acc_y)."""
    _check_profile(p)
    return (extprod_t_ref(digits_x, band, acc_x),
            rotate_decompose_t_ref(p, acc_y, amt_y))


def pipe_step(p: TFHEParams, digits_x: torch.Tensor, band: torch.Tensor,
              acc_x: torch.Tensor, acc_y: torch.Tensor, amt_y: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9 (replaces pallas_pipe.pipe_step): see the ref's contract.  Both
    results are new tensors (the TPU kernel aliases ``acc_x``:
    pallas_pipe.py:229).  The halves may differ in size by one (an odd
    batch); the launch is :func:`pipe_plan`'s at these halves."""
    if acc_x.device.type == "cpu":
        return pipe_step_ref(p, digits_x, band, acc_x, acc_y, amt_y)
    _check_profile(p)
    _, n, bx = acc_x.shape
    by = acc_y.shape[2]
    l2 = 2 * p.l
    lo = band_limb_drop(p)
    dev = acc_x.device
    check_tile("pipe_step", n, l2, lo)
    plan = pipe_plan(n, bx, by)
    _check("digits_x", digits_x, torch.int8, (l2 * n, bx), dev)
    _check("band", band, TORUS, (2, l2, 2 * n), dev)
    _check("acc_x", acc_x, TORUS, (2, n, bx), dev)
    _check("acc_y", acc_y, TORUS, (2, n, by), dev)
    _check("amt_y", amt_y, torch.int32, (by,), dev)
    out_x = torch.empty_like(acc_x)
    dig_y = torch.empty((l2 * n, by), dtype=torch.int8, device=dev)
    launch("pipe_step", "tfhe_pipe_step", dev, digits_x.data_ptr(),
           band.data_ptr(), acc_x.data_ptr(), out_x.data_ptr(),
           acc_y.data_ptr(), amt_y.data_ptr(), dig_y.data_ptr(), n, bx, by,
           p.l, p.bgbit, p.decomposition_offset, lo, plan.x_blocks,
           plan.y_blocks, plan.smem)
    return out_x, dig_y


def pipe_steps(p: TFHEParams, bands: torch.Tensor, acc: torch.Tensor,
               a_tilda: torch.Tensor, ops: tuple) -> torch.Tensor:
    """blind_rotate_pipe's steps on the (2, N, B) accumulator, with the
    amounts ``a_tilda`` (n_lwe, B) and ``ops`` K1 and K9 (or their plain
    versions): the batch in halves A (ceil(B/2)) and B (floor(B/2)), half
    a step out of phase (``go_tfhe_tpu/ops/pallas_pipe.py:236-287``):

        prologue : dig_A = K1(A, step 0)
        step i   : (A, dig_B) = K9(dig_A . BSK_i, rotate B for step i)
                   (B, dig_A) = K9(dig_B . BSK_i, rotate A for step i+1)

    one K1 launch and 2*lwe_n K9 launches.  The last call rotates half A
    by amount 0 for a step that does not exist (the JAX package's extra
    zero column, pallas_pipe.py:267); its digits are discarded."""
    rotate, step = ops
    b2 = (acc.shape[2] + 1) // 2
    acc_a = acc[:, :, :b2].contiguous()
    acc_b = acc[:, :, b2:].contiguous()
    amt_a = torch.cat([a_tilda[:, :b2], a_tilda.new_zeros((1, b2))])
    amt_b = a_tilda[:, b2:].contiguous()                      # (n_lwe, B - b2)
    del acc, a_tilda          # the halves are copies: free the whole batch
    dig_a = rotate(p, acc_a, amt_a[0])
    for i in range(p.lwe_n):
        acc_a, dig_b = step(p, dig_a, bands[i], acc_a, acc_b, amt_b[i])
        acc_b, dig_a = step(p, dig_b, bands[i], acc_b, acc_a, amt_a[i + 1])
    return torch.cat([acc_a, acc_b], dim=2)


def blind_rotate_pipe(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                      testvec: torch.Tensor, plain: bool = False
                      ) -> torch.Tensor:
    """Blind rotation with the batch in two halves half a step out of
    phase (:func:`pipe_steps`), bit-exact with
    ops/blindrotate.blind_rotate_t.  An odd batch splits into halves of
    ceil(B/2) and floor(B/2), each masked by the kernel; a ciphertext's
    result does not depend on the split.

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands (cuda_t.pack_bsk_band_t).
    ct:      (B, n_lwe+1) int32 words.
    testvec: (2, N) or (B, 2, N) int32 words.
    plain:   run the kernels' plain versions on any device.
    Returns (B, 2, N) int32 TRLWE accumulators.
    """
    return blindrotate.rotate("blind_rotate_pipe", p, bands, ct, testvec,
                              plain=plain)
