"""Blind rotation — the bootstrap hot loop, batched over ciphertexts
(port of ``go_tfhe_tpu/ops/blindrotate.py``).

Per input LWE coefficient the accumulator is rotated by the mod-switched
coefficient and CMUXed with the corresponding bootstrapping-key row; the
lwe_n steps are sequential and throughput comes from the batch axis.

One function, :func:`rotate`, runs all nine rotations, each an entry of
:data:`ROUTES`: the mod switch and the test vector's first rotation
(:func:`_prologue`), the move into the route's accumulator layout
(:func:`_into`), the route's steps, and the move back (:func:`_back`).
The kernel routes' steps run the step kernels (ops/cuda_*.py), which run
their plain versions on CPU tensors and the Hopper kernels on CUDA
tensors; ``plain`` runs the plain versions on any device.  At the small
batches where the host's launches would set the pace (:func:`takes_graph`),
a route marked ``graphed`` replays its steps from a CUDA graph
(:class:`_StepGraph`).  Only blind_rotate_t is marked: it was measured on
an H100 (PERF.md, §6), and no other route runs at small batches in a
cell.  At the smallest of them its step is one launch on a card, K1's
rotate and decompose made inside K2's small form (cuda_t.step_t_small).

Mod switch (evaluator/evaluator.go:116,122):
    b~ = 2N - ((b + 2^(31-NBIT-1)) >> (32-NBIT-1))
    a~ =      ((a + 2^(31-NBIT-1)) >> (32-NBIT-1))

Extended look-up tables (poly_extend_factor k > 1) rotate an interleaved
big accumulator of k blocks over [0, 2kN]: :func:`blind_rotate_extended_t`
(transposed, K4 + K5, ops/cuda_ext_t.py) for the profiles that pass
``ext_t_fits``, :func:`blind_rotate_extended_rm` (row-major, K6 + K8,
ops/cuda_ext.py and ops/cuda_extprod.py) for uint8.

Block-binary keys (Hamming weight <= 1 per block of ``block_size`` bits)
may take :func:`blind_rotate_block`: one step per block, K7 + K8
(ops/cuda_rotate.py, ops/cuda_extprod.py).

:func:`blind_rotate_tpu` is the per-bit rotation in the row-major layout:
K7 at bs = 1 + K8 per step, or the fused step K3 (ops/cuda_step.py) with
:data:`FUSED_STEP`.  The half-batch pipelined rotation (K1 + K9) is
ops/cuda_pipe.blind_rotate_pipe.  These read the K2 bands
(cuda_t.pack_bsk_band_t), the port's one kernel band layout.

The portable rotations :func:`blind_rotate`, :func:`blind_rotate_extended`
and :func:`blind_rotate_block_portable` are the JAX package's off-TPU path
(the one its dispatch takes on any other backend): gather rotations
(rotate.monomial_mul, monomial_mul_blocks) and the Toeplitz external
product (ops/extprod.py) on the signed D bands
(keys.prepare_bootstrap_kernels), no kernel.  They share nothing with the
kernels' arithmetic, and give the kernels' words wherever the kernels'
dropped key limbs are zero (every key on its profile's grid).

The nine rotations by name (the port keeps the names that its routes, the
launch counters and chip_smoke.py already read, so three differ):

    JAX package                       port
    blind_rotate                      blind_rotate
    blind_rotate_extended             blind_rotate_extended
    blind_rotate_extended_tpu         blind_rotate_extended_rm
    blind_rotate_extended_t           blind_rotate_extended_t
    blind_rotate_block                blind_rotate_block_portable
    blind_rotate_block_tpu            blind_rotate_block
    blind_rotate_tpu                  blind_rotate_tpu
    blind_rotate_t                    blind_rotate_t
    pallas_pipe.blind_rotate_pipe     cuda_pipe.blind_rotate_pipe
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, NamedTuple

import torch

from ..params import TFHEParams
from ..utils import tracing
from ..utils.torus import TORUS, shr, wrap_i32
from ..utils.tracing import count, span
from .cuda_ext import rotate_decompose_ext, rotate_decompose_ext_ref
from .cuda_ext_t import (extprod_ext_t, extprod_ext_t_ref,
                         rotate_decompose_ext_t, rotate_decompose_ext_t_ref)
from .cuda_extprod import extprod, extprod_ref
from .cuda_pipe import pipe_step, pipe_step_ref, pipe_steps
from .cuda_rotate import rotate_decompose, rotate_decompose_ref
from .cuda_step import fused_rotate_step, fused_rotate_step_ref
from .cuda_t import (SMALL_BATCH_MAX, band_limb_drop, extprod_t,
                     extprod_t_ref, launch_counts, rotate_decompose_t,
                     rotate_decompose_t_ref, step_t_small, step_t_small_ref,
                     takes_fused_step)
from .decompose import gadget_decompose
from .extprod import cmux, external_product
from .polymul import negacyclic_extprod_toeplitz
from .rotate import monomial_mul, monomial_mul_blocks

# Run blind_rotate_tpu's steps through the fused step kernel K3 instead of
# K7 + K8.  Off by default, as in the JAX package
# (go_tfhe_tpu/ops/blindrotate.py:39-47), whose reason is a TPU
# measurement: Mosaic ran the fused kernel's rotation and contraction one
# after the other.  On an H100 the unfused step is ahead too (K7 + K8
# 10,953 vs K3 3,344 gates/s at 128bit_fast, batch 4096; PERF.md): K3
# recomputes a batch tile's digits in each of the 2*N/64 blocks that read
# it.
FUSED_STEP = False

# The rotations run, and of them those whose steps were replayed from a
# CUDA graph (:func:`takes_graph`): utils/tracing.py's always-kept counts.
rotation_counts = tracing.rotation_counts


def mod_switch_2n(x: torch.Tensor, p: TFHEParams, theta: int = 0
                  ) -> torch.Tensor:
    """Torus -> [0, 2N] rounding mod-switch; returns int32.  ``theta > 0``
    rounds to multiples of 2^theta (the PBSmanyLUT coarse mod switch)."""
    shift = p.mod_switch_shift + theta
    coarse = shr(x + (1 << (shift - 1)), shift)
    return coarse << theta


def mod_switch_general(x: torch.Tensor, modulus: int) -> torch.Tensor:
    """Torus -> [0, modulus] rounding mod switch for any modulus <= 2^16:
    floor((x*M + 2^31) / 2^32), computed as the JAX package computes it in
    uint32 words (16-bit halves; every product and sum wraps mod 2^32),
    here in int64 with explicit masks.  Returns int32.

    The result keeps 16 bits, so above 2^16 it would be the value mod 2^16
    and not mod M (the JAX package takes moduli up to 2^17 and wraps
    there); such a modulus is refused.  The largest a profile uses is
    uint8's 2kN = 36,864."""
    if modulus > 1 << 16:
        raise ValueError(f"modulus {modulus} > 2^16")
    mask = 0xFFFFFFFF
    x = x.to(torch.int64) & mask
    a_hi, a_lo = x >> 16, x & 0xFFFF
    acc = a_hi * modulus + (((a_lo * modulus) & mask) >> 16) + (1 << 15)
    return wrap_i32((acc & mask) >> 16)


# ---------------------------------------------------------------------------
# The rotation.
# ---------------------------------------------------------------------------

class Route(NamedTuple):
    """A blind rotation: what of it is its own.

    layout:  the accumulator's layout through the steps (:func:`_into`):
             "batch" (..., [k,] 2, N), the portable routes', which read the
             signed D bands (keys.prepare_bootstrap_kernels) and launch no
             kernel; "col" (2, k*N, B), K1/K2's, K4/K5's and K1 + K9's;
             "row" (2, B, k*N), K3/K7/K8's, K7/K8's and K6/K8's.
    steps:   ``steps(p, bands, acc, a_tilda, ops)``: the n_lwe steps from
             the accumulator ``acc`` with the amounts ``a_tilda``, both in
             the layout; returns the accumulator.
    kernels: the ``ops`` that ``steps`` runs: the step kernels' wrappers.
    plain:   their plain versions, in the same order (``plain=True``).
    graphed: replays its steps from a CUDA graph where :func:`takes_graph`
             says so.
    """

    layout: str
    steps: Callable
    kernels: tuple = ()
    plain: tuple = ()
    graphed: bool = False

    @property
    def portable(self) -> bool:
        """The JAX package's off-TPU cores: D bands, no kernel."""
        return self.layout == "batch"


def rotate(route: str, p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
           testvec: torch.Tensor, theta: int = 0, plain: bool = False
           ) -> torch.Tensor:
    """Blind-rotate a batch of LWE ciphertexts through ``route``, a name of
    :data:`ROUTES`.

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands (cuda_t.pack_bsk_band_t) on
             a kernel route; (n_lwe, 2L, 2, 2N) signed D bands on a
             portable one.
    ct:      (B, n_lwe+1) int32 words; (..., n_lwe+1) on a portable route.
    testvec: (2, N) or (B, 2, N) int32 words; at k > 1 the table's trivial
             TRLWE blocks, (k, 2, N) or (B, k, 2, N).
    theta:   the coarse mod switch's exponent (many-LUT extraction, k = 1).
    plain:   run the kernels' plain versions on any device (to hold the
             kernels against them on the card); a portable route has none.
    Returns (B, 2, N) int32 TRLWE accumulators, (B, k, 2, N) at k > 1 (the
    bootstrap reads block 0 at index 0).

    Where the route is graphed and :func:`takes_graph` says so, the steps
    are one replay of a CUDA graph of the same launches
    (:class:`_StepGraph`), captured after the first, eager, rotation at
    the batch; the prologue and the layouts stay eager.
    """
    r = ROUTES[route]
    b = ct.numel() // ct.shape[-1]
    graphed = r.graphed and takes_graph(ct.device, b, plain)
    graphs = _graphs_of(bands) if graphed else {}
    key = (route, ct.device.index, b, p)
    graph = graphs.get(key)
    # The prologue's tensors go straight into the steps, so that nothing
    # here holds them: the first accumulator goes with the first step.
    if graph is not None:
        acc = graph.run(*_prologue(r.layout, p, ct, testvec, theta))
        rotation_counts["replayed"] += 1
    else:
        acc = r.steps(p, bands, *_prologue(r.layout, p, ct, testvec, theta),
                      r.plain if plain else r.kernels)
        if graphed:
            # The eager rotation was the kernels' first use at this batch
            # (their first launches, attribute calls and K2's shape rule),
            # so the capture meets none of them.
            graphs[key] = _StepGraph(r, p, bands, b, ct.device)
    rotation_counts["rotations"] += 1
    acc = _back(r.layout, p, acc)
    # A replay's result is the graph's own buffer, which the next replay
    # overwrites: the caller gets a copy even where the layout back is a
    # view (B 1).
    return (acc.clone(memory_format=torch.contiguous_format)
            if graph is not None else acc.contiguous())


def _prologue(layout: str, p: TFHEParams, ct: torch.Tensor,
              testvec: torch.Tensor, theta: int) -> tuple:
    """The rotation's set-up: the mod switch (to 2N, or to 2kN at k > 1),
    the test vector's first rotation by X^(-b~), and the move into
    ``layout``.  Returns the accumulator and the amounts a~.  At k > 1
    inside the span ``rotation.ext_blocks``, then B*k rows counted under
    ``rotation.block_rows`` (K8's or K5's batch with the blocks folded
    in)."""
    n_lwe, k, n = p.lwe_n, p.poly_extend_factor, p.n
    lead = ct.shape[:-1]
    if k == 1:
        b_tilda = 2 * n - mod_switch_2n(ct[..., n_lwe], p, theta)
        acc = monomial_mul(testvec.expand(lead + (2, n)), b_tilda[..., None])
        return _into(layout, p, acc,
                     mod_switch_2n(ct[..., :n_lwe], p, theta))
    big = 2 * k * n
    with span("rotation.ext_blocks", ct.device):
        b_tilda = big - mod_switch_general(ct[..., n_lwe], big)
        acc = monomial_mul_blocks(testvec.expand(lead + (k, 2, n)), b_tilda,
                                  k)
        start = _into(layout, p, acc, mod_switch_general(ct[..., :n_lwe],
                                                         big))
    count("rotation.block_rows", b_tilda.numel() * k)
    return start


def _into(layout: str, p: TFHEParams, acc: torch.Tensor,
          a_tilda: torch.Tensor) -> tuple:
    """The accumulator (B, [k,] 2, N) and amounts (B, n_lwe) in
    ``layout``'s forms, contiguous: "col" (2, k*N, B), block r in rows
    [rN, (r+1)N); "row" (2, B, k*N), block r in columns [rN, (r+1)N); the
    amounts (n_lwe, B).  The batch layout keeps both as they are."""
    if layout == "batch":
        return acc, a_tilda
    b, k, n = a_tilda.shape[0], p.poly_extend_factor, p.n
    acc = acc.reshape(b, k, 2, n)
    if layout == "col":
        acc = acc.permute(2, 1, 3, 0).reshape(2, k * n, b)
    else:
        acc = acc.permute(2, 0, 1, 3).reshape(2, b, k * n)
    return acc.contiguous(), a_tilda.t().contiguous()


def _back(layout: str, p: TFHEParams, acc: torch.Tensor) -> torch.Tensor:
    """``layout``'s accumulator back in the batch layout (B, [k,] 2, N), a
    view."""
    if layout == "batch":
        return acc
    k, n = p.poly_extend_factor, p.n
    if layout == "col":
        acc = acc.reshape(2, k, n, acc.shape[2]).permute(3, 1, 0, 2)
    else:
        acc = acc.reshape(2, acc.shape[1], k, n).permute(1, 2, 0, 3)
    return acc if k > 1 else acc[:, 0]


def takes_graph(device: torch.device, b: int, plain: bool = False) -> bool:
    """Whether a graphed route replays its steps from a CUDA graph: the
    kernels on a card (not their plain versions) at a batch of at most
    cuda_t.SMALL_BATCH_MAX, where the host's launches take longer than the
    card's kernels (PERF.md, §5)."""
    return not plain and device.type == "cuda" and b <= SMALL_BATCH_MAX


# id(bands) -> (a weak reference to them, {(route, card, batch, profile):
# _StepGraph}).  The reference's callback drops the entry when the bands
# go, so that no replay outlives the bands it reads and freeing a key
# frees its graphs.
_graphs: dict = {}


def _graphs_of(bands: torch.Tensor) -> dict:
    """The step graphs captured over ``bands``."""
    entry = _graphs.get(id(bands))
    if entry is None or entry[0]() is not bands:
        key = id(bands)
        entry = _graphs[key] = (
            weakref.ref(bands, lambda _, key=key: _graphs.pop(key, None)), {})
    return entry[1]


class _StepGraph:
    """A route's n_lwe steps at one batch, captured once in a CUDA graph:
    the same launches with the same arguments, in the same order, as its
    eager steps.

    The graph reads its own input buffers, ``acc`` (the route's layout)
    and ``a_tilda`` (n_lwe, B), which :meth:`run` fills, and writes ``out``
    in its private pool, which also holds the steps' digits and
    accumulators (a few of each, reused within the capture).  It holds no
    reference to the bands: :func:`_graphs_of` drops it with them.  A
    replay runs on the caller's current stream; calls on two streams must
    not overlap, since they share the buffers."""

    def __init__(self, route: Route, p: TFHEParams, bands: torch.Tensor,
                 b: int, device: torch.device):
        kn = p.poly_extend_factor * p.n
        self.acc = torch.zeros((2, kn, b) if route.layout == "col"
                               else (2, b, kn), dtype=TORUS, device=device)
        self.a_tilda = torch.zeros((p.lwe_n, b), dtype=torch.int32,
                                   device=device)
        before = dict(launch_counts)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    self.graph, stream=torch.cuda.Stream(device)):
                self.out = route.steps(p, bands, self.acc, self.a_tilda,
                                       route.kernels)
        finally:
            # The capture ran nothing: its launches count at each replay.
            self.launches = {name: launch_counts[name] - n
                             for name, n in before.items()
                             if launch_counts[name] != n}
            launch_counts.update(before)

    def run(self, acc: torch.Tensor, a_tilda: torch.Tensor) -> torch.Tensor:
        """The steps from ``acc`` with amounts ``a_tilda`` (any strides);
        returns ``out``, which the next replay overwrites.  While the
        recorder is on, ``launch.host_ns`` adds the replay's host time."""
        self.acc.copy_(acc)
        self.a_tilda.copy_(a_tilda)
        t0 = time.perf_counter_ns() if tracing.active else 0
        self.graph.replay()
        if t0:
            count("launch.host_ns", time.perf_counter_ns() - t0)
        for name, n in self.launches.items():
            launch_counts[name] += n
        return self.out


# ---------------------------------------------------------------------------
# The routes' steps.
# ---------------------------------------------------------------------------

# Each is ``Route.steps``: steps(p, bands, acc, a_tilda, ops) -> acc.

def _cmux_steps(p, bsk_bands, acc, a_tilda, ops):
    """blind_rotate's: a gather rotation and :func:`.extprod.cmux`, a step
    per amount (the last axis of ``a_tilda``)."""
    for i in range(a_tilda.shape[-1]):
        rotated = monomial_mul(acc, a_tilda[..., i, None])
        acc = cmux(p, bsk_bands[i], acc, rotated)
    return acc


def _blocks_cmux_steps(p, bsk_bands, acc, a_tilda, ops):
    """blind_rotate_extended's: the k blocks' rotation, and a CMUX that
    contracts every block against the same D band."""
    k = p.poly_extend_factor
    for i in range(p.lwe_n):
        rotated = monomial_mul_blocks(acc, a_tilda[..., i], k)
        # block-wise CMUX: k is one more batch axis of the contraction
        acc = acc + external_product(p, bsk_bands[i], rotated - acc)
    return acc


def _block_portable_steps(p, bsk_bands, acc, a_tilda, ops):
    """blind_rotate_block_portable's: a block's bs rotations' differences
    decomposed together and contracted in one Toeplitz product of bs*2L
    rows; the ragged tail per bit (:func:`_cmux_steps`)."""
    bs, l2 = p.block_size, 2 * p.l
    full = p.lwe_n // bs
    lead = acc.shape[:-2]
    a_blk = a_tilda[..., :full * bs].reshape(lead + (full, bs))
    band_blk = bsk_bands[:full * bs].reshape(full, bs * l2, 2, 2 * p.n)
    for i in range(full):
        rotated = monomial_mul(acc[..., None, :, :], a_blk[..., i, :, None])
        diff = rotated - acc[..., None, :, :]                  # (...,bs,2,N)
        digits = gadget_decompose(diff, p).reshape(lead + (bs * l2, p.n))
        acc = acc + negacyclic_extprod_toeplitz(digits, band_blk[i])
    return _cmux_steps(p, bsk_bands[full * bs:], acc,
                       a_tilda[..., full * bs:], ops)


def _bit_steps(p, bands, acc, a_tilda, ops):
    """A step per amount (a row of ``a_tilda``): ``ops`` rotate and
    decompose, then contract the digits with the step's band and add the
    accumulator.  blind_rotate_t's K1 + K2 on (2, N, B); K7 at bs = 1 + K8
    on (2, B, N), blind_rotate_tpu's and the block rotation's ragged
    tail."""
    rotdec, contract = ops
    nd, lo = p.digit_limbs, band_limb_drop(p)
    for i in range(a_tilda.shape[0]):
        # The digits stay bound until the next step's are made: passed
        # inline, a replayed 128bit rotation at B 1 ran 1.2% slower on an
        # H100 (PERF.md §6).
        digits = rotdec(p, acc, a_tilda[i])
        acc = contract(digits, bands[i], acc, nd, lo)
    return acc


def _t_steps(p, bands, acc, a_tilda, ops):
    """blind_rotate_t's, on the (2, N, B) accumulator: one launch a step,
    K1's rotate and decompose made inside K2's small form
    (cuda_t.step_t_small), where cuda_t.takes_fused_step says so for the
    accumulator's card and batch; else :func:`_bit_steps` with K1 and K2.
    The plain versions choose the same way: their fused step is K1's
    plain version, then K2's."""
    rotdec, contract, step = ops
    if not takes_fused_step(acc.device, p, acc.shape[2]):
        return _bit_steps(p, bands, acc, a_tilda, (rotdec, contract))
    for i in range(a_tilda.shape[0]):
        acc = step(p, acc, a_tilda[i], bands[i])
    return acc


def _ext_t_steps(p, bands, acc, a_tilda, ops):
    """blind_rotate_extended_t's, on the (2, k*N, B) accumulator: K4, then
    K5, every block against the step's band."""
    rotdec, contract = ops
    k, nd, lo = p.poly_extend_factor, p.digit_limbs, band_limb_drop(p)
    for i in range(p.lwe_n):
        digits = rotdec(p, acc, a_tilda[i])
        acc = contract(digits, bands[i], acc, k, nd, lo)
    return acc


def _ext_rm_steps(p, bands, acc, a_tilda, ops):
    """blind_rotate_extended_rm's, on the (2, B, k*N) accumulator: K6, then
    K8 with the k blocks folded into its batch."""
    rotdec, contract = ops
    k, n, nd, lo = p.poly_extend_factor, p.n, p.digit_limbs, band_limb_drop(p)
    b = acc.shape[1]
    for i in range(p.lwe_n):
        digits = rotdec(p, acc, a_tilda[i])
        acc = contract(digits.view(b * k, -1), bands[i],
                       acc.view(2, b * k, n), nd, lo).view(2, b, k * n)
    return acc


def _block_steps(p, bands, acc, a_tilda, ops):
    """blind_rotate_block's, on the (2, B, N) accumulator: K7 by a block's
    bs amounts, then K8 against the block's bands (:func:`block_bands`);
    the ragged tail per bit (:func:`_bit_steps`)."""
    rotdec, contract = ops
    bs, nd, lo = p.block_size, p.digit_limbs, band_limb_drop(p)
    full = p.lwe_n // bs
    a_blk = a_tilda[:full * bs].view(full, bs, acc.shape[1])
    band_blk = block_bands(p, bands)
    for i in range(full):
        digits = rotdec(p, acc, a_blk[i])
        acc = contract(digits, band_blk[i], acc, nd, lo)
    return _bit_steps(p, bands[full * bs:], acc, a_tilda[full * bs:], ops)


def _tpu_steps(p, bands, acc, a_tilda, ops):
    """blind_rotate_tpu's, on the (2, B, N) accumulator: K3 where
    :data:`FUSED_STEP` is set and the digits fit int8, else
    :func:`_bit_steps` with K7 and K8."""
    step, *pair = ops
    int8_ok = 2 * p.l * p.n * min(p.half_bg, 128) * 128 < 1 << 31
    if not (FUSED_STEP and p.digits_fit_int8 and int8_ok):
        return _bit_steps(p, bands, acc, a_tilda, pair)
    for i in range(p.lwe_n):
        acc = step(p, acc, a_tilda[i], bands[i])
    return acc


# The nine rotations.  Only blind_rotate_t is graphed (see the module
# docstring); marking another route is a measurement on the card first.
ROUTES = {
    "blind_rotate": Route("batch", _cmux_steps),
    "blind_rotate_extended": Route("batch", _blocks_cmux_steps),
    "blind_rotate_block_portable": Route("batch", _block_portable_steps),
    "blind_rotate_t": Route(
        "col", _t_steps, (rotate_decompose_t, extprod_t, step_t_small),
        (rotate_decompose_t_ref, extprod_t_ref, step_t_small_ref),
        graphed=True),
    "blind_rotate_extended_t": Route(
        "col", _ext_t_steps, (rotate_decompose_ext_t, extprod_ext_t),
        (rotate_decompose_ext_t_ref, extprod_ext_t_ref)),
    "blind_rotate_pipe": Route(
        "col", pipe_steps, (rotate_decompose_t, pipe_step),
        (rotate_decompose_t_ref, pipe_step_ref)),
    "blind_rotate_extended_rm": Route(
        "row", _ext_rm_steps, (rotate_decompose_ext, extprod),
        (rotate_decompose_ext_ref, extprod_ref)),
    "blind_rotate_block": Route(
        "row", _block_steps, (rotate_decompose, extprod),
        (rotate_decompose_ref, extprod_ref)),
    "blind_rotate_tpu": Route(
        "row", _tpu_steps, (fused_rotate_step, rotate_decompose, extprod),
        (fused_rotate_step_ref, rotate_decompose_ref, extprod_ref)),
}


# ---------------------------------------------------------------------------
# The nine rotations by name.
# ---------------------------------------------------------------------------

def blind_rotate(p: TFHEParams, bsk_bands: torch.Tensor, ct: torch.Tensor,
                 testvec: torch.Tensor, theta: int = 0) -> torch.Tensor:
    """Blind-rotate a batch of LWE ciphertexts, portable path
    (``go_tfhe_tpu/ops/blindrotate.py:82-117``): per step a gather
    rotation and :func:`.extprod.cmux`.

    bsk_bands: (n_lwe, 2L, 2, 2N) int32 signed D bands
               (keys.prepare_bootstrap_kernels).
    ct:        (..., n_lwe+1) int32 words.
    testvec:   (2, N) or (..., 2, N) int32 words.
    theta:     coarse mod-switch exponent for many-LUT extraction.
    Returns (..., 2, N) int32 TRLWE accumulators.
    """
    return rotate("blind_rotate", p, bsk_bands, ct, testvec, theta)


def blind_rotate_extended(p: TFHEParams, bsk_bands: torch.Tensor,
                          ct: torch.Tensor, lut_blocks: torch.Tensor
                          ) -> torch.Tensor:
    """Blind rotation over an extended look-up table of size k*N, portable
    path (``go_tfhe_tpu/ops/blindrotate.py:120-159``): the accumulator is k
    TRLWE blocks of the interleaved big polynomial
    (rotate.monomial_mul_blocks), each CMUX contracts every block against
    the same D band, and the mod switch targets [0, 2kN).

    bsk_bands:  (n_lwe, 2L, 2, 2N) int32 signed D bands.
    ct:         (..., n_lwe+1) int32 words.
    lut_blocks: (k, 2, N) or (..., k, 2, N) int32 trivial TRLWE blocks.
    Returns (..., k, 2, N); the bootstrap reads block 0 at index 0.
    """
    return rotate("blind_rotate_extended", p, bsk_bands, ct, lut_blocks)


def blind_rotate_block_portable(p: TFHEParams, bsk_bands: torch.Tensor,
                                ct: torch.Tensor, testvec: torch.Tensor
                                ) -> torch.Tensor:
    """Block blind rotation, portable path (the JAX package's
    ``blind_rotate_block``, ``go_tfhe_tpu/ops/blindrotate.py:258-310``);
    needs a block-binary lv0 key.  One step per block of bs = block_size
    bits, acc' = acc + sum_j BSK[j] (x) (X^(a_j) acc - acc): the bs
    rotations' differences decomposed together and contracted in ONE
    Toeplitz product of bs*2L rows; a ragged tail of n_lwe mod bs bits
    takes per-bit CMUX steps.

    bsk_bands: (n_lwe, 2L, 2, 2N) int32 signed D bands.
    ct:        (..., n_lwe+1) int32 words;  testvec: (2, N) or (..., 2, N).
    Returns (..., 2, N) int32 TRLWE accumulators.
    """
    return rotate("blind_rotate_block_portable", p, bsk_bands, ct, testvec)


def blind_rotate_t(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                   testvec: torch.Tensor, theta: int = 0,
                   plain: bool = False) -> torch.Tensor:
    """Blind-rotate a batch of LWE ciphertexts: per step K1, then K2; one
    launch a step where cuda_t.takes_fused_step says so (a card, B <=
    cuda_t.FUSED_BATCH_MAX: cuda_t.step_t_small, the same words).

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands (cuda_t.pack_bsk_band_t).
    ct:      (B, n_lwe+1) int32 words.
    testvec: (2, N) or (B, 2, N) int32 words.
    plain:   run the kernels' plain versions on any device (to hold the
             kernels against them on the card).
    Returns (B, 2, N) int32 TRLWE accumulators.

    Where :func:`takes_graph` says so, the n_lwe steps are one replay of a
    CUDA graph of the same launches (:class:`_StepGraph`), captured after
    the first, eager, rotation at the batch; the mod switch, the test
    vector's first rotation and the layouts stay eager.
    """
    return rotate("blind_rotate_t", p, bands, ct, testvec, theta, plain)


def blind_rotate_extended_t(p: TFHEParams, bands: torch.Tensor,
                            ct: torch.Tensor, lut_blocks: torch.Tensor,
                            plain: bool = False) -> torch.Tensor:
    """Blind rotation over an extended look-up table of size k*N
    (``go_tfhe_tpu/ops/blindrotate.py:221-255``): per step K4 rotates and
    decomposes the (2, k*N, B) big accumulator and K5 contracts every
    block against the same band.

    bands:      (n_lwe, 2, 2L, 2N) int32 K2 bands.
    ct:         (B, n_lwe+1) int32 words.
    lut_blocks: (k, 2, N) or (B, k, 2, N) int32 trivial TRLWE blocks.
    plain:      run the kernels' plain versions on any device.
    Returns (B, k, 2, N); the bootstrap reads block 0 at index 0.
    """
    return rotate("blind_rotate_extended_t", p, bands, ct, lut_blocks,
                  plain=plain)


def blind_rotate_extended_rm(p: TFHEParams, bands: torch.Tensor,
                             ct: torch.Tensor, lut_blocks: torch.Tensor,
                             plain: bool = False) -> torch.Tensor:
    """Row-major blind rotation over an extended look-up table
    (``go_tfhe_tpu/ops/blindrotate.py:162-218``, blind_rotate_extended_tpu),
    bit-exact with :func:`blind_rotate_extended_t`.  Per step, K6 rotates
    and decomposes the (2, B, k*N) big accumulator, and K8 contracts the
    digits with the k blocks folded into the batch (every block against
    the same band) and adds the result into the accumulator.

    bands:      (n_lwe, 2, 2L, 2N) int32 K2 bands.
    ct:         (B, n_lwe+1) int32 words.
    lut_blocks: (k, 2, N) or (B, k, 2, N) int32 trivial TRLWE blocks.
    plain:      run the kernels' plain versions on any device.
    Returns (B, k, 2, N); the bootstrap reads block 0 at index 0.
    """
    return rotate("blind_rotate_extended_rm", p, bands, ct, lut_blocks,
                  plain=plain)


def block_bands(p: TFHEParams, bands: torch.Tensor) -> torch.Tensor:
    """The K2 bands of the full blocks as K8 reads them in a block step:
    (full, 2, bs*2L, 2N), rows block-bit-major (block bit j, then its 2L
    BSK rows), the order of ``go_tfhe_tpu/ops/blindrotate.py:497-503`` and
    of K7's digit rows.  A copy of the first full*bs bands, made once per
    blind rotation."""
    bs, l2 = p.block_size, 2 * p.l
    full = p.lwe_n // bs
    w = bands.shape[-1]
    return bands[:full * bs].reshape(full, bs, 2, l2, w).transpose(1, 2
                                                                   ).reshape(
        full, 2, bs * l2, w)


def blind_rotate_block(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                       testvec: torch.Tensor, plain: bool = False
                       ) -> torch.Tensor:
    """Block blind rotation (``go_tfhe_tpu/ops/blindrotate.py:451-531``,
    blind_rotate_block_tpu; bit-exact with
    :func:`blind_rotate_block_portable` on keys whose dropped limbs are
    zero).  Needs a block-binary
    lv0 key: with at most one key bit set per block,
    X^(sum_j s_j a_j) = 1 + sum_j s_j (X^(a_j) - 1), so one step per block
    of bs = block_size bits is

        acc' = acc + sum_j BSK[j] (x) (X^(a_j) acc - acc):

    K7 rotates the same accumulator by the block's bs amounts and
    decomposes, K8 contracts the bs*2L digit rows against the block's bands
    (:func:`block_bands`) and adds into the accumulator.  ceil(n_lwe / bs)
    sequential steps instead of n_lwe; a ragged tail of n_lwe mod bs bits
    runs per-bit steps (K7 with bs = 1, K8 over 2L rows).

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands.
    ct:      (B, n_lwe+1) int32 words.
    testvec: (2, N) or (B, 2, N) int32 words.
    plain:   run the kernels' plain versions on any device.
    Returns (B, 2, N) int32 TRLWE accumulators.
    """
    return rotate("blind_rotate_block", p, bands, ct, testvec, plain=plain)


def blind_rotate_tpu(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                     testvec: torch.Tensor, plain: bool = False
                     ) -> torch.Tensor:
    """Per-bit blind rotation in the row-major layout
    (``go_tfhe_tpu/ops/blindrotate.py:338-407``), bit-exact with
    :func:`blind_rotate_t`.  The accumulator lives as (2, B, N); per step,
    the fused kernel K3 when :data:`FUSED_STEP` is set and the digits fit
    int8 (the JAX package's condition, :386-387), else K7 at bs = 1 and K8
    with the accumulator (multi-limb profiles with K7/K8's ``nd`` limbs).
    The TPU's ``tb``/``tn`` tiling arguments are not ported.

    bands:   (n_lwe, 2, 2L, 2N) int32 K2 bands (cuda_t.pack_bsk_band_t).
    ct:      (B, n_lwe+1) int32 words.
    testvec: (2, N) or (B, 2, N) int32 words.
    plain:   run the kernels' plain versions on any device.
    Returns (B, 2, N) int32 TRLWE accumulators.
    """
    return rotate("blind_rotate_tpu", p, bands, ct, testvec, plain=plain)
