"""Blind rotation — the bootstrap hot loop, batched over ciphertexts
(port of ``go_tfhe_tpu/ops/blindrotate.py``).

Per input LWE coefficient the accumulator is rotated by the mod-switched
coefficient and CMUXed with the corresponding bootstrapping-key row; the
lwe_n steps are sequential and throughput comes from the batch axis.  One
code path serves both devices: the step kernels (ops/cuda_*.py) run their
plain versions on CPU tensors and the Hopper kernels on CUDA tensors.  At
the small batches where the host's launches would set the pace
(:func:`takes_graph`), :func:`blind_rotate_t` replays its steps from a CUDA
graph.

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

import torch

from ..params import TFHEParams
from ..utils import tracing
from ..utils.torus import TORUS, shr, wrap_i32
from ..utils.tracing import count, span
from .cuda_ext import rotate_decompose_ext, rotate_decompose_ext_ref
from .cuda_ext_t import (extprod_ext_t, extprod_ext_t_ref,
                         rotate_decompose_ext_t, rotate_decompose_ext_t_ref)
from .cuda_extprod import extprod, extprod_ref
from .cuda_rotate import rotate_decompose, rotate_decompose_ref
from .cuda_step import fused_rotate_step, fused_rotate_step_ref
from .cuda_t import (SMALL_BATCH_MAX, band_limb_drop, extprod_t,
                     extprod_t_ref, launch_counts, rotate_decompose_t,
                     rotate_decompose_t_ref)
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

# The rotations that blind_rotate_t ran, and of them those whose steps were
# replayed from a CUDA graph (:func:`takes_graph`).  Always counted, as
# cuda_t.launch_counts are.
rotation_counts = {"rotations": 0, "replayed": 0}


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
    n_lwe = p.lwe_n
    lead = ct.shape[:-1]
    b_tilda = 2 * p.n - mod_switch_2n(ct[..., n_lwe], p, theta)    # (...,)
    acc = monomial_mul(testvec.expand(lead + (2, p.n)), b_tilda[..., None])
    a_tilda = mod_switch_2n(ct[..., :n_lwe], p, theta)          # (..., n_lwe)
    for i in range(n_lwe):
        rotated = monomial_mul(acc, a_tilda[..., i, None])
        acc = cmux(p, bsk_bands[i], acc, rotated)
    return acc


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
    n_lwe, k = p.lwe_n, p.poly_extend_factor
    big = 2 * k * p.n
    lead = ct.shape[:-1]
    b_tilda = big - mod_switch_general(ct[..., n_lwe], big)
    acc = monomial_mul_blocks(lut_blocks.expand(lead + (k, 2, p.n)),
                              b_tilda, k)
    a_tilda = mod_switch_general(ct[..., :n_lwe], big)         # (..., n_lwe)
    for i in range(n_lwe):
        rotated = monomial_mul_blocks(acc, a_tilda[..., i], k)
        # block-wise CMUX: k is one more batch axis of the contraction
        acc = acc + external_product(p, bsk_bands[i], rotated - acc)
    return acc


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
    bs, l2 = p.block_size, 2 * p.l
    full, rem = divmod(p.lwe_n, bs)
    lead = ct.shape[:-1]
    b_tilda = 2 * p.n - mod_switch_2n(ct[..., p.lwe_n], p)
    acc = monomial_mul(testvec.expand(lead + (2, p.n)), b_tilda[..., None])
    a_tilda = mod_switch_2n(ct[..., :p.lwe_n], p)              # (..., n_lwe)
    a_blk = a_tilda[..., :full * bs].reshape(lead + (full, bs))
    band_blk = bsk_bands[:full * bs].reshape(full, bs * l2, 2, 2 * p.n)
    for i in range(full):
        rotated = monomial_mul(acc[..., None, :, :], a_blk[..., i, :, None])
        diff = rotated - acc[..., None, :, :]                  # (...,bs,2,N)
        digits = gadget_decompose(diff, p).reshape(lead + (bs * l2, p.n))
        acc = acc + negacyclic_extprod_toeplitz(digits, band_blk[i])
    for idx in range(full * bs, full * bs + rem):      # ragged tail, per bit
        rotated = monomial_mul(acc, a_tilda[..., idx, None])
        acc = cmux(p, bsk_bands[idx], acc, rotated)
    return acc


def blind_rotate_t(p: TFHEParams, bands: torch.Tensor, ct: torch.Tensor,
                   testvec: torch.Tensor, theta: int = 0,
                   plain: bool = False) -> torch.Tensor:
    """Blind-rotate a batch of LWE ciphertexts.

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
    rotate_decompose = rotate_decompose_t_ref if plain else rotate_decompose_t
    extprod = extprod_t_ref if plain else extprod_t
    n_lwe = p.lwe_n
    b = ct.shape[0]
    b_tilda = 2 * p.n - mod_switch_2n(ct[:, n_lwe], p, theta)      # (B,)
    tv = testvec.expand(b, 2, p.n)
    acc = monomial_mul(tv, b_tilda[:, None]).permute(1, 2, 0)      # (2, N, B)
    a_tilda = mod_switch_2n(ct[:, :n_lwe], p, theta).t()           # (n_lwe, B)
    graphed = takes_graph(ct.device, b, plain)
    graphs = _graphs_of(bands) if graphed else {}
    shape = _graph_shape(p, b, ct.device)
    if shape in graphs:
        out = graphs[shape].run(acc, a_tilda)
        rotation_counts["replayed"] += 1
    else:
        acc = _steps(p, bands, acc.contiguous(), a_tilda.contiguous(),
                     rotate_decompose, extprod)
        out = acc.permute(2, 0, 1).contiguous()                    # (B, 2, N)
        if graphed:
            # The eager rotation was the kernels' first use at this batch
            # (their first launches, attribute calls and K2's shape rule),
            # so the capture meets none of them.
            graphs[shape] = _StepGraph(p, bands, b, ct.device)
    rotation_counts["rotations"] += 1
    return out


def _steps(p: TFHEParams, bands: torch.Tensor, acc: torch.Tensor,
           a_tilda: torch.Tensor, rotate_decompose=rotate_decompose_t,
           extprod=extprod_t) -> torch.Tensor:
    """blind_rotate_t's n_lwe steps on the (2, N, B) accumulator: K1, then
    K2 with the step's band."""
    nd, lo = p.digit_limbs, band_limb_drop(p)
    for i in range(p.lwe_n):
        digits = rotate_decompose(p, acc, a_tilda[i])
        acc = extprod(digits, bands[i], acc, nd, lo)
    return acc


def takes_graph(device: torch.device, b: int, plain: bool = False) -> bool:
    """Whether blind_rotate_t replays its steps from a CUDA graph: the
    kernels on a card (not their plain versions) at a batch of at most
    cuda_t.SMALL_BATCH_MAX, where the host's two launches a step take
    longer than the card's two kernels (PERF.md, §5)."""
    return not plain and device.type == "cuda" and b <= SMALL_BATCH_MAX


# id(bands) -> (a weak reference to them, {_graph_shape: _StepGraph}).  The
# reference's callback drops the entry when the bands go, so that no replay
# outlives the bands it reads and freeing a key frees its graphs.
_graphs: dict = {}


def _graphs_of(bands: torch.Tensor) -> dict:
    """The step graphs captured over ``bands``."""
    entry = _graphs.get(id(bands))
    if entry is None or entry[0]() is not bands:
        key = id(bands)
        entry = _graphs[key] = (
            weakref.ref(bands, lambda _, key=key: _graphs.pop(key, None)), {})
    return entry[1]


def _graph_shape(p: TFHEParams, b: int, device: torch.device) -> tuple:
    """What a step graph's launches depend on, besides its bands."""
    return (device.index, b, p.n, 2 * p.l, p.digit_limbs, band_limb_drop(p),
            p.lwe_n, p.bgbit, p.decomposition_offset)


class _StepGraph:
    """blind_rotate_t's n_lwe steps at one batch, captured once in a CUDA
    graph: the same K1 and K2 launches with the same arguments, in the same
    order, as the eager loop (:func:`_steps`).

    The graph reads its own input buffers, ``acc`` (2, N, B) and
    ``a_tilda`` (n_lwe, B), which :meth:`run` fills, and writes ``out`` in
    its private pool, which also holds the steps' digits and accumulators
    (a few of each, reused within the capture).  It holds no reference to
    the bands: :func:`_graphs_of` drops it with them.  A replay runs on the
    caller's current stream; calls on two streams must not overlap, since
    they share the buffers."""

    def __init__(self, p: TFHEParams, bands: torch.Tensor, b: int,
                 device: torch.device):
        self.acc = torch.zeros((2, p.n, b), dtype=TORUS, device=device)
        self.a_tilda = torch.zeros((p.lwe_n, b), dtype=torch.int32,
                                   device=device)
        before = dict(launch_counts)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    self.graph, stream=torch.cuda.Stream(device)):
                self.out = _steps(p, bands, self.acc, self.a_tilda)
        finally:
            # The capture ran nothing: its launches count at each replay.
            self.launches = {name: launch_counts[name] - n
                             for name, n in before.items()
                             if launch_counts[name] != n}
            launch_counts.update(before)

    def run(self, acc: torch.Tensor, a_tilda: torch.Tensor) -> torch.Tensor:
        """The steps from ``acc`` (2, N, B) with amounts ``a_tilda``
        (n_lwe, B), any strides; returns a new (B, 2, N) tensor (never a
        view of ``out``, which the next replay overwrites).  While the
        recorder is on, ``launch.host_ns`` adds the replay's host time."""
        self.acc.copy_(acc)
        self.a_tilda.copy_(a_tilda)
        t0 = time.perf_counter_ns() if tracing.active else 0
        self.graph.replay()
        if t0:
            count("launch.host_ns", time.perf_counter_ns() - t0)
        for name, n in self.launches.items():
            launch_counts[name] += n
        return self.out.permute(2, 0, 1).clone(
            memory_format=torch.contiguous_format)


def blind_rotate_extended_t(p: TFHEParams, bands: torch.Tensor,
                            ct: torch.Tensor, lut_blocks: torch.Tensor,
                            plain: bool = False) -> torch.Tensor:
    """Blind rotation over an extended look-up table of size k*N
    (``go_tfhe_tpu/ops/blindrotate.py:221-255``).

    bands:      (n_lwe, 2, 2L, 2N) int32 K2 bands; every block contracts
                against the same band.
    ct:         (B, n_lwe+1) int32 words.
    lut_blocks: (k, 2, N) or (B, k, 2, N) int32 trivial TRLWE blocks.
    plain:      run the kernels' plain versions on any device.
    Returns (B, k, 2, N); the bootstrap reads block 0 at index 0.
    """
    rotate_decompose = (rotate_decompose_ext_t_ref if plain
                        else rotate_decompose_ext_t)
    extprod = extprod_ext_t_ref if plain else extprod_ext_t
    n_lwe, k, n, nd = p.lwe_n, p.poly_extend_factor, p.n, p.digit_limbs
    lo = band_limb_drop(p)
    big = 2 * k * n
    b = ct.shape[0]
    with span("rotation.ext_blocks", ct.device):
        b_tilda = big - mod_switch_general(ct[:, n_lwe], big)       # (B,)
        acc = monomial_mul_blocks(lut_blocks.expand(b, k, 2, n), b_tilda, k)
        # (B, k, 2, N) -> (2, k*N, B): block r in rows [rN, (r+1)N)
        acc = acc.permute(2, 1, 3, 0).reshape(2, k * n, b).contiguous()
        a_tilda = mod_switch_general(ct[:, :n_lwe], big).t().contiguous()
    count("rotation.block_rows", b * k)
    for i in range(n_lwe):
        digits = rotate_decompose(p, acc, a_tilda[i])
        acc = extprod(digits, bands[i], acc, k, nd, lo)
    return acc.reshape(2, k, n, b).permute(3, 1, 0, 2).contiguous()


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
    rotate_decompose_e = (rotate_decompose_ext_ref if plain
                          else rotate_decompose_ext)
    contract = extprod_ref if plain else extprod
    n_lwe, k, n, nd = p.lwe_n, p.poly_extend_factor, p.n, p.digit_limbs
    lo = band_limb_drop(p)
    big = 2 * k * n
    b = ct.shape[0]
    with span("rotation.ext_blocks", ct.device):
        b_tilda = big - mod_switch_general(ct[:, n_lwe], big)       # (B,)
        acc = monomial_mul_blocks(lut_blocks.expand(b, k, 2, n), b_tilda, k)
        # (B, k, 2, N) -> (2, B, k*N): block r in columns [rN, (r+1)N)
        acc = acc.permute(2, 0, 1, 3).reshape(2, b, k * n).contiguous()
        a_tilda = mod_switch_general(ct[:, :n_lwe], big).t().contiguous()
    count("rotation.block_rows", b * k)
    for i in range(n_lwe):
        digits = rotate_decompose_e(p, acc, a_tilda[i])
        acc = contract(digits.view(b * k, -1), bands[i],
                       acc.view(2, b * k, n), nd, lo).view(2, b, k * n)
    return acc.view(2, b, k, n).permute(1, 2, 0, 3).contiguous()


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
    rotate = rotate_decompose_ref if plain else rotate_decompose
    contract = extprod_ref if plain else extprod
    n_lwe, bs, nd = p.lwe_n, p.block_size, p.digit_limbs
    lo = band_limb_drop(p)
    full, rem = divmod(n_lwe, bs)
    b = ct.shape[0]
    b_tilda = 2 * p.n - mod_switch_2n(ct[:, n_lwe], p)             # (B,)
    acc = monomial_mul(testvec.expand(b, 2, p.n), b_tilda[:, None])
    acc = acc.transpose(0, 1).contiguous()                          # (2, B, N)
    a_tilda = mod_switch_2n(ct[:, :n_lwe], p).t().contiguous()      # (n_lwe, B)
    a_blk = a_tilda[:full * bs].view(full, bs, b)
    band_blk = block_bands(p, bands)
    for i in range(full):
        digits = rotate(p, acc, a_blk[i])
        acc = contract(digits, band_blk[i], acc, nd, lo)
    for idx in range(full * bs, n_lwe):                # ragged tail, per bit
        digits = rotate(p, acc, a_tilda[idx])
        acc = contract(digits, bands[idx], acc, nd, lo)
    return acc.transpose(0, 1).contiguous()                         # (B, 2, N)


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
    step = fused_rotate_step_ref if plain else fused_rotate_step
    rotate = rotate_decompose_ref if plain else rotate_decompose
    contract = extprod_ref if plain else extprod
    n_lwe, nd, lo = p.lwe_n, p.digit_limbs, band_limb_drop(p)
    int8_ok = 2 * p.l * p.n * min(p.half_bg, 128) * 128 < 1 << 31
    fused = FUSED_STEP and p.digits_fit_int8 and int8_ok
    b = ct.shape[0]
    b_tilda = 2 * p.n - mod_switch_2n(ct[:, n_lwe], p)             # (B,)
    acc = monomial_mul(testvec.expand(b, 2, p.n), b_tilda[:, None])
    acc = acc.transpose(0, 1).contiguous()                          # (2, B, N)
    a_tilda = mod_switch_2n(ct[:, :n_lwe], p).t().contiguous()     # (n_lwe, B)
    for i in range(n_lwe):
        if fused:
            acc = step(p, acc, a_tilda[i], bands[i])
        else:
            acc = contract(rotate(p, acc, a_tilda[i]), bands[i], acc, nd,
                           lo)
    return acc.transpose(0, 1).contiguous()                         # (B, 2, N)
