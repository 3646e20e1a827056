"""Smoke run of go_tfhe_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed S]

Drives the port's paths once each, at full crypto parameters, through the
entry points a user calls:

* the gate bootstrap at ``128bit_fast`` (lwe_n 700, N 1024): keygen on
  the card, ``gates.NAND`` on a batch of 4096 bit pairs through
  ``engine.bootstrap`` (kernels K1 + K2), truth table, phase-noise margin,
  launch counts, a first, two steady and a one-gate batch, and 32 gates
  against the plain versions;
* ``gates.AND_OR`` (the many-LUT bootstrap) on the same keys, batch 4096:
  both truth tables, margins, launches, 32 pairs against the plain path;
* programmable bootstrapping with extended look-up tables through
  ``lut.bootstrap_func`` (kernels K4 + K5): ``uint6_centered`` (lwe_n
  1071, N 2048, k 2) at batch 2048 with keygen on the card, a first and a
  steady batch, margins, launches and 8 ciphertexts against the plain
  path; ``uint7_centered`` (lwe_n 1160, k 4) at batch 256;
* ``uint8_centered`` (lwe_n 1160, k 9: 256 messages) at batch 256 through
  ``lut.bootstrap_func``, on the row-major extended rotation (kernels K6 +
  K8), with the same checks;
* the block blind rotation: a block-binary key made on the card at
  ``128bit_fast`` (block_size 3), ``gates.NAND`` on 4096 bit pairs with
  ``engine.PREFER_BLOCK_ROTATION`` set (kernels K7 + K8, 234 steps), and
  the same keys with the flag off (K1 + K2, 700 steps);
* the per-bit routes beside K1 + K2, on the first keys, ``gates.NAND`` on
  4096 bit pairs each: a key with ``transposed=False`` through
  ``blind_rotate_tpu`` with ``blindrotate.FUSED_STEP`` set (the fused step
  K3, 700 launches) and unset (K7 + K8, 700 each), and
  ``engine.PREFER_PIPE`` through ``blind_rotate_pipe`` (one K1, then 1400
  K9 half-batch steps), with K1 + K2 timed again in the same phase;
* the circuit library on the first keys, batch 4096: ``gates.NOT``,
  ``COPY`` and ``constant`` (no bootstrap), ``gates.MUX`` on the 8 (sel,
  then, else) combinations (two bootstraps without key switch, one key
  switch), ``MUX_3GATE``, 8-bit ``models.adders.ripple_carry_add`` (40
  gate bootstraps) and ``ripple_add_manylut`` (8 many-LUT bootstraps);
* ``uint5`` (lwe_n 1071, N 2048, three digit limbs; K1 + K2): keygen on
  the card, ``adders.add8_pbs`` on 2048 pairs of 8-bit numbers (3
  programmable bootstraps; at most the profile's own rate of wrong sums,
  each held against the plain path) and
  ``models.comparators.ge``/``lt``/``eq`` on every pair of [0, 16)^2,
  tiled to 2048;
* proxy re-encryption at ``128bit_fast``'s level 0 (no kernel: the key
  switch's digit contraction): keys made on the card, symmetric and
  asymmetric re-encryption of 4096 bits and a 3-hop chain, the card's
  words against the CPU's;
* the batch-sharded bootstrap (``parallel``) on the first NAND batch: a
  mesh of every card and a mesh naming the card 4 times (shards of 1024),
  each equal to the unsharded words with 700 K1/K2 launches a shard,
  ``sharded_bootstrap_cuda`` without the key switch, and with two cards
  or more a shard on the last card while card 0 is current;
* the cost model (``utils.profiling``) at ``128bit_fast``: speed of light
  and utilization of the measured NAND rate (0 < mfu <= 1), the key's
  memory, and a warm NAND batch under ``trace`` whose Chrome trace names
  K1 and K2;
* the five example programs (``examples/torch_*.py``) through their
  ``main`` at full profiles (``128bit_fast``; ``uint5`` for the PBS and
  the nibble adder), each right with its exact K1/K2 launches;
* ``128bit`` (``bench.py --exact``: bgbit 6, l 3, no key limb dropped):
  keys made on the card, ``gates.NAND`` on the 4096 bit pairs through K1
  + K2 (700 each) and route (c) (1 K1 + 1400 K9 at l 3), the two routes'
  words equal;
* the portable path (the JAX package's off-TPU cores, no kernel) on the
  earlier phases' keys and inputs, through ``engine._bootstrap``'s
  portable routes: phase 5's NAND batch (``blind_rotate``), phase 11's
  block-binary NAND batch (``blind_rotate_block_portable``), the first
  256 of phase 8's uint6 batch (``blind_rotate_extended``) and phase 7's
  AND_OR batch (``bootstrap_many`` on ``blind_rotate``), each output equal
  to its phase's words with no kernel launched; one portable step
  (``ops.external_product``), ``negacyclic_extprod_i8`` (``_int_mm``) and
  the Nussbaumer product at batch 64 timed beside K2, the last two equal
  to the dense product;
* the measuring entry points (``bench_torch.py`` plain, ``--exact``,
  ``--block``, ``--pipe`` and ``--selftest-guard``, which must exit 1;
  ``tools/torch_bench_profiles.py`` at ``80bit_fast``/``110bit_fast``,
  the three noise tools, ``tools/torch_bench_ext.py`` at the floor and
  centered uint6/7/8, ``bench_micro_torch.py``, ``bench_scaling_torch.py``)
  through their ``main`` at full profiles, each with its exact launches
  and JSON records naming the card; the new configurations' outputs
  (80/110bit_fast, floor uint6/7/8, many-LUT theta 0-2) against the plain
  path, and ``128bit_fast`` with no key limb dropped (K2 at lo 0), whose
  words must equal ``128bit_fast``'s on the same keys.

Before that it builds the nine Hopper kernels from
``go_tfhe_tpu_torch/csrc/`` and holds each against its plain PyTorch
version (tolerance 0) at the paths' shapes, wide-digit shapes, ragged
batches, the edge rotation amounts and (K2, K5, K8, K3) extreme operands,
and times each (CUDA events; K1, K4, K6 and K7, whose calls are about as
short as their host launch cost, replayed from a CUDA graph, with their
eager loop beside it; K9 also without its Y half, beside K1 alone on
that half, and its blocks an SM at the tile's and the launch's shared
memory), K2, K5 and K8 beside their library form (``torch._int_mm`` on
int8 Toeplitz key limbs, ``library_ms``).
Each path runs with the launch counters set to 0 just before it and read
just after.

Any failed check raises, so the script exits non-zero and prints no
result.  It needs a CUDA device: there is no CPU run.  On success its last
three lines are a JSON object of the entry points' records
(``"entry_points"``), one describing each kernel and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from go_tfhe_tpu_torch import (bitutils, cipher, engine, gates, keys, lut,
                               parallel, params, proxyreenc)
from go_tfhe_tpu_torch.experimental import nussbaumer
from go_tfhe_tpu_torch.models import adders, comparators
from go_tfhe_tpu_torch.ops import (_build, blindrotate, cuda_ext, cuda_ext_t,
                                   cuda_extprod, cuda_pipe, cuda_rotate,
                                   cuda_step, cuda_t, decompose, extprod,
                                   polymul)
from go_tfhe_tpu_torch.ops.blindrotate import block_bands
from go_tfhe_tpu_torch.utils import benchmarking, profiling, tracing
from go_tfhe_tpu_torch.utils.torus import f64_to_torus, wrap_i32
from rotdec_times import graph_ms

BATCH = 4096
PLAIN_CHECK = 32
MARGIN = 2 ** 29          # the boolean decision margin (+-1/8 of the torus)
MIN_SIGMAS = 8.0          # bench.py's phase-margin floor
UINT6_BATCH = 2048
UINT7_BATCH = 256
UINT8_BATCH = 256
PBS_PLAIN_CHECK = 8
U5 = params.UINT5
U5_BATCH = 2048
# The uint5 PBS's margin guard.  The profile's design margin is 5.1 sigma
# (the JAX package's NOISE_PBS_r05.json: std 2^22.64 against the 2^25
# half-segment, 0 wrong of 1024), so the 8 sigma floor cannot hold there;
# 4.5 sigma leaves room for sampling noise on a batch of 2048.
U5_MIN_SIGMAS = 4.5
# add8_pbs's wrong sums.  Its third PBS's input (a_hi + b_hi + a
# bootstrapped carry) lies about 3.4 sigma inside its half-segment, so the
# profile itself (JAX's add8_pbs, word for word) decrypts some sums wrong.
# Measured on the card (NVIDIA H100 80GB HBM3, 700 W) over 16 draws of
# uint5 keys and 2048 input pairs, seeds 1-16: the wrong sums of each draw
# (U5_DRAW_WRONG, 29 of 32768) and the third input's std after the mod
# switch (2^23.20 to 2^23.31).  U5_MAX_WRONG is the smallest W with
# P(Binomial(U5_BATCH, p) > W) < 1e-6, p the one-sided upper 95%
# (Clopper-Pearson) limit of the measured rate per sum, 1.21e-3; the std
# ceiling is the draws' largest plus 0.1 in log2.  The two bounds
# disagree: the counts are overdispersed (variance 3.63 against a
# mean of 1.81) because the rate follows the key's std, and a key at the
# ceiling (3.0 sigma of the half-segment, 2.6e-3 to 2.9e-3 wrong a sum)
# would pass more than 13 wrong sums with a probability of 1e-3 to 3e-3.
# W holds at 1e-6 only up to the draws' largest std, 2^23.31; a key
# between that and the ceiling that fails W shows this tail (PERF.md §7).
U5_DRAW_WRONG = (0, 3, 1, 0, 1, 4, 1, 7, 0, 3, 3, 1, 0, 1, 1, 3)
U5_MAX_WRONG = 13
U5_PBS3_STD_LOG2_MAX = 23.41
# The many-LUT bootstrap at theta 1 measured 8.2 sigma against the mod-8
# half-segment 2^27 (NOISE_MANY_r05.json); with that mean, 8 sigma would
# fail on sampling noise alone.
MANY_LUT_MIN_SIGMAS = 7.5
PROXY_BATCH = 4096
PROXY_CPU_CHECK = 1024
# The asymmetric re-encryption key's design margin at 128bit_fast: each
# table word carries the noise of ~lwe_n public-key zero-encryptions
# (sqrt(700) x 2^16.4), and a re-encryption sums ~3/4 of lwe_n * t = 6300
# table words, std ~2^27.2 against the 2^29 margin: about 3.5-3.9 sigma,
# so about 1e-4 of the outputs decrypt wrong by design (the reference's
# own tests ask for 90%, proxyreenc/proxyreenc_test.go:109-138).  The
# guard holds the margin to the design and the wrong outputs to 0.1%.
ASYM_MIN_SIGMAS = 3.5
ASYM_MAX_WRONG = PROXY_BATCH // 1000
T_EIGHTH = int(f64_to_torus(0.125))
K1K2 = ("rotate_decompose_t", "extprod_t")
K4K5 = ("rotate_decompose_ext_t", "extprod_ext_t")
K6K8 = ("rotate_decompose_ext", "extprod")
K7K8 = ("rotate_decompose", "extprod")
PIPE_HALF = BATCH // 2
# The per-bit routes of phase 12 (per_bit_routes_phase).
ROUTES = ("k1k2", "a_fused_k3", "b_k7k8", "c_pipe_k9")
PROFILE = False           # set by --profile
# Phase 20, the portable path: the first UINT6_PORTABLE ciphertexts of
# phase 8's batch, and the Nussbaumer product's batch.
UINT6_PORTABLE = 256
NUSS_BATCH = 64
# H100 SXM dense FP64 tensor-core peak (NVIDIA's data sheet), the floor of
# the portable step's three float64 products.
FP64_TFLOPS = 67.0
# H100 SXM INT32 multiply-adds a second: 132 SMs x 64 lanes a clock at the
# 1.98 GHz boost, the floor of K2's small form (exact u32 products).
INT32_TMACS = 132 * 64 * 1.98e9 / 1e12
MESH_COPIES = 4
# The five example programs (examples/torch_*.py) at the full profiles
# their docstrings name for a real run, and the K1 and K2 launches of each:
# 8 gate bootstraps (6 gates and MUX's 2) x 700 steps; 7 PBS x 1071; 3 PBS
# x 1071 + 40 gate bootstraps x 700; 8 many-LUT bootstraps x 700; none.
# Their batches (4, or uint5's 32 messages) all take K2's small form.
# Phase 21, the measuring entry points: each run's (label, script, argv,
# exit code, the kernel launches of the whole run as {kernel: count}, the
# measuring core whose calls are held against the plain path as (module,
# function, kind), or None).  A core's kind says what its call computes:
# "nand" a NAND batch, "many" a many-LUT bootstrap at theta, "identity" and
# "plus_one" a PBS of the table x -> x or x -> x+1 mod m.
# Launches: bench_torch and torch_bench_profiles run a checked batch and
# 5 timed ones; torch_bench_ext a first batch and 2 timed ones a profile
# (its portable batches launch nothing); bench_micro_torch 5 + 2 x 4 + 4
# gate bootstraps (first batch and timed loop, latency at batch 1 and
# 128, the 128bit_fast rows; the 4 at batch 1 take K2's small form) and
# 3 + 1 uint5 PBS; bench_scaling_torch a
# warm and 3 timed batches; --selftest-guard stops after its first batch.
ENTRY_PORTABLE_BATCH = 16
ENTRY_PLAIN_CHECK = 4


def _n(name: str) -> int:
    return params.get_params(name).lwe_n


def _launches(kernels: tuple, count: int, **more) -> dict:
    return {**dict.fromkeys(kernels, count), **more}


def entry_runs() -> tuple:
    fast, exact = _n("128bit_fast"), _n("128bit")
    block = -(-fast // params.P128_FAST.block_size)
    ext = ("--batch", "256", "--portable-batch", str(ENTRY_PORTABLE_BATCH))
    return (
        ("bench", "bench_torch.py", [], 0, _launches(K1K2, 6 * fast), None),
        ("bench_exact", "bench_torch.py", ["--exact"], 0,
         _launches(K1K2, 6 * exact), None),
        ("bench_block", "bench_torch.py", ["--block"], 0,
         _launches(K7K8, 6 * block), None),
        ("bench_pipe", "bench_torch.py", ["--pipe"], 0,
         {"rotate_decompose_t": 6, "pipe_step": 6 * 2 * fast}, None),
        ("bench_selftest_guard", "bench_torch.py", ["--selftest-guard"], 1,
         _launches(K1K2, fast), None),
        ("bench_profiles", "tools/torch_bench_profiles.py", [], 0,
         _launches(K1K2, 6 * (_n("80bit_fast") + _n("110bit_fast"))),
         ("bench_torch", "measure", "nand")),
        ("noise_margin", "tools/torch_noise_margin.py", [], 0,
         _launches(K1K2, 2 * fast + _n("80bit_fast")), None),
        ("noise_margin_pbs", "tools/torch_noise_margin_pbs.py", [], 0,
         _launches(K4K5, 2 * _n("uint6")), ("torch_noise_margin_pbs",
                                            "measure", "identity")),
        ("noise_many", "tools/torch_noise_many.py", [], 0,
         _launches(K1K2, 3 * fast), ("torch_noise_many", "measure", "many")),
        ("bench_ext_uint6", "tools/torch_bench_ext.py",
         ["--profiles", "uint6,uint6_centered", "--batch", "2048",
          "--portable-batch", str(ENTRY_PORTABLE_BATCH)], 0,
         _launches(K4K5, 6 * _n("uint6")),
         ("torch_bench_ext", "accuracy", "plus_one")),
        ("bench_ext_uint7", "tools/torch_bench_ext.py",
         ["--profiles", "uint7,uint7_centered", *ext], 0,
         _launches(K4K5, 6 * _n("uint7")),
         ("torch_bench_ext", "accuracy", "plus_one")),
        ("bench_ext_uint8", "tools/torch_bench_ext.py",
         ["--profiles", "uint8,uint8_centered", *ext], 0,
         _launches(K6K8, 6 * _n("uint8")),
         ("torch_bench_ext", "accuracy", "plus_one")),
        ("bench_micro", "bench_micro_torch.py", [], 0,
         _launches(K1K2, 17 * exact + 4 * _n("uint5"),
                   extprod_t_small=4 * exact), None),
        ("bench_scaling", "bench_scaling_torch.py", [], 0,
         _launches(K1K2, 4 * exact), None),
    )


EXAMPLES = (
    ("torch_simple_gates", ["--profile", "128bit_fast"], 8 * 700),
    ("torch_programmable_bootstrap", ["--profile", "uint5"], 7 * 1071),
    ("torch_add_two_numbers", ["--profile", "uint5", "--bool-profile",
                               "128bit_fast"], 3 * 1071 + 40 * 700),
    ("torch_manylut_adder", ["--profile", "128bit_fast"], 8 * 700),
    ("torch_proxy_reencryption", ["--profile", "128bit_fast"], 0),
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float, what: str = "") -> float:
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"   {what}{dt:.3f} s", flush=True)
    return dt


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int) -> float:
    """Mean device time of one fn() call after reading a 100 MB buffer,
    which evicts its inputs from the 50 MB L2 (CUDA events around each
    call)."""
    flush = torch.ones(100 << 20, dtype=torch.uint8, device="cuda")
    total = 0.0
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def profile_batch(label: str, fn) -> None:
    """With --profile: one more call of fn (a warm batch of a path) under
    torch.profiler, with the program's recorder on (its spans in the
    trace); prints the wall time, the kernel time by name (self device
    time of the CUDA kernel events) and the device's idle share,
    1 - kernel time / wall."""
    if not PROFILE:
        return
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with tracing.enabled(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    by_name = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        # kernels only: CPU ops repeat their kernels' time, "Command
        # Buffer Full" is the host waiting on a full queue, and the
        # recorder's spans are annotations over kernels
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and e.key != "Command Buffer Full"
                and not getattr(e, "is_user_annotation", False)):
            ms, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (ms + us / 1e3, n + e.count)
    kernel_ms = sum(ms for ms, _ in by_name.values())
    print(f"   profile {label}: wall {wall_ms:.1f} ms, kernels "
          f"{kernel_ms:.1f} ms, idle {1 - kernel_ms / wall_ms:.4f}",
          flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:8]:
        print(f"     {ms:9.1f} ms {n:6d} x  {name[:90]}", flush=True)


def demangle(mangled: str) -> str:
    """The last name of an Itanium-mangled symbol, with its integer
    template arguments: '_ZN..16extprod_t_kernelILi3ELi0EEEv..' ->
    'extprod_t_kernel<3,0>'."""
    i, name = mangled.find("_ZN") + 3, mangled
    while 3 <= i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ",".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v output: source,
    kernel<template arguments>, registers, shared memory, spills."""
    lines, src, name, spill = [], "", "", ""
    for line in log.splitlines():
        if line.startswith("-- "):
            src = line[3:]
        elif "Compiling entry function" in line:
            name, spill = demangle(line.split("'")[1]), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split("Used", 1)[1].strip()
            lines.append(f"{src} {name}: {used}; {spill}")
    return lines


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def check_counts(launches: dict, per_call: dict, calls: int) -> None:
    """Each kernel launched per_call[name] times per bootstrap call, every
    other kernel not at all; ``extprod_t_small``, the K2 launches of the
    small-batch form (a part of ``extprod_t``'s), likewise: a phase at a
    batch of at most ``cuda_t.SMALL_BATCH_MAX`` names it."""
    for name, count in launches.items():
        want = per_call.get(name, 0) * calls
        check(count == want,
              f"{name} launched {count} times, expected {want}")


def kernel_bound(name: str, p, b: int, rows: int = 0) -> tuple:
    """(bound_ms, bound_by) of one call of kernel ``name`` at profile p and
    batch b (each half's for K9; rows: the digit rows of a K7/K8 step, 2L
    by default): the larger of the bytes it must move (each input read
    once, each output written once) over the H100's HBM3 rate, and its
    int8 tensor-core operations (2 per multiply-add of the cost model's
    ``profiling.limb_pairs``) over the dense int8 peak, both from
    ``profiling.H100_PEAKS``; for K2's small form its u32 multiply-adds
    over the INT32 lanes' rate (INT32_TMACS)."""
    peak = profiling.H100_PEAKS["h100"]
    n, l2, nd, k = p.n, 2 * p.l, p.digit_limbs, p.poly_extend_factor
    rows = rows or l2
    acc = 2 * k * n * b * 4                     # one accumulator, words
    band = 2 * rows * 2 * n * 4
    macs = 0
    if name in ("rotate_decompose_t", "rotate_decompose_ext_t",
                "rotate_decompose_ext", "rotate_decompose"):
        bs = rows // l2
        nbytes = acc + bs * b * 4 + k * nd * rows * n * b
    elif name in ("extprod_t", "extprod_ext_t", "extprod"):
        nbytes = k * nd * rows * n * b + band + 2 * acc
        macs = 2 * k * n * b * rows * n
    elif name == "extprod_t_small":       # u32 multiply-adds on the lanes
        nbytes = nd * rows * n * b + band + 2 * acc
        t_macs = 2 * n * b * rows * n / (INT32_TMACS * 1e12) * 1e3
        t_bytes = nbytes / (peak["hbm_gbps"] * 1e9) * 1e3
        return (t_macs, "operations") if t_macs > t_bytes else (t_bytes,
                                                                "bytes")
    elif name == "fused_rotate_step":
        nbytes = 2 * acc + b * 4 + band
        macs = 2 * n * b * rows * n
    elif name == "pipe_step":             # X: digits, acc in, out; Y: acc,
        nbytes = 2 * nd * rows * n * b + band + 3 * acc + b * 4   # amounts,
        macs = 2 * n * b * rows * n                               # digits
    else:
        raise ValueError(name)
    t_bytes = nbytes / (peak["hbm_gbps"] * 1e9) * 1e3
    ops = 2 * macs * profiling.limb_pairs(p)
    t_ops = ops / (peak["int8_tops"] * 1e12) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def margin_sigmas(phase_words: np.ndarray, ideal: np.ndarray,
                  margin: int) -> tuple:
    """(margin / std, std, max |dev|) of the phase's deviation from the
    ideal encoding, wrapped to a signed 32-bit difference."""
    dev = (phase_words.astype(np.int64) - ideal + 2 ** 31) % 2 ** 32 - 2 ** 31
    std = float(dev.std())
    return margin / std, std, int(np.abs(dev).max())


def library_time(fn, want: torch.Tensor, what: str) -> float:
    """Mean device time of fn(), a kernel's library form (CUDA events),
    after checking that it computes the kernel's function exactly."""
    err = max_abs_err(fn(), want)
    print(f"   {what} library form max|err| {err}", flush=True)
    check(err == 0, f"{what}: the library form disagrees with the plain "
          "version")
    return cuda_ms(fn, 5)


def kernels_against_plain(gen, dev, shape_times):
    """K1 and K2 against their plain versions, exactly (tolerance 0), at
    the main path's shapes, 128bit (l 3), a wide-digit shape (nd 3, N 256),
    the uint4 shape (nd 3, N 2048), the uint5 PBS's (nd 3, N 2048, B
    2048, all 9 limb pairs), ragged batches (B 1, 3, 15, 16, 17, 127, 129,
    2049, 4095; K1's tiles hold 16) with amounts 0, N and 2N among them,
    and, for K2, extreme operands (every digit limb and every key limb
    -128, lo 0 and 1, at B 1 and 256).  K2 takes its small form exactly
    at B <= SMALL_BATCH_MAX (128bit and uint5 B 1, uint5 B 32 among them),
    counted apart as ``extprod_t_small`` and timed in a CUDA graph at
    B 1 (128bit_fast, 128bit, uint5).  K1 is timed in a CUDA graph at
    128bit_fast B 4096, and in ``shape_times`` there in an eager loop and with its input
    evicted from L2, and at 128bit B 4096, uint4 B 2048 and uint5 B 2048;
    K2 and its library form also at uint5 B 2048.  Returns ({kernel: max_abs_err}, {kernel: (ms, plain_ms)}, {kernel:
    library_ms})."""
    wide = params.TFHEParams(
        name="wide_nd3", lwe_n=4, lwe_alpha=1.0 / (1 << 26), n=256,
        lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=1, message_modulus=8)
    fast, exact, u4, u5 = params.P128_FAST, params.P128, params.UINT4, U5
    cases = [(fast, BATCH), (exact, BATCH), (wide, 256), (u4, 2048),
             (u5, U5_BATCH), (fast, 1), (fast, 3), (fast, 15), (fast, 16),
             (fast, 17), (fast, 127), (fast, 129), (u4, 2049),
             (fast, BATCH - 1), (exact, 1), (u5, 1),
             (u5, cuda_t.SMALL_BATCH_MAX)]
    errs = dict.fromkeys(cuda_t.launch_counts, 0)
    times, lib = {}, {}
    for p, b in cases:
        n, nd = p.n, p.digit_limbs
        lo = cuda_t.band_limb_drop(p)
        acc = torch.randint(-2 ** 31, 2 ** 31, (2, n, b), dtype=torch.int32,
                            device=dev, generator=gen)
        amounts = torch.randint(0, 2 * n + 1, (b,), dtype=torch.int32,
                                device=dev, generator=gen)
        amounts[: min(b, 3)] = torch.tensor([2 * n, 0, n][: min(b, 3)],
                                            dtype=torch.int32, device=dev)
        bsk = torch.randint(-2 ** 31, 2 ** 31, (1, 2 * p.l, 2, n),
                            dtype=torch.int32, device=dev, generator=gen)
        if p.key_grid_bits:
            bsk &= ~((1 << p.key_grid_bits) - 1)
        band = cuda_t.pack_bsk_band_t(bsk, lo)[0].contiguous()

        d_k = cuda_t.rotate_decompose_t(p, acc, amounts)
        d_p = cuda_t.rotate_decompose_t_ref(p, acc, amounts)
        k2, o_k = k2_form(lambda: cuda_t.extprod_t(d_p, band, acc, nd, lo),
                          b, f"{p.name} B={b}")
        o_p = cuda_t.extprod_t_ref(d_p, band, acc, nd, lo)
        torch.cuda.synchronize()
        e1, e2 = max_abs_err(d_k, d_p), max_abs_err(o_k, o_p)
        print(f"   {p.name:12s} B={b:5d}  K1 max|err| {e1}  K2 ({k2}) "
              f"max|err| {e2}", flush=True)
        check(e1 == 0 and e2 == 0,
              f"kernel disagrees with its plain version at {p.name} B={b}")
        errs["rotate_decompose_t"] = max(errs["rotate_decompose_t"], e1)
        errs[k2] = max(errs[k2], e2)
        if k2 == "extprod_t_small" and b == 1:    # a chain's K2
            ms = graph_ms(lambda: cuda_t.extprod_t(d_p, band, acc, nd, lo),
                          100)
            plain_ms = cuda_ms(lambda: cuda_t.extprod_t_ref(
                d_p, band, acc, nd, lo), 3)
            print(f"   {k2}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"per call ({p.name}, B=1, graph)", flush=True)
            if p is exact:
                times[k2] = (ms, plain_ms)
            else:
                shape_times[f"{k2} {p.name} B=1"] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": None}
        k1 = lambda: cuda_t.rotate_decompose_t(p, acc, amounts)
        k1_plain_ms = lambda: cuda_ms(
            lambda: cuda_t.rotate_decompose_t_ref(p, acc, amounts), 3)
        if p is fast and b == BATCH:
            times["rotate_decompose_t"] = (graph_ms(k1, 20), k1_plain_ms())
            for what, ms in (("eager loop", cuda_ms(k1, 20)),
                             ("L2 evicted", cold_ms(k1, 10))):
                shape_times[f"rotate_decompose_t {p.name} B={b}, {what}"] = {
                    "ms": ms, "plain_ms": times["rotate_decompose_t"][1],
                    "library_ms": None}
            times["extprod_t"] = (
                cuda_ms(lambda: cuda_t.extprod_t(d_p, band, acc, nd, lo), 20),
                cuda_ms(lambda: cuda_t.extprod_t_ref(d_p, band, acc, nd, lo),
                        3))
            lib["extprod_t"] = library_time(
                lambda: cuda_t.extprod_t_mm(d_p, band, acc, nd, lo), o_p,
                "extprod_t")
            key = cuda_t.toeplitz_limbs_i8(band, lo)
            gemm_ms = cuda_ms(lambda: cuda_t.extprod_t_mm(
                d_p, band, acc, nd, lo, key=key), 5)
            print(f"   extprod_t library form {lib['extprod_t']:.4f} ms per "
                  f"call, {gemm_ms:.4f} ms with its Toeplitz limbs built",
                  flush=True)
        elif (p is exact and b == BATCH) or (p is u4 and b == 2048):
            shape_times[f"rotate_decompose_t {p.name} B={b}"] = {
                "ms": graph_ms(k1, 20), "plain_ms": k1_plain_ms(),
                "library_ms": None}
        elif p is u5 and b == U5_BATCH:      # the uint5 PBS's K1 and K2
            shape_times[f"rotate_decompose_t {p.name} B={b}"] = {
                "ms": graph_ms(k1, 20), "plain_ms": k1_plain_ms(),
                "library_ms": None}
            shape_times[f"extprod_t {p.name} B={b}"] = {
                "ms": cuda_ms(lambda: cuda_t.extprod_t(d_p, band, acc, nd,
                                                       lo), 10),
                "plain_ms": cuda_ms(lambda: cuda_t.extprod_t_ref(
                    d_p, band, acc, nd, lo), 3),
                "library_ms": library_time(lambda: cuda_t.extprod_t_mm(
                    d_p, band, acc, nd, lo), o_p, f"extprod_t {p.name}")}
    for p in (exact, fast):        # lo 0 and 1
        for b in (1, 256):         # the small form and the tile
            k2, e2 = extreme_case(dev, p, b, 1)
            errs[k2] = max(errs[k2], e2)
    for name in K1K2:
        ms, plain_ms = times[name]
        print(f"   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"per call (128bit_fast, B={BATCH})", flush=True)
    return errs, times, lib


def k2_form(fn, b: int, what: str) -> tuple:
    """(the form's counter name, fn()'s output) of one K2 call fn: the
    small form's launches also count under ``extprod_t_small``, and it
    must be taken exactly at B <= SMALL_BATCH_MAX."""
    before = cuda_t.launch_counts["extprod_t_small"]
    out = fn()
    small = cuda_t.launch_counts["extprod_t_small"] > before
    check(small == (b <= cuda_t.SMALL_BATCH_MAX),
          f"K2 at {what} took the {'small form' if small else 'tile'}")
    return ("extprod_t_small" if small else "extprod_t"), out


def extreme_case(dev, p, b: int, k: int) -> tuple:
    """K2 (k = 1) or K5 with every digit limb -128 and every balanced key
    limb -128 (band word 0x7F7F7F80; 0x7F7F8000 with limb 0 dropped): the
    tile's largest s32 sums, and the small form's u32 products, against
    the plain version.  Returns (the kernel's counter name, max|err|)."""
    nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
    band = extreme_band(dev, 2 * p.l, p.n, lo)
    digits = torch.full((k * nd * 2 * p.l * p.n, b), -128, dtype=torch.int8,
                        device=dev)
    acc = torch.zeros((2, k * p.n, b), dtype=torch.int32, device=dev)
    if k == 1:
        name, o_k = k2_form(lambda: cuda_t.extprod_t(digits, band, acc, nd,
                                                     lo), b, p.name)
        o_p = cuda_t.extprod_t_ref(digits, band, acc, nd, lo)
    else:
        name = "extprod_ext_t"
        o_k = cuda_ext_t.extprod_ext_t(digits, band, acc, k, nd, lo)
        o_p = cuda_ext_t.extprod_ext_t_ref(digits, band, acc, k, nd, lo)
    err = max_abs_err(o_k, o_p)
    print(f"   {p.name:14s} B={b:5d}  extreme operands (nd {nd}, lo {lo}): "
          f"K{2 if k == 1 else 5} max|err| {err}", flush=True)
    check(err == 0, f"K{2 if k == 1 else 5} disagrees with its plain version "
          f"on extreme operands at {p.name}")
    return name, err


def ext_kernels_against_plain(gen, dev, errs, times, lib, shape_times):
    """K4 and K5 against their plain versions, exactly (tolerance 0), at
    the extended paths' shapes (uint6 B 2048, uint7 B 256), a k = 3,
    nd = 3 shape at N 256, ragged batches (B 1, 3, 4, 5, 7, 9, 2047: B %
    4 == 0 takes K4's two passes with tiles of 4, other B one pass with
    tiles of 8 at uint6, 4 at uint7, 32 at N 256) and, for K5, extreme
    operands at uint6 widths; the amounts include 0, kN, 2kN - 1 and 2kN.
    K4 is timed in a CUDA graph at uint6 B 2048, and in ``shape_times``
    there in an eager loop and at uint7 B 256.  Adds to ``errs``,
    ``times`` and ``lib`` (K5's library form at uint6 B 2048)."""
    wide = params.TFHEParams(
        name="ext3_nd3", lwe_n=6, lwe_alpha=1.0 / (1 << 28), n=256,
        lv1_alpha=1.0 / (1 << 31), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=1, message_modulus=8, poly_extend_factor=3)
    u6, u7 = params.UINT6_CENTERED, params.UINT7_CENTERED
    cases = [(u6, UINT6_BATCH), (u7, UINT7_BATCH), (wide, 256), (u6, 1),
             (u6, 3), (u6, 4), (u6, 5), (u7, 7), (wide, 9),
             (u6, UINT6_BATCH - 1)]
    for p, b in cases:
        k, n, nd = p.poly_extend_factor, p.n, p.digit_limbs
        big = 2 * k * n
        acc = torch.randint(-2 ** 31, 2 ** 31, (2, k * n, b),
                            dtype=torch.int32, device=dev, generator=gen)
        amounts = torch.randint(0, big + 1, (b,), dtype=torch.int32,
                                device=dev, generator=gen)
        edges = torch.tensor([big, 0, k * n, big - 1], dtype=torch.int32,
                             device=dev)
        amounts[: min(b, 4)] = edges[: min(b, 4)]
        bsk = torch.randint(-2 ** 31, 2 ** 31, (1, 2 * p.l, 2, n),
                            dtype=torch.int32, device=dev, generator=gen)
        lo = cuda_t.band_limb_drop(p)
        band = cuda_t.pack_bsk_band_t(bsk, lo)[0].contiguous()

        d_k = cuda_ext_t.rotate_decompose_ext_t(p, acc, amounts)
        d_p = cuda_ext_t.rotate_decompose_ext_t_ref(p, acc, amounts)
        o_k = cuda_ext_t.extprod_ext_t(d_p, band, acc, k, nd, lo)
        o_p = cuda_ext_t.extprod_ext_t_ref(d_p, band, acc, k, nd, lo)
        torch.cuda.synchronize()
        e4, e5 = max_abs_err(d_k, d_p), max_abs_err(o_k, o_p)
        print(f"   {p.name:14s} B={b:5d}  K4 max|err| {e4}  K5 max|err| {e5}",
              flush=True)
        check(e4 == 0 and e5 == 0,
              f"kernel disagrees with its plain version at {p.name} B={b}")
        errs["rotate_decompose_ext_t"] = max(errs["rotate_decompose_ext_t"],
                                             e4)
        errs["extprod_ext_t"] = max(errs["extprod_ext_t"], e5)
        k4 = lambda: cuda_ext_t.rotate_decompose_ext_t(p, acc, amounts)
        k4_plain_ms = lambda: cuda_ms(
            lambda: cuda_ext_t.rotate_decompose_ext_t_ref(p, acc, amounts), 3)
        if p is u6 and b == UINT6_BATCH:
            times["rotate_decompose_ext_t"] = (graph_ms(k4, 20),
                                               k4_plain_ms())
            shape_times[f"rotate_decompose_ext_t {p.name} B={b}, eager "
                        f"loop"] = {
                "ms": cuda_ms(k4, 20), "plain_ms": times[
                    "rotate_decompose_ext_t"][1], "library_ms": None}
            times["extprod_ext_t"] = (
                cuda_ms(lambda: cuda_ext_t.extprod_ext_t(d_p, band, acc, k,
                                                         nd, lo), 10),
                cuda_ms(lambda: cuda_ext_t.extprod_ext_t_ref(d_p, band, acc,
                                                             k, nd, lo), 3))
            lib["extprod_ext_t"] = library_time(
                lambda: cuda_ext_t.extprod_ext_t_mm(d_p, band, acc, k, nd,
                                                    lo), o_p, "extprod_ext_t")
            print(f"   extprod_ext_t library form "
                  f"{lib['extprod_ext_t']:.4f} ms per call", flush=True)
        elif p is u7 and b == UINT7_BATCH:
            shape_times[f"rotate_decompose_ext_t {p.name} B={b}"] = {
                "ms": graph_ms(k4, 20), "plain_ms": k4_plain_ms(),
                "library_ms": None}
    _, e5 = extreme_case(dev, u6, 256, u6.poly_extend_factor)
    errs["extprod_ext_t"] = max(errs["extprod_ext_t"], e5)
    for name in K4K5:
        ms, plain_ms = times[name]
        print(f"   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"per call ({u6.name}, B={UINT6_BATCH})", flush=True)


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose storage starts 4 bytes past a 16-byte
    boundary (K6/K7 then stage it in 4-byte pieces)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    check(view.data_ptr() % 16 == 4, "the misaligned view is aligned")
    return view


def rowmajor_kernels_against_plain(gen, dev, errs, times, lib):
    """K6, K7 and K8 against their plain versions, exactly (tolerance 0):
    K6 at uint8_centered B 256 and 255 and at k 3 with nd 3 (N 256, B 9,
    and a misaligned accumulator view), amounts 0, kN, 2kN - 1, 2kN among
    them; K7 at 128bit_fast with bs 3 and 1, B 4096 and 4095, at 128bit
    (bgbit 6, l 3) B 1031, at N 128 (test_block, bs 2) B 5 and 1, an nd = 3
    shape, and 128bit_fast bs 3 B 129 on a misaligned view, amounts 0, N,
    2N - 1, 2N among them; K8 on K7's digits (12 rows of a block step, 4 of
    a tail step, lo 1; 18 at 128bit) and on K6's (uint8: B' = 9B, nd 3, 2
    rows, lo 0), and on extreme operands.  K6 and K7 are timed in a CUDA
    graph (their calls are about as short as the host's launch cost), with
    their eager loops beside; K8 and its library form
    (cuda_extprod.extprod_mm, checked exact) at its three shapes.  Adds to
    ``errs``, ``times`` and ``lib`` (K6 at uint8 B 256, K7 and K8 at the
    block step, B 4096) and returns the other shapes' times."""
    wide = params.TFHEParams(
        name="block_nd3", lwe_n=6, lwe_alpha=1.0 / (1 << 26), n=256,
        lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=3, message_modulus=8)
    ext3 = params.TFHEParams(
        name="ext3_nd3", lwe_n=6, lwe_alpha=1.0 / (1 << 28), n=256,
        lv1_alpha=1.0 / (1 << 31), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=1, message_modulus=8, poly_extend_factor=3)
    u8, fast, exact = params.UINT8_CENTERED, params.P128_FAST, params.P128
    small = params.TEST_BLOCK
    extra = {}

    def rand_words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def note(name, e):
        errs[name] = max(errs.get(name, 0), e)

    def k8_library(what, digits, band, acc, nd, lo, want):
        ms = library_time(lambda: cuda_extprod.extprod_mm(
            digits, band, acc, nd, lo), want, f"extprod {what}")
        key = cuda_extprod.key_columns_i8(band, lo, nd)
        built = cuda_ms(lambda: cuda_extprod.extprod_mm(
            digits, band, acc, nd, lo, key=key), 5)
        print(f"   extprod {what} library form {ms:.4f} ms per call, "
              f"{built:.4f} ms with its Toeplitz limbs built", flush=True)
        return ms

    for p, b, skew in ((u8, UINT8_BATCH, False), (u8, UINT8_BATCH - 1, False),
                       (ext3, 9, False), (ext3, 9, True)):
        k, n, nd = p.poly_extend_factor, p.n, p.digit_limbs
        big = 2 * k * n
        acc = rand_words((2, b, k * n))
        t = torch.randint(0, big + 1, (b,), dtype=torch.int32, device=dev,
                          generator=gen)
        edges = torch.tensor([big, 0, k * n, big - 1], dtype=torch.int32,
                             device=dev)[:b]
        t[:len(edges)] = edges
        lo = cuda_t.band_limb_drop(p)
        band = cuda_t.pack_bsk_band_t(rand_words((1, 2 * p.l, 2, n)),
                                      lo)[0]
        d_k = cuda_ext.rotate_decompose_ext(p, misaligned(acc) if skew
                                            else acc, t)
        d_p = cuda_ext.rotate_decompose_ext_ref(p, acc, t)
        digits = d_p.view(b * k, -1)
        acc_f = acc.view(2, b * k, n)
        o_k = cuda_extprod.extprod(digits, band, acc_f, nd, lo)
        o_p = cuda_extprod.extprod_ref(digits, band, acc_f, nd, lo)
        torch.cuda.synchronize()
        e6, e8 = max_abs_err(d_k, d_p), max_abs_err(o_k, o_p)
        print(f"   {p.name:14s} B={b:5d} (B'={b * k}){' misaligned' * skew}  "
              f"K6 max|err| {e6}  K8 max|err| {e8}", flush=True)
        check(e6 == 0 and e8 == 0,
              f"kernel disagrees with its plain version at {p.name} B={b}")
        note("rotate_decompose_ext", e6)
        note("extprod", e8)
        if p is u8 and b == UINT8_BATCH:
            k6 = lambda: cuda_ext.rotate_decompose_ext(u8, acc, t)
            times["rotate_decompose_ext"] = (
                graph_ms(k6, 20),
                cuda_ms(lambda: cuda_ext.rotate_decompose_ext_ref(u8, acc, t),
                        3))
            extra[f"rotate_decompose_ext {u8.name} B={b}, eager loop"] = (
                cuda_ms(k6, 20), times["rotate_decompose_ext"][1], None)
            extra["extprod uint8 B'=2304"] = (
                cuda_ms(lambda: cuda_extprod.extprod(digits, band, acc_f, nd,
                                                     lo), 10),
                cuda_ms(lambda: cuda_extprod.extprod_ref(digits, band, acc_f,
                                                         nd, lo), 3),
                k8_library("uint8 B'=2304", digits, band, acc_f, nd, lo,
                           o_p))

    for p, bs, b, skew in ((fast, 3, BATCH, False), (fast, 3, BATCH - 1, False),
                           (fast, 1, BATCH, False), (fast, 1, BATCH - 1, False),
                           (exact, 3, 1031, False), (small, 2, 5, False),
                           (small, 1, 1, False), (wide, 3, 256, False),
                           (fast, 3, 129, True)):
        n, nd = p.n, p.digit_limbs
        lo = cuda_t.band_limb_drop(p)
        acc = rand_words((2, b, n))
        amounts = torch.randint(0, 2 * n + 1, (bs, b), dtype=torch.int32,
                                device=dev, generator=gen)
        edges = torch.tensor([0, n, 2 * n - 1, 2 * n], dtype=torch.int32,
                             device=dev)[:b]
        amounts[:, :len(edges)] = edges
        bsk = rand_words((bs, 2 * p.l, 2, n))
        if p.key_grid_bits:
            bsk &= ~((1 << p.key_grid_bits) - 1)
        bands = cuda_t.pack_bsk_band_t(bsk, lo)
        band = (block_bands(dataclasses.replace(p, lwe_n=bs, block_size=bs),
                            bands)[0] if bs > 1 else bands[0])
        d_k = cuda_rotate.rotate_decompose(p, misaligned(acc) if skew
                                           else acc, amounts)
        d_p = cuda_rotate.rotate_decompose_ref(p, acc, amounts)
        o_k = cuda_extprod.extprod(d_p, band, acc, nd, lo)
        o_p = cuda_extprod.extprod_ref(d_p, band, acc, nd, lo)
        torch.cuda.synchronize()
        e7, e8 = max_abs_err(d_k, d_p), max_abs_err(o_k, o_p)
        print(f"   {p.name:12s} bs={bs} B={b:5d} ({band.shape[1]:2d} rows)"
              f"{' misaligned' * skew}  K7 max|err| {e7}  K8 max|err| {e8}",
              flush=True)
        check(e7 == 0 and e8 == 0, f"kernel disagrees with its plain "
              f"version at {p.name} bs={bs} B={b}")
        note("rotate_decompose", e7)
        note("extprod", e8)
        if p is fast and b == BATCH:
            k7 = lambda: cuda_rotate.rotate_decompose(p, acc, amounts)
            kt, ke7 = graph_ms(k7, 20), cuda_ms(k7, 20)
            pt = cuda_ms(lambda: cuda_rotate.rotate_decompose_ref(
                p, acc, amounts), 3)
            ke = cuda_ms(lambda: cuda_extprod.extprod(d_p, band, acc, nd, lo),
                         10)
            pe = cuda_ms(lambda: cuda_extprod.extprod_ref(d_p, band, acc, nd,
                                                          lo), 3)
            le = k8_library(f"{band.shape[1]} rows B={b}", d_p, band, acc,
                            nd, lo, o_p)
            extra[f"rotate_decompose bs={bs} B={b}, eager loop"] = (
                ke7, pt, None)
            if bs == 3:
                times["rotate_decompose"], times["extprod"] = (kt, pt), (ke, pe)
                lib["extprod"] = le
            else:
                extra["rotate_decompose bs=1 B=4096"] = (kt, pt, None)
                extra["extprod 4 rows B=4096"] = (ke, pe, le)
    e8 = extreme_rowmajor(dev)
    note("extprod", e8)
    shown = {"rotate_decompose_ext": f"{u8.name}, B={UINT8_BATCH}, graph",
             "rotate_decompose": f"{fast.name}, bs=3, B={BATCH}, graph",
             "extprod": f"{fast.name}, 12 rows, B={BATCH}"}
    for name, where in shown.items():
        ms, plain_ms = times[name]
        print(f"   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
              f"call ({where})", flush=True)
    for name, (ms, plain_ms, _) in extra.items():
        print(f"   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
              f"call", flush=True)
    return {name: {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms}
            for name, (ms, plain_ms, lib_ms) in extra.items()}


def extreme_band(dev, rows: int, n: int, lo: int) -> torch.Tensor:
    """A band (2, rows, 2N) whose balanced key limbs above ``lo`` are all
    -128: word 0x7F7F7F80, or 0x7F7F8000 with limb 0 dropped."""
    return torch.full((2, rows, 2 * n), 0x7F7F8000 if lo else 0x7F7F7F80,
                      dtype=torch.int64, device=dev).to(torch.int32)


def extreme_rowmajor(dev) -> int:
    """K8 with every digit limb -128 and every key limb -128 (the tile's
    largest s32 sums) at the block step's 12 rows (lo 1), 128bit's 18 (lo
    0) and uint8's nd 3 against the plain version.  Returns max|err|."""
    worst = 0
    for p, rows, b in ((params.P128_FAST, 12, 256), (params.P128, 18, 256),
                       (params.UINT8_CENTERED, 2, 256)):
        nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
        band = extreme_band(dev, rows, p.n, lo)
        digits = torch.full((b, nd * rows * p.n), -128, dtype=torch.int8,
                            device=dev)
        acc = torch.zeros((2, b, p.n), dtype=torch.int32, device=dev)
        err = max_abs_err(cuda_extprod.extprod(digits, band, acc, nd, lo),
                          cuda_extprod.extprod_ref(digits, band, acc, nd, lo))
        print(f"   {p.name:14s} B'={b:5d}  extreme operands ({rows} rows, "
              f"nd {nd}, lo {lo}): K8 max|err| {err}", flush=True)
        check(err == 0, f"K8 disagrees with its plain version on extreme "
              f"operands at {p.name}")
        worst = max(worst, err)
    return worst


def extreme_step(dev) -> int:
    """K3 with every digit -128 and every key limb -128, lo 1 and 0, at
    128bit_fast widths, B 256: amounts N, acc = (offset - 1 - s) / 2 (s its
    parity), so that X^N acc - acc + offset = s has no digit bits.  Returns
    max|err| against the plain version."""
    worst = 0
    fast = params.P128_FAST
    for p in (fast, dataclasses.replace(fast, kernel_limb_drop=0)):
        lo, off, b = cuda_t.band_limb_drop(p), p.decomposition_offset, 256
        word = (off - 1 - (off - 1) % 2) // 2
        acc = torch.full((2, b, p.n), word - (word >> 31 << 32),
                         dtype=torch.int32, device=dev)
        amounts = torch.full((b,), p.n, dtype=torch.int32, device=dev)
        band = extreme_band(dev, 2 * p.l, p.n, lo)
        check(int(cuda_rotate.rotate_decompose_ref(p, acc, amounts).max())
              == -p.half_bg, "K3's extreme digits are not all -Bg/2")
        err = max_abs_err(cuda_step.fused_rotate_step(p, acc, amounts, band),
                          cuda_step.fused_rotate_step_ref(p, acc, amounts,
                                                          band))
        print(f"   {p.name:12s} B={b:5d}  extreme operands (lo {lo}): K3 "
              f"max|err| {err}", flush=True)
        check(err == 0, f"K3 disagrees with its plain version on extreme "
              f"operands (lo {lo})")
        worst = max(worst, err)
    return worst


def step_pipe_kernels_against_plain(gen, gen_k9, dev, errs, times):
    """K3 and K9 against their plain versions, exactly (tolerance 0): K3 at
    128bit_fast B 4096 and 4095 and 128bit B 4096, and on extreme operands
    (:func:`extreme_step`); K9 at 128bit_fast and 128bit (l 3) with halves
    of 2048, an odd half of 2047 on either side, ragged and unequal halves
    (17/33, 129/127), and acc_y in a misaligned view (its Y blocks stage
    it in 4-byte copies); amounts 0, N, 2N - 1 and 2N among them.  Prints K9's blocks an SM at the X tile's
    shared memory and at the launch's.  Adds to ``errs`` and ``times`` (K3
    at 128bit_fast B 4096, K9 at halves of 2048); returns K9's graph times
    with and without its Y half, at 128bit_fast and 128bit, and K1's at
    half the batch.  The first four K9 shapes and the 128bit_fast graph
    pair draw their inputs from ``gen`` in their original order, the
    others from ``gen_k9``, so that adding a check here does not change
    the later phases' keys and inputs (their figures compare from run to
    run; PERF.md §7 on phase 14)."""
    fast, exact = params.P128_FAST, params.P128

    def rand_words(shape, g=gen):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=g)

    def amounts(n, b, g=gen):
        t = torch.randint(0, 2 * n + 1, (b,), dtype=torch.int32, device=dev,
                          generator=g)
        t[:4] = torch.tensor([0, n, 2 * n - 1, 2 * n], dtype=torch.int32,
                             device=dev)
        return t

    def band(p, g=gen):
        bsk = rand_words((1, 2 * p.l, 2, p.n), g)
        if p.key_grid_bits:
            bsk &= ~((1 << p.key_grid_bits) - 1)
        return cuda_t.pack_bsk_band_t(bsk, cuda_t.band_limb_drop(p)
                                      )[0].contiguous()

    for p, b in ((fast, BATCH), (fast, BATCH - 1), (exact, BATCH)):
        acc, am, bd = rand_words((2, b, p.n)), amounts(p.n, b), band(p)
        o_k = cuda_step.fused_rotate_step(p, acc, am, bd)
        o_p = cuda_step.fused_rotate_step_ref(p, acc, am, bd)
        torch.cuda.synchronize()
        e3 = max_abs_err(o_k, o_p)
        print(f"   {p.name:12s} B={b:5d}  K3 max|err| {e3}", flush=True)
        check(e3 == 0, f"K3 disagrees with its plain version at {p.name} "
              f"B={b}")
        errs["fused_rotate_step"] = max(errs["fused_rotate_step"], e3)
        if p is fast and b == BATCH:
            times["fused_rotate_step"] = (
                cuda_ms(lambda: cuda_step.fused_rotate_step(p, acc, am, bd),
                        20),
                cuda_ms(lambda: cuda_step.fused_rotate_step_ref(p, acc, am,
                                                                bd), 3))
    errs["fused_rotate_step"] = max(errs["fused_rotate_step"],
                                    extreme_step(dev))
    h = PIPE_HALF
    for p, lo in ((fast, 1), (exact, 0)):
        plan = cuda_pipe.pipe_plan(p.n, h, h)
        check(lo == cuda_t.band_limb_drop(p), "unexpected lo")
        held = {smem: cuda_pipe.occupancy(lo, smem)
                for smem in (cuda_pipe.TILE_SMEM, plan.smem)}
        print(f"   pipe_kernel<lo {lo}> blocks an SM: "
              + ", ".join(f"{k} at {smem} B" for smem, k in held.items())
              + f"; plan at halves of {h}: {plan}", flush=True)
    for p, bx, by, off, g in ((fast, h, h, False, gen),
                              (fast, h, h - 1, False, gen),
                              (fast, h - 1, h, False, gen),
                              (exact, h, h, False, gen),
                              (fast, 17, 33, False, gen_k9),
                              (fast, h, h, True, gen_k9),
                              (exact, h, h - 1, False, gen_k9),
                              (exact, 129, 127, False, gen_k9),
                              (exact, 64, 61, True, gen_k9)):
        acc_x = rand_words((2, p.n, bx), g)
        acc_y = rand_words((2, p.n, by), g)
        if off:
            acc_y = misaligned(acc_y)
        digits_x = cuda_t.rotate_decompose_t_ref(p, acc_x,
                                                 amounts(p.n, bx, g))
        args = (digits_x, band(p, g), acc_x, acc_y, amounts(p.n, by, g))
        ox, dy = cuda_pipe.pipe_step(p, *args)
        px, py = cuda_pipe.pipe_step_ref(p, *args)
        torch.cuda.synchronize()
        e9 = max(max_abs_err(ox, px), max_abs_err(dy, py))
        what = (f"halves {bx:4d}/{by:4d}"
                + (", acc_y misaligned" if off else ""))
        print(f"   {p.name:12s} {what}  K9 max|err| {e9}", flush=True)
        check(e9 == 0, f"K9 disagrees with its plain version at {p.name} "
              f"{what}")
        errs["pipe_step"] = max(errs["pipe_step"], e9)
        if p is fast and bx == by == h and not off:
            times["pipe_step"] = (
                cuda_ms(lambda: cuda_pipe.pipe_step(p, *args), 20),
                cuda_ms(lambda: cuda_pipe.pipe_step_ref(p, *args), 3))
    for name, where in (("fused_rotate_step", f"B={BATCH}"),
                        ("pipe_step", f"halves of {h}")):
        ms, plain_ms = times[name]
        print(f"   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
              f"call ({fast.name}, {where})", flush=True)
    # K9's Y half: the same X half with and without a Y half, each
    # replayed from a CUDA graph, and K1 alone on the Y half.
    out = {}
    for p, g in ((fast, gen), (exact, gen_k9)):
        acc_x, acc_y = rand_words((2, p.n, h), g), rand_words((2, p.n, h), g)
        digits_x = cuda_t.rotate_decompose_t_ref(p, acc_x, amounts(p.n, h, g))
        bd, am_y = band(p, g), amounts(p.n, h, g)
        no_y = torch.empty((2, p.n, 0), dtype=torch.int32, device=dev)
        no_am = torch.empty((0,), dtype=torch.int32, device=dev)
        both = lambda: cuda_pipe.pipe_step(p, digits_x, bd, acc_x, acc_y,
                                           am_y)
        x_only = lambda: cuda_pipe.pipe_step(p, digits_x, bd, acc_x, no_y,
                                             no_am)
        k1 = lambda: cuda_t.rotate_decompose_t(p, acc_y, am_y)
        check(torch.equal(both()[0], x_only()[0]),
              "K9's X half depends on its Y half")
        ms_both, ms_x, ms_k1 = (graph_ms(both, 20), graph_ms(x_only, 20),
                                graph_ms(k1, 20))
        print(f"   pipe_step {p.name} halves {h}/{h}: {ms_both:.4f} ms, "
              f"{h}/0: {ms_x:.4f} ms (graph): the Y half "
              f"{ms_both - ms_x:.4f} ms, {(ms_both - ms_x) / ms_both:.1%} "
              f"of the call; K1 alone at B={h} {ms_k1:.4f} ms", flush=True)
        name = "pipe_step" if p is fast else f"pipe_step {p.name}"
        plain_ms = (times["pipe_step"][1] if p is fast else cuda_ms(
            lambda: cuda_pipe.pipe_step_ref(p, digits_x, bd, acc_x, acc_y,
                                            am_y), 3))
        out[f"{name} halves {h}/{h}, graph"] = {
            "ms": ms_both, "plain_ms": plain_ms, "library_ms": None}
        out[f"{name} halves {h}/0, graph"] = {
            "ms": ms_x, "plain_ms": None, "library_ms": None}
        out[f"rotate_decompose_t {p.name} B={h}"] = {
            "ms": ms_k1, "plain_ms": None, "library_ms": None}
    return out


def pbs_phase(gen, dev, p, batch: int, f, steady: bool,
              kernels: tuple = K4K5, keep: bool = False) -> dict:
    """Keygen on the card, then ``lut.bootstrap_func`` with f on a batch of
    messages cycling over the message space: decryption, phase margin
    against the half-segment 2^31/m/2, launch counts (``kernels``, lwe_n
    per bootstrap), batch times, peak memory, and PBS_PLAIN_CHECK
    ciphertexts against the plain path.  Returns the figures, and with
    ``keep`` the run's (key, inputs, outputs, table) under "run"."""
    m = p.message_modulus
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    keygen_s = done(t0, "keygen ")
    keygen_peak = torch.cuda.max_memory_allocated()
    print(f"   ksk {ck.ksk.numel() * 4} B, bands {ck.bands.numel() * 4} B; "
          f"keygen peak memory {keygen_peak} B", flush=True)
    msgs = np.arange(batch) % m
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_t.reset_launch_counts()
    calls = 0
    t1 = time.perf_counter()
    out = lut.bootstrap_func(ck, ct, f, m)
    calls += 1
    first_s = done(t1, "first batch ")
    steady_s = None
    if steady:
        t1 = time.perf_counter()
        out2 = lut.bootstrap_func(ck, ct, f, m)
        calls += 1
        steady_s = done(t1, "steady batch ")
        check(torch.equal(out, out2), "two runs of one batch disagree")
    launches = dict(cuda_t.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    print(f"   launches over {calls} bootstrap call(s): {launches}; peak "
          f"memory {peak} B", flush=True)
    check_counts(launches, dict.fromkeys(kernels, p.lwe_n), calls)

    check(out.shape == (batch, p.lwe_n + 1) and out.dtype == torch.int32,
          f"unexpected output {tuple(out.shape)} {out.dtype}")
    want = np.asarray([f(int(x)) for x in msgs])
    dec = cipher.lwe_decrypt_message(out, m, sk.lv0).cpu().numpy()
    wrong = int((dec != want).sum())
    check(wrong == 0, f"{wrong}/{batch} {p.name} outputs decrypt wrong")
    half = 2 ** 31 // m // 2
    sig, std, worst = margin_sigmas(
        cipher.lwe_phase(out, sk.lv0).cpu().numpy(),
        cipher.encode_message(want, m).astype(np.int64), half)
    rate = batch / (steady_s if steady else first_s)
    print(f"   {batch}/{batch} right; phase noise std 2^{np.log2(std):.2f}, "
          f"max |dev| 2^{np.log2(worst + 1):.2f}, margin {sig:.1f} sigma of "
          f"the 2^{np.log2(half):.0f} half-segment; PBS/s "
          f"{rate:.1f}", flush=True)

    t1 = time.perf_counter()
    table = lut.Generator(p, m, device=dev).gen_lut(f)
    plain = engine.bootstrap(ck, ct[:PBS_PLAIN_CHECK], testvec=table,
                             plain=True)
    check(torch.equal(plain, out[:PBS_PLAIN_CHECK]),
          f"{p.name}: the kernel path disagrees with the plain path")
    check(cuda_t.launch_counts == launches, "the plain path launched a kernel")
    done(t1, f"{PBS_PLAIN_CHECK} ciphertexts bit-equal through the plain "
         "path; ")
    profile_batch(p.name, lambda: lut.bootstrap_func(ck, ct, f, m))
    fig = {"keygen_s": keygen_s, "keygen_peak_bytes": keygen_peak,
           "first_batch_s": first_s, "steady_batch_s": steady_s,
           "pbs_per_s": rate, "margin_sigmas": sig,
           "peak_bytes": peak, "launches": launches}
    if keep:
        fig["run"] = (ck, ct, out, table)
    return fig


def block_nand_phase(gen, dev, p, bits_a, bits_b) -> dict:
    """A block-binary key made on the card, then NAND on the bit pairs:
    with ``engine.PREFER_BLOCK_ROTATION`` set (K7 + K8, ceil(lwe_n / bs)
    steps), a first and a steady batch, truth table, margin, launches and
    PLAIN_CHECK gates against the plain path; then with the flag off on
    the same keys (K1 + K2, lwe_n steps), truth table, margin and
    launches.  Returns the figures."""
    batch = len(bits_a)
    bs = p.block_size
    steps = -(-p.lwe_n // bs)
    t0 = time.perf_counter()
    sk = keys.gen_secret_key(gen, p, dev, block_binary=True)
    ck = keys.gen_cloud_key(gen, sk, p)
    keygen_s = done(t0, "block-binary keygen ")
    full = p.lwe_n // bs
    check(ck.block_binary and sk.block_binary, "the key is not block-binary")
    check(sk.lv0[:full * bs].view(full, bs).sum(1).max().item() <= 1
          and sk.lv0[full * bs:].sum().item() <= 1,
          "a key block has Hamming weight > 1")
    ct_a = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_a),
                                   p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_b),
                                   p.lwe_alpha, sk.lv0)
    want = ~(bits_a & bits_b)
    ideal = np.where(want, MARGIN, -MARGIN)
    out = {"keygen_s": keygen_s}
    for prefer, kernels, per_call in ((True, K7K8, steps),
                                      (False, K1K2, p.lwe_n)):
        engine.PREFER_BLOCK_ROTATION = prefer
        route = engine._route(ck)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_t.reset_launch_counts()
        t1 = time.perf_counter()
        res = gates.NAND(ck, ct_a, ct_b)
        first_s = done(t1, f"{route}: first batch ")
        t1 = time.perf_counter()
        res2 = gates.NAND(ck, ct_a, ct_b)
        steady_s = done(t1, f"{route}: steady batch ")
        launches = dict(cuda_t.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        print(f"   launches over 2 bootstrap calls: {launches}; peak memory "
              f"{peak} B", flush=True)
        check_counts(launches, dict.fromkeys(kernels, per_call), 2)
        check(torch.equal(res, res2), "two runs of one batch disagree")
        check(res.shape == (batch, p.lwe_n + 1), "unexpected output shape")
        dec = cipher.lwe_decrypt_bool(res, sk.lv0).cpu().numpy()
        wrong = int((dec != want).sum())
        check(wrong == 0, f"{wrong}/{batch} block-key NAND outputs decrypt "
              f"wrong ({route})")
        sig, std, worst = margin_sigmas(
            cipher.lwe_phase(res, sk.lv0).cpu().numpy(), ideal, MARGIN)
        print(f"   {batch}/{batch} right; phase noise std 2^{np.log2(std):.2f}"
              f", max |dev| 2^{np.log2(worst + 1):.2f}, margin {sig:.1f} "
              f"sigma; gates/s steady {batch / steady_s:.1f}", flush=True)
        check(sig >= MIN_SIGMAS,
              f"noise margin {sig:.1f} sigma below {MIN_SIGMAS} ({route})")
        fig = {"first_batch_s": first_s, "steady_batch_s": steady_s,
               "gates_per_s": batch / steady_s, "margin_sigmas": sig,
               "peak_bytes": peak, "launches": launches}
        if prefer:
            out["run"] = (ck, ct_a, ct_b, res)
            t1 = time.perf_counter()
            prepared = engine.prepare_nand(ct_a[:PLAIN_CHECK],
                                           ct_b[:PLAIN_CHECK])
            plain = engine.bootstrap(ck, prepared, plain=True)
            check(torch.equal(plain, res[:PLAIN_CHECK]),
                  "block NAND: the kernel path disagrees with the plain path")
            check(cuda_t.launch_counts == launches,
                  "the plain path launched a kernel")
            done(t1, f"{PLAIN_CHECK} gates bit-equal through the plain path; ")
        profile_batch(f"block-binary key, {route}",
                      lambda: gates.NAND(ck, ct_a, ct_b))
        out["block" if prefer else "per_bit"] = fig
    engine.PREFER_BLOCK_ROTATION = False
    return out


def per_bit_routes_phase(p, ck, sk, ct_a, ct_b, bits_a, bits_b,
                         nand_out, labels=ROUTES) -> dict:
    """NAND on the bit pairs through each per-bit route of ``labels`` on
    the same keys: K1 + K2 (the default, timed again here so that the rates
    compare within one phase), then (a) a key with ``transposed=False`` and
    ``blindrotate.FUSED_STEP`` set (K3), (b) the same key with the flag
    unset (K7 at bs 1 + K8), (c) ``engine.PREFER_PIPE`` (one K1, then two
    K9 half-batch steps per LWE bit).  Each route: a first and a steady
    batch, exact launch counts, every output equal to ``nand_out`` (phase
    5's batch: the routes compute the same words; None: the first route's
    batch), truth table, margin, and (a)-(c) PLAIN_CHECK gates against the
    route's plain path.  Returns the figures by route."""
    batch, n = len(bits_a), p.lwe_n
    want = ~(bits_a & bits_b)
    row = dataclasses.replace(ck, transposed=False)
    routes = (
        ("k1k2", ck, False, False, {"rotate_decompose_t": n,
                                    "extprod_t": n}),
        ("a_fused_k3", row, True, False, {"fused_rotate_step": n}),
        ("b_k7k8", row, False, False, {"rotate_decompose": n, "extprod": n}),
        ("c_pipe_k9", ck, False, True, {"rotate_decompose_t": 1,
                                        "pipe_step": 2 * n}))
    out = {}
    for label, key, fused, pipe, per_call in routes:
        if label not in labels:
            continue
        blindrotate.FUSED_STEP = fused
        engine.PREFER_PIPE = pipe
        route = engine._route(key)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_t.reset_launch_counts()
        t1 = time.perf_counter()
        res = gates.NAND(key, ct_a, ct_b)
        first_s = done(t1, f"{label} ({route}): first batch ")
        t1 = time.perf_counter()
        res2 = gates.NAND(key, ct_a, ct_b)
        steady_s = done(t1, f"{label} ({route}): steady batch ")
        launches = dict(cuda_t.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        print(f"   launches over 2 bootstrap calls: {launches}; peak memory "
              f"{peak} B", flush=True)
        check_counts(launches, per_call, 2)
        if nand_out is None:
            nand_out = res
        check(torch.equal(res, res2) and torch.equal(res, nand_out),
              f"{label}: the batch differs from the first route's")
        check(res.shape == (batch, p.lwe_n + 1), "unexpected output shape")
        dec = cipher.lwe_decrypt_bool(res, sk.lv0).cpu().numpy()
        wrong = int((dec != want).sum())
        check(wrong == 0, f"{wrong}/{batch} NAND outputs decrypt wrong "
              f"({label})")
        sig, std, worst = margin_sigmas(
            cipher.lwe_phase(res, sk.lv0).cpu().numpy(),
            np.where(want, MARGIN, -MARGIN), MARGIN)
        print(f"   {batch}/{batch} right; phase noise std 2^{np.log2(std):.2f}"
              f", max |dev| 2^{np.log2(worst + 1):.2f}, margin {sig:.1f} "
              f"sigma; gates/s first {batch / first_s:.1f}, steady "
              f"{batch / steady_s:.1f}", flush=True)
        check(sig >= MIN_SIGMAS,
              f"noise margin {sig:.1f} sigma below {MIN_SIGMAS} ({label})")
        if label != "k1k2":
            t1 = time.perf_counter()
            prepared = engine.prepare_nand(ct_a[:PLAIN_CHECK],
                                           ct_b[:PLAIN_CHECK])
            plain = engine.bootstrap(key, prepared, plain=True)
            check(torch.equal(plain, res[:PLAIN_CHECK]),
                  f"{label}: the kernel path disagrees with the plain path")
            check(cuda_t.launch_counts == launches,
                  "the plain path launched a kernel")
            done(t1, f"{PLAIN_CHECK} gates bit-equal through the plain "
                 "path; ")
        profile_batch(f"{label} ({route})",
                      lambda: gates.NAND(key, ct_a, ct_b))
        out[label] = {"route": route, "first_batch_s": first_s,
                      "steady_batch_s": steady_s,
                      "gates_per_s": batch / steady_s, "margin_sigmas": sig,
                      "peak_bytes": peak, "launches": launches}
    blindrotate.FUSED_STEP = False
    engine.PREFER_PIPE = False
    return out

def exact_phase(gen, dev, bits_a, bits_b) -> dict:
    """Phase 19: NAND on the bit pairs at ``128bit`` (bench.py --exact: the
    reference's gadget, bgbit 6, l 3, no key limb dropped), keys made on
    the card, through K1 + K2 and route (c) (K1 + K9 at l 3: 6 digit rows,
    4 key limbs) by :func:`per_bit_routes_phase`: exact launches, the two
    routes' words equal, every output right at >= MIN_SIGMAS.  Returns the
    keygen time and the figures by route."""
    p = params.P128
    t1 = time.perf_counter()
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    keygen_s = done(t1, f"keygen at {p.name} ")
    check(cuda_t.band_limb_drop(p) == 0 and p.l == 3, "unexpected profile")
    ct_a = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_a),
                                   p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_b),
                                   p.lwe_alpha, sk.lv0)
    routes = per_bit_routes_phase(p, ck, sk, ct_a, ct_b, bits_a, bits_b,
                                  None, labels=("k1k2", "c_pipe_k9"))
    for label, fig in routes.items():
        print(f"   {p.name} {label:10s} {fig['gates_per_s']:9.1f} gates/s, "
              f"margin {fig['margin_sigmas']:.1f} sigma", flush=True)
    return {"keygen_s": keygen_s, **routes}


def on_card(t: torch.Tensor, what: str) -> torch.Tensor:
    check(t.device.type == "cuda", f"{what}: output on {t.device}, not on "
          "the card")
    return t


def portable_phase(gen, dev, p, ck, ct_a, ct_b, nand_out, and_or, u6_run,
                   blk_run, k2_ms: float) -> dict:
    """Phase 20: the portable path (the JAX package's off-TPU cores:
    gather rotations and the Toeplitz external product's three float64
    products on the D bands, no kernel) on the earlier phases' keys and
    inputs: phase 5's NAND batch (``blind_rotate``, a first and a steady
    batch), phase 11's block-binary NAND batch
    (``blind_rotate_block_portable``), the first UINT6_PORTABLE of phase
    8's uint6 batch (``blind_rotate_extended``) and phase 7's AND_OR batch
    (``bootstrap_many`` on ``blind_rotate``, theta 1, k 2), each output on
    the card and equal to its phase's words; then, at ``p`` and BATCH, one
    portable step (``ops.external_product``) beside K2's ``k2_ms``, its
    Toeplitz build and one float64 product alone, ``negacyclic_extprod_i8``
    (``_int_mm``) and the Nussbaumer product at NUSS_BATCH, both equal to
    the dense product.  No kernel may launch during the phase.  ``gen``
    (its own seed) draws the step's accumulator.  Returns the figures."""
    out = {}
    torch.cuda.synchronize()
    cuda_t.reset_launch_counts()

    prepared = engine.prepare_nand(ct_a, ct_b)

    def nand():
        return engine._bootstrap(ck, prepared, None, True, plain=False,
                                 route="blind_rotate")
    t1 = time.perf_counter()
    res = on_card(nand(), "portable NAND")
    first_s = done(t1, "NAND, blind_rotate: first batch ")
    t1 = time.perf_counter()
    res2 = nand()
    steady_s = done(t1, "NAND, blind_rotate: steady batch ")
    check(torch.equal(res, nand_out) and torch.equal(res2, res),
          "portable NAND: the words differ from phase 5's")
    out["nand"] = {"first_batch_s": first_s, "steady_batch_s": steady_s,
                   "gates_per_s": BATCH / steady_s}
    print(f"   {BATCH} words equal to phase 5's; gates/s steady "
          f"{BATCH / steady_s:.1f}", flush=True)
    profile_batch("NAND, portable blind_rotate", nand)

    bck, bct_a, bct_b, bres = blk_run
    t1 = time.perf_counter()
    res = on_card(engine._bootstrap(
        bck, engine.prepare_nand(bct_a, bct_b), None, True, plain=False,
        route="blind_rotate_block_portable"), "portable block NAND")
    block_s = done(t1, "block NAND, blind_rotate_block_portable: batch ")
    check(torch.equal(res, bres),
          "portable block NAND: the words differ from phase 11's")
    out["block_nand"] = {"batch_s": block_s, "gates_per_s": BATCH / block_s}

    uck, uct, uout, table = u6_run
    t1 = time.perf_counter()
    res = on_card(engine._bootstrap(
        uck, uct[:UINT6_PORTABLE], table, True, plain=False,
        route="blind_rotate_extended"), "portable uint6 PBS")
    ext_s = done(t1, f"{uck.params.name} B={UINT6_PORTABLE}, "
                 "blind_rotate_extended: batch ")
    check(torch.equal(res, uout[:UINT6_PORTABLE]),
          "portable uint6 PBS: the words differ from phase 8's")
    out["uint6_centered"] = {"batch": UINT6_PORTABLE, "batch_s": ext_s,
                             "pbs_per_s": UINT6_PORTABLE / ext_s}

    t1 = time.perf_counter()
    res = on_card(engine.bootstrap_many(
        ck, ct_a + ct_b, gates.and_or_lut(p, dev), k=2, theta=1,
        route="blind_rotate"), "portable AND_OR")
    many_s = done(t1, "AND_OR, bootstrap_many on blind_rotate: batch ")
    check(torch.equal(res[0], and_or[0]) and torch.equal(res[1], and_or[1]),
          "portable AND_OR: the words differ from phase 7's")
    out["and_or"] = {"batch_s": many_s}

    l2, n = 2 * p.l, p.n
    acc = wrap_i32(torch.randint(0, 1 << 32, (BATCH, 2, n), generator=gen,
                                 device=dev, dtype=torch.int64))
    band = keys.prepare_bootstrap_kernels(ck.bsk[0], p)
    digits = decompose.gadget_decompose(acc, p)             # (B, 2L, N)
    dense = on_card(polymul.negacyclic_extprod_toeplitz(digits, band),
                    "dense product")
    step_ms = cuda_ms(lambda: extprod.external_product(p, band, acc), 5)
    toeplitz_ms = cuda_ms(lambda: polymul.toeplitz_from_band(band).permute(
        0, 2, 1, 3).reshape(l2 * n, 2 * n), 5)
    a64 = torch.rand((BATCH, l2 * n), generator=gen, device=dev,
                     dtype=torch.float64)
    b64 = torch.rand((l2 * n, 2 * n), generator=gen, device=dev,
                     dtype=torch.float64)
    gemm_ms = cuda_ms(lambda: a64 @ b64, 5)
    flops = 3 * 2 * BATCH * l2 * n * 2 * n
    bound_ms = flops / (FP64_TFLOPS * 1e12) * 1e3
    print(f"   portable step (ops.external_product) {p.name} B={BATCH}: "
          f"{step_ms:.4f} ms ({step_ms / k2_ms:.2f} x K2's {k2_ms:.4f}); "
          f"Toeplitz build {toeplitz_ms:.4f} ms, one float64 product "
          f"{gemm_ms:.4f} ms; FP64 bound {bound_ms:.4f} ms", flush=True)

    d8 = digits.to(torch.int8)
    kern8 = polymul.split_balanced_limbs_i8(
        polymul.extprod_kernel_from_trgsw(ck.bsk[0]), 4)
    got = on_card(polymul.negacyclic_extprod_i8(d8, kern8), "i8 form")
    check(torch.equal(got, dense),
          "negacyclic_extprod_i8 differs from the dense product")
    i8_ms = cuda_ms(lambda: polymul.negacyclic_extprod_i8(d8, kern8), 5)
    i8_bound_ms = (2 * BATCH * l2 * n * 4 * 2 * n
                   / (profiling.H100_PEAKS["h100"]["int8_tops"] * 1e12) * 1e3)
    print(f"   negacyclic_extprod_i8 (_int_mm) B={BATCH}: {i8_ms:.4f} ms; "
          f"int8 bound {i8_bound_ms:.4f} ms", flush=True)

    dn = digits[:NUSS_BATCH]
    got = on_card(nussbaumer.extprod_nuss_ref(dn, ck.bsk[0]), "Nussbaumer")
    check(torch.equal(got, dense[:NUSS_BATCH]),
          "the Nussbaumer product differs from the dense product")
    nuss_ms = cuda_ms(lambda: nussbaumer.extprod_nuss_ref(dn, ck.bsk[0]), 5)
    dense_small_ms = cuda_ms(
        lambda: polymul.negacyclic_extprod_toeplitz(dn, band), 5)
    print(f"   extprod_nuss_ref B={NUSS_BATCH}: {nuss_ms:.4f} ms, dense "
          f"{dense_small_ms:.4f} ms; words equal", flush=True)
    out["step"] = {"profile": p.name, "batch": BATCH,
                   "external_product_ms": step_ms, "k2_ms": k2_ms,
                   "toeplitz_build_ms": toeplitz_ms,
                   "one_f64_product_ms": gemm_ms,
                   "fp64_bound_ms": bound_ms,
                   "extprod_i8_int_mm_ms": i8_ms,
                   "extprod_i8_bound_ms": i8_bound_ms,
                   "nussbaumer_batch": NUSS_BATCH,
                   "nussbaumer_ms": nuss_ms,
                   "dense_at_nussbaumer_batch_ms": dense_small_ms}
    launched = {k: v for k, v in cuda_t.launch_counts.items() if v}
    check(not launched, f"the portable path launched kernels: {launched}")
    return out


def timed_run(label: str, fn) -> tuple:
    """fn() once with the launch counters set to 0 just before and read
    just after: (result, seconds on the host clock around a synchronize,
    launches)."""
    torch.cuda.synchronize()
    cuda_t.reset_launch_counts()
    t1 = time.perf_counter()
    out = fn()
    secs = done(t1, f"{label}: ")
    launches = dict(cuda_t.launch_counts)
    print(f"   launches: {launches}", flush=True)
    return out, secs, launches


def bool_margin(ct, key, truth, what: str, floor: float = MIN_SIGMAS,
                max_wrong: int = 0) -> float:
    """At most ``max_wrong`` boolean outputs (lv0 key ``key``) decrypt
    other than ``truth``, and the phase keeps at least ``floor`` sigma of
    the 2^29 margin.  Returns the margin."""
    truth = np.asarray(truth).reshape(-1)
    flat = ct.reshape(-1, ct.shape[-1])
    dec = cipher.lwe_decrypt_bool(flat, key).cpu().numpy()
    wrong = int((dec != truth).sum())
    check(wrong <= max_wrong,
          f"{wrong}/{truth.size} {what} outputs decrypt wrong")
    sig, std, worst = margin_sigmas(
        cipher.lwe_phase(flat, key).cpu().numpy(),
        np.where(truth, MARGIN, -MARGIN), MARGIN)
    print(f"   {what}: {truth.size - wrong}/{truth.size} right, phase noise "
          f"std 2^{np.log2(std):.2f}, max |dev| 2^{np.log2(worst + 1):.2f}, "
          f"margin {sig:.1f} sigma", flush=True)
    check(sig >= floor, f"{what} noise margin {sig:.1f} sigma below {floor}")
    return sig


def message_margin(ct, key, want, m: int, what: str, floor: float,
                   max_wrong: int = 0) -> float:
    """Every modulus-m message output (lv0 key ``key``) but at most
    ``max_wrong`` decrypts to ``want``, and its phase keeps at least
    ``floor`` sigma of the 2^31/m/2 half-segment around the message it
    decrypts to (a wrong output's noise is that of a right PBS of a
    wrongly rounded input)."""
    want = np.asarray(want).reshape(-1)
    flat = ct.reshape(-1, ct.shape[-1])
    dec = cipher.lwe_decrypt_message(flat, m, key).cpu().numpy()
    wrong = int((dec != want).sum())
    check(wrong <= max_wrong,
          f"{wrong}/{want.size} {what} outputs decrypt wrong")
    half = 2 ** 31 // m // 2
    sig, std, worst = margin_sigmas(
        cipher.lwe_phase(flat, key).cpu().numpy(),
        cipher.encode_message(dec, m).astype(np.int64), half)
    print(f"   {what}: {want.size - wrong}/{want.size} right, phase noise "
          f"std 2^{np.log2(std):.2f}, max |dev| 2^{np.log2(worst + 1):.2f}, "
          f"margin {sig:.1f} sigma of the 2^{np.log2(half):.0f} "
          f"half-segment", flush=True)
    check(sig >= floor, f"{what} noise margin {sig:.1f} sigma below {floor}")
    return sig


def circuits_phase(gen, p, ck, sk) -> dict:
    """Phase 13: the boolean circuit library on phase 4's keys, batch
    BATCH: NOT, COPY and constant (no launches); MUX on the 8 (sel, then,
    else) combinations tiled (2 bootstraps without key switch, then one
    key switch); MUX_3GATE on the same inputs (3 gate bootstraps); the
    8-bit boolean ripple-carry add (40 gate bootstraps); the 8-bit many-LUT
    ripple add (8 many-LUT bootstraps).  Each: every output against its
    plain truth, exact launch counts, margins, time and rate."""
    n = p.lwe_n
    out = {}
    combos = np.asarray(list(np.ndindex(2, 2, 2)), bool)
    sel, then, other = (np.resize(combos[:, i], BATCH) for i in range(3))
    c_sel, c_then, c_else = (cipher.lwe_encrypt_bool(
        gen, torch.from_numpy(x), p.lwe_alpha, sk.lv0)
        for x in (sel, then, other))

    def no_launch():
        return (gates.NOT(c_sel), gates.COPY(c_then),
                gates.constant(p, True, (BATCH,), device=c_sel.device),
                gates.constant(p, other, (BATCH,), device=c_sel.device))
    (c_not, c_copy, c_true, c_const), _, launches = timed_run(
        "NOT, COPY, constant", no_launch)
    check_counts(launches, {}, 0)
    bool_margin(c_not, sk.lv0, ~sel, "NOT")
    bool_margin(c_copy, sk.lv0, then, "COPY")
    check(torch.equal(c_copy, c_then) and c_copy.data_ptr() != c_then.data_ptr(),
          "COPY is not a copy")
    for ct, truth in ((c_true, np.ones(BATCH, bool)), (c_const, other)):
        body = torch.from_numpy(np.where(truth, T_EIGHTH, 1 - T_EIGHTH)
                                .astype(np.uint32).view(np.int32))
        check(not ct[:, :n].any().item() and torch.equal(ct[:, n].cpu(), body)
              and torch.equal(cipher.lwe_decrypt_bool(ct, sk.lv0).cpu(),
                              torch.from_numpy(truth)),
              "a constant is not the trivial ciphertext of its value")
    print(f"   NOT, COPY: {BATCH}/{BATCH} right; constants trivial and right",
          flush=True)

    want = np.where(sel, then, other)
    mux, secs, launches = timed_run(
        "MUX batch", lambda: gates.MUX(ck, c_sel, c_then, c_else))
    check_counts(launches, dict.fromkeys(K1K2, n), 2)
    sig = bool_margin(mux, sk.lv0, want, "MUX")
    out["mux"] = {"batch_s": secs, "mux_per_s": BATCH / secs,
                  "margin_sigmas": sig, "launches": launches}
    print(f"   MUX/s {BATCH / secs:.1f}", flush=True)
    mux3, secs, launches = timed_run(
        "MUX_3GATE batch", lambda: gates.MUX_3GATE(ck, c_sel, c_then,
                                                   c_else))
    check_counts(launches, dict.fromkeys(K1K2, n), 3)
    sig = bool_margin(mux3, sk.lv0, want, "MUX_3GATE")
    check(torch.equal(cipher.lwe_decrypt_bool(mux3, sk.lv0),
                      cipher.lwe_decrypt_bool(mux, sk.lv0)),
          "MUX_3GATE and MUX decrypt differently")
    out["mux_3gate"] = {"batch_s": secs, "mux_per_s": BATCH / secs,
                        "margin_sigmas": sig, "launches": launches}
    print(f"   MUX_3GATE/s {BATCH / secs:.1f}", flush=True)

    rng = np.random.default_rng(13)
    va, vb = rng.integers(0, 256, (2, BATCH))
    bits_a = np.stack([bitutils.to_bits(v, 8) for v in va])
    bits_b = np.stack([bitutils.to_bits(v, 8) for v in vb])
    total = va + vb
    sum_bits = np.stack([bitutils.to_bits(v, 8) for v in total])
    ca = bitutils.encrypt_bits(gen, bits_a, p.lwe_alpha, sk.lv0)
    cb = bitutils.encrypt_bits(gen, bits_b, p.lwe_alpha, sk.lv0)
    (s_bits, carry), secs, launches = timed_run(
        "8-bit ripple_carry_add batch",
        lambda: adders.ripple_carry_add(ck, ca, cb))
    check_counts(launches, dict.fromkeys(K1K2, n), 40)
    sig = bool_margin(s_bits, sk.lv0, sum_bits, "ripple_carry_add sum bits")
    bool_margin(carry, sk.lv0, total >= 256, "ripple_carry_add carry")
    dec = bitutils.decrypt_bits(s_bits, sk.lv0).cpu().numpy()
    cdec = cipher.lwe_decrypt_bool(carry, sk.lv0).cpu().numpy()
    got = [bitutils.from_bits(r) + (int(c) << 8) for r, c in zip(dec, cdec)]
    check(np.array_equal(got, total), "an 8-bit ripple sum is not a + b")
    out["ripple_carry_add"] = {"batch_s": secs, "adds_per_s": BATCH / secs,
                               "margin_sigmas": sig, "launches": launches}
    print(f"   8-bit ripple adds/s {BATCH / secs:.1f}", flush=True)
    profile_batch("8-bit ripple_carry_add",
                  lambda: adders.ripple_carry_add(ck, ca, cb))

    ma = bitutils.encrypt_bits_messages(gen, bits_a, p.lwe_alpha, sk.lv0)
    mb = bitutils.encrypt_bits_messages(gen, bits_b, p.lwe_alpha, sk.lv0)
    (m_bits, m_carry), secs, launches = timed_run(
        "8-bit ripple_add_manylut batch",
        lambda: adders.ripple_add_manylut(ck, ma, mb))
    check_counts(launches, dict.fromkeys(K1K2, n), 8)
    sig = message_margin(m_bits, sk.lv0, sum_bits.astype(np.int64), 8,
                         "ripple_add_manylut sum bits", MANY_LUT_MIN_SIGMAS)
    message_margin(m_carry, sk.lv0, (total >= 256).astype(np.int64), 8,
                   "ripple_add_manylut carry", MANY_LUT_MIN_SIGMAS)
    out["ripple_add_manylut"] = {
        "batch_s": secs, "adds_per_s": BATCH / secs,
        "full_adders_per_s": 8 * BATCH / secs, "margin_sigmas": sig,
        "launches": launches}
    print(f"   many-LUT 8-bit adds/s {BATCH / secs:.1f}, full adders/s "
          f"{8 * BATCH / secs:.1f}", flush=True)
    return out


def uint5_phase(gen, dev) -> dict:
    """Phase 14: uint5 (lwe_n 1071, N 2048, three digit limbs) on the
    card: keygen; ``add8_pbs`` on U5_BATCH random pairs of 8-bit numbers
    (3 bootstraps, K1 + K2), every sum against (a + b) mod 256, margin
    against the 2^25 half-segment; PBS_PLAIN_CHECK pairs, and every wrong
    one (up to one past U5_MAX_WRONG), through the plain versions, word
    for word, and each wrong sum's PBS inputs against their half-segments,
    printed before the guards (at most U5_MAX_WRONG wrong sums, the third
    PBS input's std at most 2^U5_PBS3_STD_LOG2_MAX); ``comparators.ge``,
    ``lt`` and ``eq`` (m 32) on every pair of [0, 16)^2, tiled to
    U5_BATCH."""
    p, m = U5, U5.message_modulus
    n = p.lwe_n
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    keygen_s = done(t0, "keygen ")
    keygen_peak = torch.cuda.max_memory_allocated()
    print(f"   ksk {ck.ksk.numel() * 4} B, bands {ck.bands.numel() * 4} B; "
          f"keygen peak memory {keygen_peak} B", flush=True)
    out = {"keygen_s": keygen_s, "keygen_peak_bytes": keygen_peak}

    rng = np.random.default_rng(14)
    va, vb = rng.integers(0, 256, (2, U5_BATCH))
    nib = [cipher.lwe_encrypt_message(gen, v, m, p.lwe_alpha, sk.lv0)
           for v in (va & 0xF, va >> 4, vb & 0xF, vb >> 4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (s_lo, s_hi), secs, launches = timed_run(
        "add8_pbs batch", lambda: adders.add8_pbs(ck, *nib))
    peak = torch.cuda.max_memory_allocated()
    check_counts(launches, dict.fromkeys(K1K2, n), 3)
    lo = (va & 0xF) + (vb & 0xF)
    want_lo, want_hi = lo % 16, ((va >> 4) + (vb >> 4) + (lo >= 16)) % 16
    got = ((cipher.lwe_decrypt_message(s_hi, m, sk.lv0).cpu().numpy() << 4)
           | cipher.lwe_decrypt_message(s_lo, m, sk.lv0).cpu().numpy())
    wrong = np.flatnonzero(got != (va + vb) % 256)

    # The plain path on the first PBS_PLAIN_CHECK pairs and on every wrong
    # one up to one past the guard's bound (a second witness: the plain
    # versions are held to the JAX package word for word by the CPU tests).
    t1 = time.perf_counter()
    witnessed = wrong[:U5_MAX_WRONG + 1]
    idx = torch.from_numpy(np.union1d(np.arange(PBS_PLAIN_CHECK),
                                      witnessed)).to(dev)
    lut_sum, lut_carry = adders.make_adder_luts(ck)
    a_lo, a_hi, b_lo, b_hi = (c[idx] for c in nib)
    plain_lo = engine.bootstrap(ck, a_lo + b_lo, testvec=lut_sum, plain=True)
    carry = engine.bootstrap(ck, a_lo + b_lo, testvec=lut_carry, plain=True)
    plain_hi = engine.bootstrap(ck, a_hi + b_hi + carry, testvec=lut_sum,
                                plain=True)
    check(torch.equal(plain_lo, s_lo[idx]) and torch.equal(plain_hi,
                                                           s_hi[idx]),
          "add8_pbs: the kernel path disagrees with the plain path")
    check(cuda_t.launch_counts == launches, "the plain path launched a kernel")
    done(t1, f"{len(idx)} add8_pbs pairs bit-equal through the plain path "
         f"({len(witnessed)} of the batch's {len(wrong)} wrong sums among "
         "them); ")
    # The first PBS's input (a_lo + b_lo, which the carry's PBS shares) and
    # the third's (a_hi + b_hi + the bootstrapped carry) after the mod
    # switch to 2N, each pair's deviation from its ideal phase.  Beyond the
    # 2^25 half-segment the exact blind rotation selects the neighbouring
    # table entry, whatever computes it (PERF.md §7).
    half = 2 ** 31 // m // 2
    carry = lut.bootstrap_lut(ck, nib[0] + nib[2], lut_carry)
    devs = []
    for ct, ideal in ((nib[0] + nib[2], lo),
                      (nib[1] + nib[3] + carry,
                       (va >> 4) + (vb >> 4) + (lo >= 16))):
        ms = blindrotate.mod_switch_2n(ct, p)
        ms = wrap_i32(ms.to(torch.int64) << p.mod_switch_shift)
        words = cipher.lwe_phase(ms, sk.lv0).cpu().numpy().astype(np.int64)
        devs.append((words - cipher.encode_message(ideal, m).astype(np.int64)
                     + 2 ** 31) % 2 ** 32 - 2 ** 31)
    sig_in, std_in = half / float(devs[1].std()), float(devs[1].std())
    print(f"   add8_pbs third PBS input after the mod switch: std "
          f"2^{np.log2(std_in):.2f}, max |dev| "
          f"2^{np.log2(np.abs(devs[1]).max() + 1):.2f}, margin "
          f"{sig_in:.2f} sigma of the 2^25 half-segment", flush=True)
    for i in witnessed:
        print(f"   wrong sum {i}: {va[i]} + {vb[i]} -> {got[i]}; the plain "
              f"path's words are the same; first PBS input |dev| "
              f"{abs(devs[0][i]) / half:.4f}, third "
              f"{abs(devs[1][i]) / half:.4f} half-segments", flush=True)
        check(max(abs(devs[0][i]), abs(devs[1][i])) >= half,
              f"add8_pbs sum {i} is wrong with both PBS inputs inside "
              "their half-segments")
    sig = min(message_margin(s_lo, sk.lv0, want_lo, m, "add8_pbs low nibble",
                             U5_MIN_SIGMAS, U5_MAX_WRONG),
              message_margin(s_hi, sk.lv0, want_hi, m, "add8_pbs high nibble",
                             U5_MIN_SIGMAS, U5_MAX_WRONG))
    check(np.log2(std_in) <= U5_PBS3_STD_LOG2_MAX,
          f"add8_pbs third PBS input std 2^{np.log2(std_in):.2f} above the "
          f"2^{U5_PBS3_STD_LOG2_MAX} ceiling")
    check(len(wrong) <= U5_MAX_WRONG,
          f"{len(wrong)} add8_pbs sums are not (a + b) mod 256, more than "
          f"the profile's {U5_MAX_WRONG}")
    print(f"   add8_pbs adds/s {U5_BATCH / secs:.1f}; peak memory {peak} B",
          flush=True)
    out["add8_pbs"] = {"batch_s": secs, "adds_per_s": U5_BATCH / secs,
                       "wrong_sums": len(wrong),
                       "margin_sigmas": sig, "peak_bytes": peak,
                       "launches": launches,
                       "pbs3_input_margin_sigmas": sig_in}
    profile_batch("add8_pbs uint5", lambda: adders.add8_pbs(ck, *nib))

    pairs = np.asarray(list(np.ndindex(16, 16)))
    a, b = (np.resize(pairs[:, i], U5_BATCH) for i in range(2))
    ct_a, ct_b = (cipher.lwe_encrypt_message(gen, v, m, p.lwe_alpha, sk.lv0)
                  for v in (a, b))
    out["comparators"] = {}
    for name, truth, per in (("ge", a >= b, 1), ("lt", a < b, 1),
                             ("eq", a == b, 3)):
        res, secs, launches = timed_run(
            f"comparators.{name} batch",
            lambda: getattr(comparators, name)(ck, ct_a, ct_b, m))
        check_counts(launches, dict.fromkeys(K1K2, n), per)
        sig = bool_margin(res, sk.lv0, truth, f"comparators.{name}")
        out["comparators"][name] = {
            "batch_s": secs, "comparisons_per_s": U5_BATCH / secs,
            "margin_sigmas": sig, "launches": launches}
        print(f"   {name} comparisons/s {U5_BATCH / secs:.1f}", flush=True)
    return out


def proxy_phase(gen, dev, p) -> dict:
    """Phase 15: proxy re-encryption at p's level-0 parameters
    (128bit_fast: lwe_n 700, basebit 2, t 9): three users' keys made on
    the card, a public key, a symmetric and an asymmetric re-encryption
    key; PROXY_BATCH bits re-encrypted through each and through a 3-hop
    chain of symmetric keys (alice -> bob -> carol -> alice); every output
    decrypted under its target key (the asymmetric key within its design
    margin, ASYM_MIN_SIGMAS); PROXY_CPU_CHECK ciphertexts of each key
    through the same function on CPU copies, word for word."""
    users = [keys.gen_secret_key(gen, p, dev).lv0 for _ in range(3)]
    alice, bob, carol = users
    out = {}
    t0 = time.perf_counter()
    pk_bob = proxyreenc.gen_public_key(gen, bob, p)
    out["public_key_s"] = done(t0, "public key ")
    t0 = time.perf_counter()
    rk_sym = proxyreenc.gen_reencryption_key_symmetric(gen, alice, bob, p)
    out["symmetric_key_s"] = done(t0, "symmetric re-encryption key ")
    t0 = time.perf_counter()
    rk_asym = proxyreenc.gen_reencryption_key_asymmetric(gen, alice, pk_bob,
                                                         p)
    out["asymmetric_key_s"] = done(t0, "asymmetric re-encryption key ")
    rk_bc = proxyreenc.gen_reencryption_key_symmetric(gen, bob, carol, p)
    rk_ca = proxyreenc.gen_reencryption_key_symmetric(gen, carol, alice, p)
    print(f"   table {rk_sym.table.numel() * 4} B "
          f"{tuple(rk_sym.table.shape)}", flush=True)

    bits = np.random.default_rng(15).integers(0, 2, PROXY_BATCH).astype(bool)
    ct = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits), p.lwe_alpha,
                                 alice)
    ct_pk = proxyreenc.pk_encrypt_bool(gen, pk_bob, bits, p.lwe_alpha)
    bool_margin(ct_pk, bob, bits, "public-key encryption")
    proxyreenc.reencrypt(rk_sym, ct)                       # warm-up
    for label, rk, floor, max_wrong in (
            ("symmetric", rk_sym, MIN_SIGMAS, 0),
            ("asymmetric", rk_asym, ASYM_MIN_SIGMAS, ASYM_MAX_WRONG)):
        res, secs, launches = timed_run(
            f"reencrypt {label}", lambda: proxyreenc.reencrypt(rk, ct))
        check_counts(launches, {}, 0)
        sig = bool_margin(res, bob, bits, f"reencrypt {label}", floor,
                          max_wrong)
        cpu = proxyreenc.reencrypt(
            proxyreenc.ProxyReencryptionKey(rk.table.cpu(), rk.basebit,
                                            rk.t), ct[:PROXY_CPU_CHECK].cpu())
        check(torch.equal(cpu, res[:PROXY_CPU_CHECK].cpu()),
              f"reencrypt {label}: the card disagrees with the CPU")
        print(f"   {PROXY_CPU_CHECK} re-encryptions equal to the CPU's; "
              f"re-encryptions/s {PROXY_BATCH / secs:.1f}", flush=True)
        out[label] = {"batch_s": secs, "reencryptions_per_s":
                      PROXY_BATCH / secs, "margin_sigmas": sig}
    chain, secs, _ = timed_run("3-hop chain", lambda: proxyreenc.reencrypt(
        rk_ca, proxyreenc.reencrypt(rk_bc, proxyreenc.reencrypt(rk_sym,
                                                                 ct))))
    out["three_hop"] = {"batch_s": secs, "margin_sigmas": bool_margin(
        chain, alice, bits, "3-hop chain back to alice")}
    return out


def mesh_phase(dev, p, ck, ct_a, ct_b, want, base_rate: float) -> dict:
    """Phase 16: phase 5's NAND batch through ``parallel``: a mesh of every
    card and a mesh naming ``dev`` MESH_COPIES times (shards of
    BATCH/MESH_COPIES), each equal to phase 5's words with 700 K1/K2
    launches a shard; ``sharded_bootstrap_cuda`` without the key switch
    equal to ``engine.bootstrap_without_key_switch``; with two cards or
    more, a shard on the last card while card 0 is current."""
    prepared = engine.prepare_nand(ct_a, ct_b)
    per_shard = dict.fromkeys(K1K2, p.lwe_n)
    out = {}
    for label, mesh in (
            ("every card", parallel.make_mesh()),
            (f"{dev} x {MESH_COPIES}", parallel.make_mesh([dev] * MESH_COPIES))):
        res, secs, launches = timed_run(
            f"sharded_bootstrap, {len(mesh)} shard(s) ({label})",
            lambda: parallel.sharded_bootstrap(mesh, ck, prepared))
        check_counts(launches, per_shard, len(mesh))
        check(torch.equal(res, want),
              f"the mesh ({label}) disagrees with phase 5's words")
        print(f"   {label}: {BATCH / secs:.1f} gates/s (phase 5 steady "
              f"{base_rate:.1f})", flush=True)
        out[label] = {"shards": len(mesh), "batch_s": secs,
                      "gates_per_s": BATCH / secs, "launches": launches}
    mesh = parallel.make_mesh([dev] * MESH_COPIES)
    res, secs, launches = timed_run(
        "sharded_bootstrap_cuda without the key switch",
        lambda: parallel.sharded_bootstrap_cuda(mesh, ck, prepared,
                                                key_switch=False))
    check_counts(launches, per_shard, len(mesh))
    check(torch.equal(res, engine.bootstrap_without_key_switch(ck, prepared)),
          "sharded_bootstrap_cuda(key_switch=False) disagrees with "
          "engine.bootstrap_without_key_switch")
    out["cuda_no_key_switch"] = {"batch_s": secs, "launches": launches}
    if torch.cuda.device_count() >= 2:
        last = torch.device("cuda", torch.cuda.device_count() - 1)
        with torch.cuda.device(0):
            res, secs, launches = timed_run(
                f"one shard on {last} with cuda:0 current",
                lambda: parallel.sharded_bootstrap(
                    parallel.make_mesh([last]), ck, prepared))
        check_counts(launches, per_shard, 1)
        check(torch.equal(res, want), f"the shard on {last} disagrees")
        out["cross_card"] = {"device": str(last), "batch_s": secs}
    else:
        print("   cross-card launch not measured: one card on this machine",
              flush=True)
    return out


def cost_model_phase(p, ck, ct_a, ct_b, rate: float) -> dict:
    """Phase 17: ``utils.profiling`` at p against phase 5's steady rate
    (0 < mfu <= 1: more would mean the model counts less work than the
    card did), the key's memory against its tensors, and one warm NAND
    batch under ``trace`` whose Chrome trace must name K1 and K2."""
    print(profiling.speed_of_light_report(p, rate), flush=True)
    util = profiling.bootstrap_utilization(p, rate)
    print(f"   bootstrap_utilization: {json.dumps(util)}", flush=True)
    check(0 < util["mfu"] <= 1, f"mfu {util['mfu']} outside (0, 1]")
    mem = profiling.key_memory_usage(ck)
    print(f"   key_memory_usage: {json.dumps(mem)}", flush=True)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (ck.testvec, ck.ksk, ck.bsk, ck.bands))
    check(mem["total"] == nbytes,
          f"key_memory_usage total {mem['total']} != {nbytes} bytes")
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        with profiling.trace(d):
            gates.NAND(ck, ct_a, ct_b)
        scope_s = time.perf_counter() - t1
        files = glob.glob(os.path.join(d, "*.json"))
        check(len(files) == 1, f"trace wrote {files}")
        with open(files[0]) as f:
            text = f.read()
    for kernel in ("rotdec_col::rotdec_kernel", "extprod_t_kernel"):
        check(kernel in text, f"the trace names no {kernel}")
    print(f"   trace: {len(text)} bytes, names K1 and K2; the scope "
          f"(profiler start, one batch, export) {scope_s:.3f} s", flush=True)
    return {**util, "key_bytes": mem["total"], "trace_scope_s": scope_s}


def examples_phase() -> dict:
    """Phase 18: each example program's ``main`` on the card (its output
    kept, printed on failure); each must return 0 with its K1/K2 launch
    counts."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name, argv, steps in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        log = io.StringIO()

        def run():
            with contextlib.redirect_stdout(log):
                return mod.main([*argv, "--device", "cuda"])
        rc, secs, launches = timed_run(f"{name} {' '.join(argv)}", run)
        lines = log.getvalue().splitlines()
        if rc:
            print("\n".join(lines), flush=True)
        check(rc == 0, f"{name} {' '.join(argv)} returned {rc}")
        check_counts(launches, _launches(K1K2, steps,
                                         extprod_t_small=steps), 1)
        print(f"   {name}: {lines[-1]}", flush=True)
        out[name] = {"argv": argv, "seconds": secs, "launches": launches}
    return out


def plain_witness(kind: str, args: tuple, out: torch.Tensor) -> dict:
    """What a measuring core's call of ``kind`` (see entry_runs) needs to be
    held against the plain path after its run: its profile, the outputs'
    wrong count, the kernel words of the first ENTRY_PLAIN_CHECK outputs
    and of as many wrong ones, the plain path on them (a closure), and for
    a PBS core the noise tool's block of the whole batch.  None for the centered extended profiles,
    which phases 8-10 hold to the plain path."""
    ck, sk = args[0], args[1]
    p = ck.params
    if p.message_modulus > 2 and p.centered_decomposition:
        return None
    fig = {"profile": p.name}
    if kind == "nand":
        _, _, ct_a, ct_b, bits_a, bits_b = args
        got = cipher.lwe_decrypt_bool(out, sk.lv0)
        want = ~(bits_a & bits_b)

        def plain(i):
            return engine.bootstrap(
                ck, engine.prepare_nand(ct_a[i], ct_b[i]), plain=True)
    elif kind == "many":
        _, _, ct, want, m, mlut, theta = args
        got = cipher.lwe_decrypt_message(out, m, sk.lv0)
        fig["theta"] = theta

        def plain(i):
            return engine.bootstrap_many(ck, ct[i], mlut, k=1, theta=theta,
                                         plain=True)[0]
    else:
        check(kind in ("identity", "plus_one"), f"unknown core kind {kind}")
        _, _, ct, msgs, table = args
        m = p.message_modulus
        want = msgs if kind == "identity" else (msgs + 1) % m
        got = cipher.lwe_decrypt_message(out, m, sk.lv0)
        fig["noise"] = benchmarking.load_script(
            "tools/torch_noise_margin_pbs.py").pbs_noise(out, sk.lv0, want, m)

        def plain(i):
            return engine.bootstrap(ck, ct[i], testvec=table, plain=True)
    wrong = np.flatnonzero(got.cpu().numpy() != want)
    idx = torch.from_numpy(np.union1d(
        np.arange(min(ENTRY_PLAIN_CHECK, len(want))),
        wrong[:ENTRY_PLAIN_CHECK])).to(out.device)
    fig.update(wrong=len(wrong), checked=len(idx),
               checked_wrong=min(len(wrong), ENTRY_PLAIN_CHECK),
               words=out[idx].clone(), plain=lambda: plain(idx))
    return fig


@contextlib.contextmanager
def witnessed(module: str, name: str, kind: str, calls: list):
    """``module.name``, a measuring core of ``kind`` returning (record,
    outputs, ...), replaced for the run by a spy that appends
    plain_witness's record of each call to ``calls``."""
    mod = sys.modules[module]
    real = getattr(mod, name)

    def spy(*args):
        res = real(*args)
        call = plain_witness(kind, args, res[1])
        if call is not None:
            calls.append(call)
        return res
    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, real)


def run_entry_point(path: str, argv: list, core) -> tuple:
    """The script's ``main(argv)`` on the card, its standard output kept:
    (exit code, its JSON records, the witnessed core calls, seconds,
    launches, peak memory).  The engine's routing flags are restored
    afterwards and must be as they were."""
    mod = benchmarking.load_script(path)
    if core is not None:
        benchmarking.load_script(f"tools/{core[0]}.py"
                                 if core[0].startswith("torch_")
                                 else f"{core[0]}.py")
    flags = (engine.PREFER_BLOCK_ROTATION, engine.PREFER_PIPE,
             blindrotate.FUSED_STEP)
    calls, log = [], io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scope = (witnessed(*core, calls) if core
             else contextlib.nullcontext())
    try:
        with scope, contextlib.redirect_stdout(log):
            rc, secs, launches = timed_run(path, lambda: mod.main(argv))
    finally:
        now = (engine.PREFER_BLOCK_ROTATION, engine.PREFER_PIPE,
               blindrotate.FUSED_STEP)
        (engine.PREFER_BLOCK_ROTATION, engine.PREFER_PIPE,
         blindrotate.FUSED_STEP) = flags
        print(log.getvalue(), end="", flush=True)
    check(now == flags, f"{path} {argv} left the routing flags at {now}")
    records = [json.loads(line) for line in log.getvalue().splitlines()
               if line.startswith("{")]
    return (rc, records, calls, secs, launches,
            torch.cuda.max_memory_allocated())


def entry_points_phase(seed: int, dev, card: dict) -> dict:
    """Phase 21: each measuring entry point's ``main`` in-process at full
    profiles (ENTRY_RUNS: its exit code, its JSON records each naming the
    card, its exact launches), then every witnessed core call's outputs
    (ENTRY_PLAIN_CHECK, and as many of its wrong ones) against the plain
    path, word for word: the new configurations 80bit_fast and
    110bit_fast (>= 8 sigma), uint6 floor (the noise tool), theta 0/1/2,
    floor uint6/7/8 (accuracy beside the noise tool's predicted rate; no
    0-wrong guard: they miss by design) and, through the noise tool's
    core, 128bit_fast with kernel_limb_drop 0 (K2 at lo 0) on keys made
    from ``seed``."""
    out = {}
    records = {}
    for label, path, argv, want_rc, want_launches, core in entry_runs():
        if "scaling" not in path:
            argv = [*argv, "--device", dev.type]
        rc, recs, calls, secs, launches, peak = run_entry_point(
            path, argv, core)
        check(rc == want_rc, f"{path} {argv} returned {rc}, not {want_rc}")
        check(recs, f"{path} {argv} printed no JSON record")
        for rec in recs:
            check(rec["device"] == card,
                  f"{path}: device {rec['device']}, not {card}")
        check_counts(launches, want_launches, 1)
        t1 = time.perf_counter()
        for call in calls:
            check(torch.equal(call.pop("plain")(), call.pop("words")),
                  f"{label} {call['profile']}: the kernel path disagrees "
                  "with the plain path")
        check(cuda_t.launch_counts == launches,
              "the plain path launched a kernel")
        if calls:
            done(t1, f"{sum(c['checked'] for c in calls)} outputs of "
                 f"{len(calls)} core calls bit-equal through the plain "
                 "path; ")
        records[label] = recs
        out[label] = {"argv": argv, "rc": rc, "seconds": secs,
                      "peak_bytes": peak, "launches": launches,
                      "witnessed": calls}
        print(f"   {label}: rc {rc}, {secs:.3f} s, peak memory {peak} B",
              flush=True)

    by = {lab: {r.get("metric", r.get("profile")): r for r in recs}
          for lab, recs in records.items() if lab != "bench_micro"}
    for label in ("bench", "bench_exact", "bench_block", "bench_pipe"):
        rec = records[label][0]
        check(rec["value"] is not None
              and rec["noise"]["margin_sigmas"] >= MIN_SIGMAS,
              f"{label}: {rec}")
    guard = records["bench_selftest_guard"][0]
    check(guard["value"] is None and "error" in guard,
          f"--selftest-guard: {guard}")
    for rec in records["bench_profiles"]:
        check(rec["value"] is not None, f"bench_profiles: {rec}")
    for rec in records["noise_margin"]:
        check(rec["wrong_answers"] == 0
              and rec["margin_sigmas"] >= MIN_SIGMAS, f"noise_margin: {rec}")
    for rec in records["noise_margin_pbs"]:
        check(not rec["profile"].endswith("_centered")
              or rec["wrong_answers"] == 0, f"noise_margin_pbs: {rec}")
    for rec in records["noise_many"]:
        check(rec["theta"] == 2 or rec["wrong_answers"] == 0,
              f"noise_many: {rec}")
    for label in ("bench_ext_uint6", "bench_ext_uint7", "bench_ext_uint8"):
        for rec in records[label]:
            if rec["metric"].endswith("centered_accuracy"):
                check(rec["value"] == 1.0, f"{label}: {rec}")
        for call in out[label]["witnessed"]:
            noise = call["noise"]
            acc = by[label][f"pbs_{call['profile']}_accuracy"]["value"]
            print(f"   {call['profile']}: accuracy {acc:.4f}, the noise "
                  f"tool's predicted {1 - noise['est_error_per_pbs']:.4f} "
                  f"(std 2^{noise['phase_std_log2']}, "
                  f"{noise['margin_sigmas']} sigma)", flush=True)

    # 128bit_fast with kernel_limb_drop 0: the bands keep all four key
    # limbs and K2 runs at lo 0 end to end.  On the same keys (the same
    # seed) it must give 128bit_fast's words: the keys lie on the 2^8
    # grid, so the limb that 128bit_fast drops is zero.
    p0 = dataclasses.replace(params.P128_FAST, name="128bit_fast_drop0",
                             kernel_limb_drop=0)
    nm = benchmarking.load_script("tools/torch_noise_margin.py")
    calls, recs = [], []
    with witnessed("torch_noise_margin", "measure", "nand", calls):
        for p in (p0, params.P128_FAST):
            rec, secs, launches = timed_run(
                p.name, lambda: nm.measure_profile(p, 512, dev, seed=seed)[0])
            check_counts(launches, dict.fromkeys(K1K2, p.lwe_n), 1)
            check(rec["wrong_answers"] == 0
                  and rec["margin_sigmas"] >= MIN_SIGMAS, f"{p.name}: {rec}")
            print(f"   {json.dumps(rec)}", flush=True)
            recs.append(rec)
    check(torch.equal(calls[0].pop("plain")(), calls[0]["words"]),
          f"{p0.name}: the kernel path disagrees with the plain path")
    check(torch.equal(calls[0].pop("words"), calls[1].pop("words"))
          and {**recs[0], "profile": ""} == {**recs[1], "profile": ""},
          f"{p0.name}: other words or noise than {params.P128_FAST.name}'s "
          "on the same keys")
    calls[1].pop("plain")
    out["noise_margin_drop0"] = {"seconds": secs, "launches": launches,
                                 "records": recs, "witnessed": calls}
    return {"runs": out, "records": records}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="one more warm batch of each path of phases 5, "
                    "7-12 and 19, the 8-bit ripple add and add8_pbs under "
                    "torch.profiler (kernel breakdown, idle)")
    args = ap.parse_args()
    global PROFILE
    PROFILE = args.profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    card = benchmarking.device_info(dev)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s)", flush=True)
    done(t0)

    t0 = phase("2. build the kernels from csrc/")
    built = _build.build()
    _build.load_library()
    print(f"   nvcc seconds: {built['seconds']:.2f} -> {built['path']}")
    for line in ptxas_report(built["log"]):
        print(f"   {line}")
    done(t0)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = phase("3. kernels against their plain versions")
    shape_times = {}
    errs, times, lib = kernels_against_plain(gen, dev, shape_times)
    ext_kernels_against_plain(gen, dev, errs, times, lib, shape_times)
    shape_times.update(rowmajor_kernels_against_plain(gen, dev, errs, times,
                                                      lib))
    gen_k9 = torch.Generator(device=dev).manual_seed(args.seed + 1)
    shape_times.update(step_pipe_kernels_against_plain(gen, gen_k9, dev,
                                                       errs, times))
    done(t0)

    p = params.P128_FAST
    t0 = phase(f"4. keygen on the card at {p.name}")
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    keygen_s = done(t0, "keygen ")
    nbytes = {f: getattr(ck, f).numel() * getattr(ck, f).element_size()
              for f in ("ksk", "bsk", "bands")}
    print(f"   bytes: ksk {nbytes['ksk']}, bsk {nbytes['bsk']}, "
          f"bands {nbytes['bands']}", flush=True)
    check(not (ck.bsk & 0xFF).any().item(), "BSK is off the key grid")

    t0 = phase(f"5. NAND batch of {BATCH} through engine.bootstrap")
    bits_a = np.resize([False, True], BATCH)
    bits_b = np.resize([False, False, True, True], BATCH)
    ct_a = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_a),
                                   p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_b),
                                   p.lwe_alpha, sk.lv0)
    torch.cuda.synchronize()
    cuda_t.reset_launch_counts()
    calls = 0
    t1 = time.perf_counter()
    out = gates.NAND(ck, ct_a, ct_b)
    calls += 1
    first_s = done(t1, "first batch ")
    steady = []
    for _ in range(2):
        t1 = time.perf_counter()
        out2 = gates.NAND(ck, ct_a, ct_b)
        calls += 1
        steady.append(done(t1, "steady batch "))
    t1 = time.perf_counter()
    one = gates.NAND(ck, ct_a[:1], ct_b[:1])
    calls += 1
    latency_s = done(t1, "one-gate batch ")
    launches = dict(cuda_t.launch_counts)
    print(f"   launches over {calls} bootstrap calls: {launches}",
          flush=True)
    # the one-gate batch's K2 launches take the small form
    check_counts(launches, _launches(K1K2, p.lwe_n * calls,
                                     extprod_t_small=p.lwe_n), 1)

    check(out.shape == (BATCH, p.lwe_n + 1) and out.dtype == torch.int32,
          f"unexpected output {tuple(out.shape)} {out.dtype}")
    check(torch.equal(out, out2), "two runs of one batch disagree")
    want = ~(bits_a & bits_b)
    dec = cipher.lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
    wrong = int((dec != want).sum())
    check(wrong == 0, f"{wrong}/{BATCH} NAND outputs decrypt wrong")
    check(bool(cipher.lwe_decrypt_bool(one, sk.lv0).item()) == bool(want[0]),
          "the one-gate batch decrypts wrong")
    sigmas, std, worst = margin_sigmas(
        cipher.lwe_phase(out, sk.lv0).cpu().numpy(),
        np.where(want, MARGIN, -MARGIN), MARGIN)
    print(f"   phase noise std 2^{np.log2(std):.2f}, max |dev| "
          f"2^{np.log2(worst + 1):.2f}, margin {sigmas:.1f} sigma",
          flush=True)
    check(sigmas >= MIN_SIGMAS,
          f"noise margin {sigmas:.1f} sigma below {MIN_SIGMAS}")
    steady_rate = BATCH / (sum(steady) / len(steady))
    print(f"   gates/s: first batch {BATCH / first_s:.1f}, steady "
          f"{steady_rate:.1f}; one-gate latency {latency_s * 1e3:.1f} ms; "
          f"peak memory {torch.cuda.max_memory_allocated()} B", flush=True)
    done(t0)

    t0 = phase(f"6. {PLAIN_CHECK} gates through the plain versions")
    prepared = engine.prepare_nand(ct_a[:PLAIN_CHECK], ct_b[:PLAIN_CHECK])
    plain_out = engine.bootstrap(ck, prepared, plain=True)
    check(torch.equal(plain_out, out[:PLAIN_CHECK]),
          "the kernel path disagrees with the plain path")
    check(cuda_t.launch_counts == launches,
          "the plain path launched a kernel")
    done(t0, "bit-equal; ")
    profile_batch("NAND (blind_rotate_t)", lambda: gates.NAND(ck, ct_a, ct_b))

    t0 = phase(f"7. AND_OR batch of {BATCH} through engine.bootstrap_many")
    torch.cuda.synchronize()
    cuda_t.reset_launch_counts()
    t1 = time.perf_counter()
    out_and, out_or = gates.AND_OR(ck, ct_a, ct_b)
    and_or_s = done(t1, "batch ")
    and_or_launches = dict(cuda_t.launch_counts)
    print(f"   launches: {and_or_launches}", flush=True)
    check_counts(and_or_launches, dict.fromkeys(K1K2, p.lwe_n), 1)
    and_or_sigmas = []
    for name, got, truth in (("AND", out_and, bits_a & bits_b),
                             ("OR", out_or, bits_a | bits_b)):
        dec = cipher.lwe_decrypt_bool(got, sk.lv0).cpu().numpy()
        wrong = int((dec != truth).sum())
        check(wrong == 0, f"{wrong}/{BATCH} {name} outputs decrypt wrong")
        sig, std, worst = margin_sigmas(
            cipher.lwe_phase(got, sk.lv0).cpu().numpy(),
            np.where(truth, MARGIN, -MARGIN), MARGIN)
        print(f"   {name}: {BATCH}/{BATCH} right, phase noise std "
              f"2^{np.log2(std):.2f}, max |dev| 2^{np.log2(worst + 1):.2f}, "
              f"margin {sig:.1f} sigma", flush=True)
        check(sig >= MIN_SIGMAS,
              f"{name} noise margin {sig:.1f} sigma below {MIN_SIGMAS}")
        and_or_sigmas.append(sig)
    plain_and_or = engine.bootstrap_many(
        ck, ct_a[:PLAIN_CHECK] + ct_b[:PLAIN_CHECK],
        gates.and_or_lut(p, dev), k=2, theta=1, plain=True)
    check(torch.equal(plain_and_or[0], out_and[:PLAIN_CHECK])
          and torch.equal(plain_and_or[1], out_or[:PLAIN_CHECK]),
          "AND_OR: the kernel path disagrees with the plain path")
    check(cuda_t.launch_counts == and_or_launches,
          "the plain path launched a kernel")
    done(t0, f"{PLAIN_CHECK} pairs bit-equal through the plain path; ")
    profile_batch("AND_OR", lambda: gates.AND_OR(ck, ct_a, ct_b))

    m6 = params.UINT6_CENTERED.message_modulus
    t0 = phase(f"8. {params.UINT6_CENTERED.name} PBS, batch {UINT6_BATCH}, "
               "through lut.bootstrap_func")
    u6 = pbs_phase(gen, dev, params.UINT6_CENTERED, UINT6_BATCH,
                   lambda x: (3 * x + 1) % m6, steady=True, keep=True)
    check(u6["margin_sigmas"] >= MIN_SIGMAS,
          f"uint6 noise margin {u6['margin_sigmas']:.1f} sigma below "
          f"{MIN_SIGMAS}")
    done(t0)

    m7 = params.UINT7_CENTERED.message_modulus
    t0 = phase(f"9. {params.UINT7_CENTERED.name} PBS, batch {UINT7_BATCH}, "
               "through lut.bootstrap_func")
    u7 = pbs_phase(gen, dev, params.UINT7_CENTERED, UINT7_BATCH,
                   lambda x: (5 * x + 3) % m7, steady=False)
    done(t0)

    m8 = params.UINT8_CENTERED.message_modulus
    t0 = phase(f"10. {params.UINT8_CENTERED.name} PBS, batch {UINT8_BATCH}, "
               "through lut.bootstrap_func")
    torch.cuda.empty_cache()
    u8 = pbs_phase(gen, dev, params.UINT8_CENTERED, UINT8_BATCH,
                   lambda x: (7 * x + 5) % m8, steady=True, kernels=K6K8)
    check(u8["margin_sigmas"] >= MIN_SIGMAS,
          f"uint8 noise margin {u8['margin_sigmas']:.1f} sigma below "
          f"{MIN_SIGMAS}")
    done(t0)

    t0 = phase(f"11. block NAND batch of {BATCH} at {p.name}, block-binary "
               "key, PREFER_BLOCK_ROTATION on and off")
    torch.cuda.empty_cache()
    blk = block_nand_phase(gen, dev, p, bits_a, bits_b)
    done(t0)

    t0 = phase(f"12. NAND batch of {BATCH} at {p.name} through the per-bit "
               "routes: K1 + K2, (a) K3, (b) K7 + K8, (c) K1 + K9")
    torch.cuda.empty_cache()
    per_bit = per_bit_routes_phase(p, ck, sk, ct_a, ct_b, bits_a, bits_b,
                                   out)
    base = per_bit["k1k2"]["gates_per_s"]
    for label, fig in per_bit.items():
        print(f"   {label:10s} {fig['gates_per_s']:9.1f} gates/s "
              f"({fig['gates_per_s'] / base:.3f} x K1 + K2), margin "
              f"{fig['margin_sigmas']:.1f} sigma", flush=True)
    done(t0)

    t0 = phase(f"13. boolean circuits at {p.name}, batch {BATCH}: NOT, "
               "COPY, constant, MUX, MUX_3GATE, 8-bit ripple-carry and "
               "many-LUT adds")
    torch.cuda.empty_cache()
    circ = circuits_phase(gen, p, ck, sk)
    circuits_s = done(t0)

    t0 = phase(f"14. {U5.name} on the card: add8_pbs and comparators, batch "
               f"{U5_BATCH}")
    torch.cuda.empty_cache()
    u5 = uint5_phase(gen, dev)
    done(t0)

    t0 = phase(f"15. proxy re-encryption at {p.name}'s level 0, batch "
               f"{PROXY_BATCH}")
    torch.cuda.empty_cache()
    proxy = proxy_phase(gen, dev, p)
    done(t0)

    t0 = phase(f"16. the mesh: NAND batch of {BATCH} at {p.name} through "
               "parallel.sharded_bootstrap")
    torch.cuda.empty_cache()
    mesh = mesh_phase(dev, p, ck, ct_a, ct_b, out, steady_rate)
    mesh_s = done(t0)

    t0 = phase(f"17. the cost model at {p.name}: speed of light, "
               "utilization, key memory, trace")
    cost = cost_model_phase(p, ck, ct_a, ct_b, steady_rate)
    cost_s = done(t0)

    t0 = phase("18. the five examples on the card")
    torch.cuda.empty_cache()
    ex = examples_phase()
    examples_s = done(t0)

    t0 = phase(f"19. NAND batch of {BATCH} at {params.P128.name}: K1 + K2 "
               "and (c) K1 + K9 at l 3")
    torch.cuda.empty_cache()
    exact = exact_phase(gen, dev, bits_a, bits_b)
    exact_s = done(t0)

    t0 = phase(f"20. the portable path (no kernel) at {p.name}: NAND, block "
               "NAND, uint6 and AND_OR against phases 5, 11, 8 and 7; step "
               "times")
    torch.cuda.empty_cache()
    gen_p = torch.Generator(device=dev).manual_seed(args.seed + 2)
    portable = portable_phase(gen_p, dev, p, ck, ct_a, ct_b, out,
                              (out_and, out_or), u6.pop("run"),
                              blk.pop("run"), times["extprod_t"][0])
    portable["phase_s"] = done(t0)

    t0 = phase("21. the measuring entry points through their main: "
               "bench_torch (4 ways + --selftest-guard), the bench and noise "
               "tools, bench_micro_torch, bench_scaling_torch; "
               "128bit_fast drop 0")
    torch.cuda.empty_cache()
    entry = entry_points_phase(args.seed + 3, dev, card)
    entry_s = done(t0)

    runs = {"nand": launches, "and_or": and_or_launches,
            "uint6_centered": u6["launches"],
            "uint7_centered": u7["launches"],
            "uint8_centered": u8["launches"],
            "block_nand": blk["block"]["launches"],
            "block_key_per_bit_nand": blk["per_bit"]["launches"],
            **{f"per_bit_{label}": fig["launches"]
               for label, fig in per_bit.items()},
            **{f"circuits_{label}": fig["launches"]
               for label, fig in circ.items()},
            "uint5_add8_pbs": u5["add8_pbs"]["launches"],
            **{f"uint5_{name}": fig["launches"]
               for name, fig in u5["comparators"].items()},
            **{f"mesh_{label}": fig["launches"]
               for label, fig in mesh.items() if "launches" in fig},
            **{f"example_{name}": fig["launches"]
               for name, fig in ex.items()},
            **{f"exact_{label}": fig["launches"]
               for label, fig in exact.items() if label in ROUTES},
            **{f"entry_{label}": fig["launches"]
               for label, fig in entry["runs"].items()}}
    u6p, u8p = params.UINT6_CENTERED, params.UINT8_CENTERED
    # name: (source, TPU kernel, the timed shape: profile, batch, rows)
    kernels = {
        "rotate_decompose_t": ("rotdec_t.cu", "pallas_t.py:122",
                               (p, BATCH, 0)),
        "extprod_t": ("extprod_t.cu", "pallas_t.py:210", (p, BATCH, 0)),
        "extprod_t_small": ("extprod_t_small.cu", "pallas_t.py:210",
                            (params.P128, 1, 0)),
        "fused_rotate_step": ("step.cu", "pallas_step.py:140",
                              (p, BATCH, 0)),
        "rotate_decompose_ext_t": ("rotdec_ext_t.cu", "pallas_t.py:348",
                                   (u6p, UINT6_BATCH, 0)),
        "extprod_ext_t": ("extprod_ext_t.cu", "pallas_t.py:433",
                          (u6p, UINT6_BATCH, 0)),
        "rotate_decompose_ext": ("rotdec_ext.cu", "pallas_ext.py:128",
                                 (u8p, UINT8_BATCH, 0)),
        "rotate_decompose": ("rotdec.cu", "pallas_rotate.py:99",
                             (p, BATCH, 12)),
        "extprod": ("extprod.cu", "pallas_extprod.py:180", (p, BATCH, 12)),
        "pipe_step": ("pipe.cu", "pallas_pipe.py:174", (p, PIPE_HALF, 0))}
    entries = []
    for name, (src, rep, shape) in kernels.items():
        bound_ms, bound_by = kernel_bound(name, *shape)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"go_tfhe_tpu_torch/csrc/{src}",
            "replaces": f"go_tfhe_tpu/ops/{rep}",
            "launches": sum(run[name] for run in runs.values()),
            "max_abs_err": errs[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib.get(name)})
    shape_bounds = {f"rotate_decompose_t {p.name} B={BATCH}, eager loop": (
                        "rotate_decompose_t", p, BATCH, 0),
                    f"rotate_decompose_t {p.name} B={BATCH}, L2 evicted": (
                        "rotate_decompose_t", p, BATCH, 0),
                    f"rotate_decompose_t {params.P128.name} B={BATCH}": (
                        "rotate_decompose_t", params.P128, BATCH, 0),
                    f"rotate_decompose_t {params.UINT4.name} B=2048": (
                        "rotate_decompose_t", params.UINT4, 2048, 0),
                    f"rotate_decompose_t {U5.name} B={U5_BATCH}": (
                        "rotate_decompose_t", U5, U5_BATCH, 0),
                    f"extprod_t {U5.name} B={U5_BATCH}": (
                        "extprod_t", U5, U5_BATCH, 0),
                    f"extprod_t_small {p.name} B=1": (
                        "extprod_t_small", p, 1, 0),
                    f"extprod_t_small {U5.name} B=1": (
                        "extprod_t_small", U5, 1, 0),
                    f"rotate_decompose_ext_t {params.UINT6_CENTERED.name} "
                    f"B={UINT6_BATCH}, eager loop": (
                        "rotate_decompose_ext_t", params.UINT6_CENTERED,
                        UINT6_BATCH, 0),
                    f"rotate_decompose_ext_t {params.UINT7_CENTERED.name} "
                    f"B={UINT7_BATCH}": ("rotate_decompose_ext_t",
                                         params.UINT7_CENTERED, UINT7_BATCH,
                                         0),
                    "rotate_decompose bs=1 B=4096": ("rotate_decompose",
                                                     p, BATCH, 4),
                    "rotate_decompose bs=1 B=4096, eager loop": (
                        "rotate_decompose", p, BATCH, 4),
                    "rotate_decompose bs=3 B=4096, eager loop": (
                        "rotate_decompose", p, BATCH, 12),
                    f"rotate_decompose_ext {u8p.name} B={UINT8_BATCH}, "
                    "eager loop": ("rotate_decompose_ext", u8p, UINT8_BATCH,
                                   0),
                    f"pipe_step halves {PIPE_HALF}/{PIPE_HALF}, graph": (
                        "pipe_step", p, PIPE_HALF, 0),
                    # no Y half: the X half is K2's work on one half
                    f"pipe_step halves {PIPE_HALF}/0, graph": (
                        "extprod_t", p, PIPE_HALF, 0),
                    f"rotate_decompose_t {p.name} B={PIPE_HALF}": (
                        "rotate_decompose_t", p, PIPE_HALF, 0),
                    f"pipe_step {params.P128.name} halves {PIPE_HALF}/"
                    f"{PIPE_HALF}, graph": ("pipe_step", params.P128,
                                            PIPE_HALF, 0),
                    f"pipe_step {params.P128.name} halves {PIPE_HALF}/0, "
                    "graph": ("extprod_t", params.P128, PIPE_HALF, 0),
                    f"rotate_decompose_t {params.P128.name} B={PIPE_HALF}": (
                        "rotate_decompose_t", params.P128, PIPE_HALF, 0),
                    "extprod 4 rows B=4096": ("extprod", p, BATCH, 4),
                    "extprod uint8 B'=2304": ("extprod", u8p, UINT8_BATCH,
                                              0)}
    for key, (name, *shape) in shape_bounds.items():
        shape_times[key]["bound_ms"], shape_times[key]["bound_by"] = (
            kernel_bound(name, *shape))
    print(json.dumps({"entry_points": {
        "phase_s": entry_s, "records": entry["records"],
        "runs": {label: {k: v for k, v in fig.items() if k != "launches"}
                 for label, fig in entry["runs"].items()}}}), flush=True)
    print(json.dumps({
        "kernels": entries,
        "keygen_s": keygen_s, "first_batch_s": first_s,
        "steady_gates_per_s": steady_rate, "one_gate_s": latency_s,
        "margin_sigmas": sigmas,
        "and_or_batch_s": and_or_s, "and_or_margin_sigmas": and_or_sigmas,
        "uint6_centered": {k: v for k, v in u6.items() if k != "launches"},
        "uint7_centered": {k: v for k, v in u7.items() if k != "launches"},
        "uint8_centered": {k: v for k, v in u8.items() if k != "launches"},
        "block_nand": {"keygen_s": blk["keygen_s"], **{
            mode: {k: v for k, v in blk[mode].items() if k != "launches"}
            for mode in ("block", "per_bit")}},
        "per_bit_routes": {label: {k: v for k, v in fig.items()
                                   if k != "launches"}
                           for label, fig in per_bit.items()},
        "circuits": {"phase_s": circuits_s, **{
            label: {k: v for k, v in fig.items() if k != "launches"}
            for label, fig in circ.items()}},
        "uint5": {"keygen_s": u5["keygen_s"],
                  "keygen_peak_bytes": u5["keygen_peak_bytes"],
                  "add8_pbs": {k: v for k, v in u5["add8_pbs"].items()
                               if k != "launches"},
                  "comparators": {name: {k: v for k, v in fig.items()
                                         if k != "launches"}
                                  for name, fig in u5["comparators"].items()}},
        "proxy_reencryption": proxy,
        "mesh": {"phase_s": mesh_s, **{
            label: {k: v for k, v in fig.items() if k != "launches"}
            for label, fig in mesh.items()}},
        "cost_model": {"phase_s": cost_s, **cost},
        "examples": {"phase_s": examples_s, **{
            name: {k: v for k, v in fig.items() if k != "launches"}
            for name, fig in ex.items()}},
        "exact_128bit": {"phase_s": exact_s, "keygen_s": exact["keygen_s"],
                         **{label: {k: v for k, v in fig.items()
                                    if k != "launches"}
                            for label, fig in exact.items()
                            if label in ROUTES}},
        "kernel_shape_times": shape_times,
        "path_launches": runs,
        "portable": portable}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
