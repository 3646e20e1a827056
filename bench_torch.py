"""Headline benchmark of the PyTorch/CUDA port (go_tfhe_tpu_torch): gate
bootstraps per second on one card, at 128-bit parameters.

The port's counterpart of bench.py.  Prints ONE JSON line, bench.py's keys
and metric name ({"metric", "value", "unit", "vs_baseline", ...config,
utilization and the measured noise margin}) plus "device": the card's name
and power limit as nvidia-smi reads them.  Baseline: the Go reference does
a single 128-bit gate bootstrap in ~100-150 ms on a modern CPU core
(README.md:131,398) => ~8 bootstraps/sec.

Headline configuration (every field stated in the JSON): profile
"128bit_fast" (the 128-bit crypto parameters with the bgbit=8/l=2 gadget;
the bands drop the lowest of the 4 key limbs), uniform binary secret keys,
per-bit blind rotation (kernels K1 + K2), through the public
``engine.bootstrap``.  Batch 4096 on the card, 64 on the host.

Flags: --exact = the reference's bgbit=6/l=3 gadget (``128bit``, no limb
dropped); --block = block-binary keys + the block rotation
(``engine.PREFER_BLOCK_ROTATION``: K7 + K8); --pipe = the half-batch
pipelined rotation (``engine.PREFER_PIPE``: K1 + K9); --batch N;
--profile NAME (a toy profile for a host run); --device cpu runs the
kernels' plain versions on the host (the default is the card, and without
one the run raises).

The guard checks a varying NAND truth table over the whole batch before
any timing: a wrong answer, or a phase-noise margin below MIN_SIGMAS,
prints "value": null with the error and exits 1.  --selftest-guard
demonstrates it: it masks the low 16 bits of every word of a copy of the
cloud key's bands and BSK, an error far past the noise budget, so the run
must exit 1.

Run:  python bench_torch.py [--exact | --block | --pipe] [--batch N]
      [--selftest-guard] [--device cpu --profile test_fast]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from go_tfhe_tpu_torch import cipher, engine, keys, params  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402
from go_tfhe_tpu_torch.utils.profiling import bootstrap_utilization  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import i32  # noqa: E402

METRIC = "gate_bootstraps_per_sec_per_chip_128bit"
REFERENCE_BOOTSTRAPS_PER_SEC = 8.0   # 1 / 0.125 s (README.md:398 midpoint)
# Phase-margin floor of the guard: 8 sigma ~= 1e-15 error per gate
# (bench.py:49).
MIN_SIGMAS = 8.0
SEED = 0        # bench.py's PRNGKey(0)
# --selftest-guard keeps the high 16 bits of each key word.
SELFTEST_MASK = i32(0xFFFF0000)


def nand(ck: keys.CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor
         ) -> torch.Tensor:
    return engine.bootstrap(ck, engine.prepare_nand(ct_a, ct_b))


def measure(ck: keys.CloudKey, sk: keys.SecretKey, ct_a: torch.Tensor,
            ct_b: torch.Tensor, bits_a: np.ndarray, bits_b: np.ndarray
            ) -> tuple:
    """The first NAND batch: ({"first_batch_s", "wrong_answers", "noise",
    "margin_sigmas"}, outputs), every answer against NOT(a AND b) and the
    phase noise against the 2^29 margin (bench.py:111-133)."""
    t0 = time.perf_counter()
    out = nand(ck, ct_a, ct_b)
    bm.synchronize(out.device)
    first = time.perf_counter() - t0
    wrong, noise, sigmas, _ = bm.bool_noise(out, sk.lv0, ~(bits_a & bits_b))
    return {"first_batch_s": first, "wrong_answers": wrong, "noise": noise,
            "margin_sigmas": sigmas}, out


def guard_error(wrong: int, sigmas: float, batch: int) -> str | None:
    """bench.py's self-guard: every answer right and the margin at least
    MIN_SIGMAS, else the error to report."""
    if wrong:
        return f"{wrong}/{batch} truth-table mismatches"
    if sigmas < MIN_SIGMAS:
        return (f"noise margin {sigmas:.1f} sigma below the {MIN_SIGMAS} "
                "sigma floor")
    return None


def steady_seconds(ck: keys.CloudKey, ct_a: torch.Tensor, ct_b: torch.Tensor,
                   reps: int) -> float:
    """Seconds per NAND batch over ``reps`` queued batches, one
    synchronization at the end (bench.py:153-159)."""
    bm.synchronize(ct_a.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        nand(ck, ct_a, ct_b)
    bm.synchronize(ct_a.device)
    return (time.perf_counter() - t0) / reps


def masked_copy(ck: keys.CloudKey) -> keys.CloudKey:
    """A copy of ``ck`` whose bands and BSK keep only the high 16 bits of
    each word (the port's counterpart of bench.py:86-98); ``ck`` itself is
    untouched."""
    return dataclasses.replace(ck, bands=ck.bands & SELFTEST_MASK,
                               bsk=ck.bsk & SELFTEST_MASK)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exact", action="store_true",
                    help="the 128bit profile (the reference's gadget)")
    ap.add_argument("--block", action="store_true",
                    help="block-binary keys and the block rotation")
    ap.add_argument("--pipe", action="store_true",
                    help="the half-batch pipelined rotation (K1 + K9)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 4096 on the card, 64 on the host")
    ap.add_argument("--selftest-guard", action="store_true",
                    help="mask a copy of the key: the guard must exit 1")
    ap.add_argument("--profile", default=None,
                    help="default 128bit_fast (128bit with --exact)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bm.card_or_host(args.device)
    on_card = dev.type == "cuda"
    p = params.get_params(args.profile or
                          ("128bit" if args.exact else "128bit_fast"))
    batch = args.batch or (4096 if on_card else 64)
    flags = engine.PREFER_BLOCK_ROTATION, engine.PREFER_PIPE
    try:
        engine.PREFER_BLOCK_ROTATION = flags[0] or args.block
        engine.PREFER_PIPE = flags[1] or args.pipe
        return run(p, batch, dev, args)
    finally:
        engine.PREFER_BLOCK_ROTATION, engine.PREFER_PIPE = flags


def run(p: params.TFHEParams, batch: int, dev: torch.device,
        args: argparse.Namespace) -> int:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    sk = keys.gen_secret_key(gen, p, dev, block_binary=args.block)
    ck = keys.gen_cloud_key(gen, sk, p)
    bm.synchronize(dev)
    t_keygen = time.perf_counter() - t0
    if args.selftest_guard:
        ck = masked_copy(ck)

    bits_a = np.resize([False, True], batch)
    bits_b = np.resize([False, False, True, True], batch)
    ct_a = cipher.lwe_encrypt_bool(gen, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, bits_b, p.lwe_alpha, sk.lv0)
    first, _ = measure(ck, sk, ct_a, ct_b, bits_a, bits_b)
    device = bm.device_info(dev)

    error = guard_error(first["wrong_answers"], first["margin_sigmas"], batch)
    if error:
        print(json.dumps({"metric": METRIC, "value": None,
                          "unit": "bootstraps/s", "error": error,
                          "profile": p.name, "noise": first["noise"],
                          "device": device}), flush=True)
        return 1

    reps = 5 if dev.type == "cuda" else 2
    value = batch / steady_seconds(ck, ct_a, ct_b, reps)
    print(json.dumps({
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "bootstraps/s",
        "vs_baseline": round(value / REFERENCE_BOOTSTRAPS_PER_SEC, 2),
        "profile": p.name,
        "key_distribution": "block_binary" if args.block else "uniform_binary",
        "rotation": ("block" if args.block else
                     "per_bit_pipelined" if engine.PREFER_PIPE
                     else "per_bit"),
        "route": engine._route(ck),
        "gadget": f"bgbit={p.bgbit},l={p.l}",
        "kernel_limbs": 4 - p.kernel_limb_drop,
        "batch": batch,
        "api": "engine.bootstrap",
        "keygen_s": round(t_keygen, 2),
        "first_batch_s": round(first["first_batch_s"], 2),
        "utilization": bootstrap_utilization(p, value),
        "noise": first["noise"],
        "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
