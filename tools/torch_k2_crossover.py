"""K2's two forms against each other on one CUDA card: the tensor-core tile
(``csrc/extprod_t.cu``) and the small-batch form on the CUDA cores
(``csrc/extprod_t_small.cu``), at the shapes of the 128-bit and uint5
profiles, over a range of batches; the crossover is the largest batch at
which the small form is the faster.

    python3 tools/torch_k2_crossover.py [--batches 1,2,4,...] [--steps 100]
        [--seed S] [--out FILE]

Each batch's digits, accumulator and a rotation's worth of bands (the
profile's lwe_n of them, 69-70 MB, more than the card's L2 holds, as in a
real rotation) are drawn from the seed.  Both forms' outputs are first held
to each other, and to the plain version at batches up to 4; then each form
runs ``--steps`` launches, one band after the other, captured in one CUDA
graph and replayed between CUDA events: device time a launch, without the
host's launch cost.  Prints one JSON line: the card, its power limit, and
per profile the microseconds a launch of each form by batch, the plain
version's at B 1 (an eager loop of 5 calls between CUDA events), and the
crossover.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from go_tfhe_tpu_torch import params  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_t  # noqa: E402

BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
PROFILES = ("128bit", "uint5")


def graph_us(fn, steps: int) -> float:
    """Mean device µs of fn(i) for i < steps, captured in one CUDA graph
    and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(steps):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1000.0 * start.elapsed_time(end) / steps


def eager_us(fn, reps: int) -> float:
    """Mean device µs of fn() over reps calls between two CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1000.0 * start.elapsed_time(end) / reps


def measure(p, batches, steps: int, gen) -> dict:
    n, l2, nd, lo = p.n, 2 * p.l, p.digit_limbs, cuda_t.band_limb_drop(p)
    bands = torch.randint(-2 ** 31, 2 ** 31, (p.lwe_n, 2, l2, 2 * n),
                          dtype=torch.int32, device="cuda", generator=gen)
    rows = {}
    for b in batches:
        digits = torch.randint(-128, 128, (nd * l2 * n, b), dtype=torch.int8,
                               device="cuda", generator=gen)
        acc = torch.randint(-2 ** 31, 2 ** 31, (2, n, b), dtype=torch.int32,
                            device="cuda", generator=gen)

        def form(small):
            return lambda i: cuda_t._extprod_t_launch(
                digits, bands[i % p.lwe_n], acc, nd, lo, small)

        def plain():
            return cuda_t.extprod_t_ref(digits, bands[0], acc, nd, lo)

        small, tile = form(True)(0), form(False)(0)
        exact = torch.equal(small, tile)
        if b <= 4:
            exact = exact and torch.equal(small, plain())
        takes = cuda_t.takes_small_form(b) and cuda_t.small_form_fits(
            acc.device, n, b, l2, nd)
        rows[b] = {"small_us": graph_us(form(True), steps),
                   "tile_us": graph_us(form(False), steps), "exact": exact,
                   "takes_small_form": takes}
        if b == 1:
            rows[b]["plain_us"] = eager_us(plain, 5)
        print(p.name, b, rows[b], file=sys.stderr, flush=True)
    faster = [b for b, r in rows.items() if r["small_us"] < r["tile_us"]]
    return {"n": n, "l2": l2, "nd": nd, "lo": lo, "by_batch": rows,
            "crossover": max(faster) if faster else 0,
            "small_batch_max": cuda_t.SMALL_BATCH_MAX}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=18)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    batches = [int(b) for b in args.batches.split(",")]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "power_limit": limit,
              "steps": args.steps}
    for name in PROFILES:
        result[name] = measure(params.get_params(name), batches, args.steps,
                               gen)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(r["exact"] for name in PROFILES
                    for r in result[name]["by_batch"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
