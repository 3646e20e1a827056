"""The control of the benchmark's comparison: the plain reference that the
cell's configuration names, put in the program's place, computed in the
nearest precision below the one the configurations state, and judged by
the comparison that decides a run's ``correct``.

The configurations state exact 32-bit torus arithmetic.  The control keeps
24 bits of every key word (the lowest base-256 limb dropped, the step a
faster int8 external product would take: 3 of 4 key limbs at 128-bit, 6
of 9 limb pairs at uint5).  For each seed it makes a run's data, computes
what the control would return for the calls that a run compares (every
distinct batch once; a chain of ``--calls`` requests, each on the
control's previous output), and prints the number compared,
``mismatched_ciphertexts``, which the control must push over its limit 0.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13
                                 [--calls N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

# The key words' bits in the control: the nearest precision below the
# configurations' 32.
KEY_BITS = 24


def control_run(cell: harness.Cell, seed: int, calls: int, key_bits: int,
                device) -> dict:
    """One seed: the control in the program's place, then the judge."""
    r = harness.Run(cell, seed, 0.0, device, time.time())
    r.make_data()
    t0 = time.time()
    dev = r.device
    control = cell.ref.Bootstrap(
        r.prm, torch.from_numpy(r.raw["bsk"].view("int32")).to(dev),
        torch.from_numpy(r.raw["ksk"].view("int32")).to(dev), key_bits)
    tv = torch.from_numpy(r.raw["testvec"].view("int32")).to(dev)
    tr = r.traffic
    r.outs, r.digests, prev = [], [], None
    if tr.chain:
        for k in range(calls):
            out = tr.reference(control, tr.request(r.inputs, k, prev), tv)
            r.outs.append(out)
            prev = out
        r.calls = calls
    else:
        for k in range(tr.mix["distinct_batches"]):
            r.digests.append(harness.digest(
                tr.reference(control, tr.request(r.inputs, k), tv),
                r.weights))
        r.calls = len(r.digests)
    control_s = time.time() - t0
    del control
    verdict = r.judge()
    return {"seed": seed, "calls": r.calls, "attempted": verdict["attempted"],
            "mismatched_ciphertexts": verdict["failed"],
            "wrong_plaintexts_of_reference": verdict["wrong_plaintexts"],
            "control_s": control_s, "reference_s": verdict["reference_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--calls", type=int, default=200,
                    help="requests of a chain (batch mixes: every distinct "
                         "batch once)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    rows = [control_run(cell, int(s), args.calls, KEY_BITS, "cuda:0")
            for s in args.seeds.split(",")]
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": cell.name, "key_bits": KEY_BITS,
                      "least_mismatched": min(
                          r["mismatched_ciphertexts"] for r in rows),
                      "limit": 0,
                      "card": harness.yardstick.device_info(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
