"""Run one cell of the benchmark of go_tfhe_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted`` and ``failed`` (the output
ciphertexts of the window's calls, and those whose words differ from the
plain reference's), ``metrics`` (the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics), ``device`` and, traced, ``breakdown``;
its last key, ``checks``, holds each compared number beside its limit,
which also close standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when a module named ``jax``, ``jaxlib``,
``flax`` or ``go_tfhe_tpu`` is loaded once the window has closed.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T_PROCESS)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"error: loaded {found}, which no run may load",
              file=sys.stderr)
        return 3
    card = harness.yardstick.device_info(0)
    result["power_limit"] = card["power_limit"]
    result["checks"] = result.pop("checks")
    print(f"card: {result['device']['kind']}, power limit "
          f"{card['power_limit']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
