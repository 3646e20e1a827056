"""80/110-bit profile throughput on the PyTorch/CUDA port
(go_tfhe_tpu_torch): the counterpart of tools/bench_profiles.py.

The method of bench_torch.py (the NAND truth table over the whole batch
and the phase-noise margin checked first, then queued steady-state
batches) at the reference's other two security levels; the reference's
single-gate numbers are README.md:398.  One JSON line per profile,
bench_profiles.py's keys plus "noise" and "device" (the card's name and
power limit).  Guarded like bench_torch.py: a wrong answer or a margin
below 8 sigma prints "value": null with the error and the run exits 1.
Nothing runs at import.

Run:  python tools/torch_bench_profiles.py [--profiles 80bit_fast,110bit_fast]
      [--batch 4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from go_tfhe_tpu_torch import cipher, keys, params  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402
import bench_torch  # noqa: E402

REF_MS = {"80bit_fast": "60-80", "110bit_fast": "~90"}
REPS = 5
SEED = 0        # bench_profiles.py's PRNGKey(0)


def bench_profile(p: params.TFHEParams, batch: int, dev: torch.device
                  ) -> tuple:
    """Keys made on ``dev`` from SEED; the NAND batch checked by
    ``bench_torch.measure``, then REPS steady batches timed.  Returns
    (exit code, the JSON record without "device")."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    bits_a = np.resize([False, True], batch)
    bits_b = np.resize([False, False, True, True], batch)
    ct_a = cipher.lwe_encrypt_bool(gen, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, bits_b, p.lwe_alpha, sk.lv0)
    first, _ = bench_torch.measure(ck, sk, ct_a, ct_b, bits_a, bits_b)
    metric = f"gate_bootstraps_per_sec_{p.name}"
    error = bench_torch.guard_error(first["wrong_answers"],
                                    first["margin_sigmas"], batch)
    if error:
        return 1, {"metric": metric, "value": None, "unit": "bootstraps/s",
                   "error": error, "noise": first["noise"]}
    dt = bench_torch.steady_seconds(ck, ct_a, ct_b, REPS)
    return 0, {"metric": metric, "value": round(batch / dt, 2),
               "unit": "bootstraps/s",
               "reference_single_gate_ms": REF_MS.get(p.name, "?"),
               "batch": batch, "noise": first["noise"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profiles", default="80bit_fast,110bit_fast")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bm.card_or_host(args.device)
    device = bm.device_info(dev)
    rc = 0
    for name in args.profiles.split(","):
        code, rec = bench_profile(params.get_params(name.strip()),
                                  args.batch, dev)
        print(json.dumps({**rec, "device": device}), flush=True)
        rc = rc or code
    return rc


if __name__ == "__main__":
    sys.exit(main())
