"""Batched-bootstrap scaling benchmark of the PyTorch/CUDA port
(go_tfhe_tpu_torch) over a mesh of devices: the counterpart of
bench_scaling.py.

Measures gate bootstraps/s through ``parallel.sharded_bootstrap`` at 1,
2, 4, ... devices of the mesh (``parallel.make_mesh()``: every card of
the machine; or the devices named with --devices, repeats allowed, e.g.
``cpu,cpu`` for a plumbing check on the host) and reports the scaling
efficiency, the BASELINE.json "batched-bootstrap scaling efficiency"
metric.  Several hosts run one process each in a ``torch.distributed``
group (``parallel.multihost_initialize``) with the same code.

Prints one JSON line per device count, bench_scaling.py's keys plus
"device" (the first card's name and power limit).

Run:  python bench_scaling_torch.py [--profile 128bit]
      [--batch-per-device 1024] [--reps 3] [--devices cpu,cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from go_tfhe_tpu_torch import cipher, engine, keys, params  # noqa: E402
from go_tfhe_tpu_torch import parallel  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402

SEED = 0        # bench_scaling.py's PRNGKey(0)


def device_counts(size: int) -> list:
    """1, 2, 4, ... up to the mesh's size."""
    counts, d = [], 1
    while d <= size:
        counts.append(d)
        d *= 2
    return counts


def rate(mesh: tuple, ck: keys.CloudKey, prepared: torch.Tensor,
         reps: int) -> float:
    """Bootstraps/s of ``parallel.sharded_bootstrap`` over ``mesh`` on the
    prepared batch: one warm call, then ``reps`` between
    synchronizations of every card of the mesh."""
    def sync():
        for d in dict.fromkeys(mesh):
            bm.synchronize(d)
    parallel.sharded_bootstrap(mesh, ck, prepared)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        parallel.sharded_bootstrap(mesh, ck, prepared)
    sync()
    return prepared.shape[0] / ((time.perf_counter() - t0) / reps)


def run(profile: str, batch_per_device: int, reps: int, mesh: tuple
        ) -> list:
    """One record per device count: keys on the mesh's first device,
    ``batch_per_device`` NAND inputs per device."""
    p = params.get_params(profile)
    dev = mesh[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    device = bm.device_info(dev)
    base_rate, records = None, []
    for nd in device_counts(len(mesh)):
        b = batch_per_device * nd
        bits = np.resize([False, True], b)
        ct = cipher.lwe_encrypt_bool(gen, bits, p.lwe_alpha, sk.lv0)
        r = rate(mesh[:nd], ck, engine.prepare_nand(ct, ct), reps)
        base_rate = base_rate or r
        rec = {"metric": f"bootstraps_per_sec_{profile}", "devices": nd,
               "batch": b, "value": round(r, 1), "unit": "bootstraps/s",
               "scaling_efficiency": round(r / (base_rate * nd), 3),
               "device": device}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default=None,
                    help="default: 128bit on the card, test_fast on the "
                    "host")
    ap.add_argument("--batch-per-device", type=int, default=None,
                    help="default 1024 on the card, 8 on the host")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the mesh (default: "
                    "every card)")
    args = ap.parse_args(argv)
    names = args.devices.split(",") if args.devices else None
    for name in names or ():
        bm.card_or_host(name)
    mesh = parallel.make_mesh(names)
    on_card = mesh[0].type == "cuda"
    run(args.profile or ("128bit" if on_card else "test_fast"),
        args.batch_per_device or (1024 if on_card else 8), args.reps, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
