"""Extended-LUT (uint6-8) PBS benchmark on the PyTorch/CUDA port
(go_tfhe_tpu_torch): the kernel path beside the portable path.

The port's counterpart of tools/bench_ext.py.  For each profile:

* correctness: the table x -> x+1 mod m over messages cycling over the
  message space, decrypted (``pbs_<name>_accuracy``; the floor-gadget
  uint6/7/8 miss by design, their ``*_centered`` variants do not);
* ``pbs_<name>_per_ct``: the engine's automatic path (uint6/uint7: K4 +
  K5; uint8: K6 + K8 on the card), mean of 2 batches after the first;
* ``pbs_<name>_portable_per_ct``: the portable path (the JAX package's
  off-TPU core, ``engine._bootstrap(..., route="blind_rotate_extended")``,
  no kernel), one batch after a warm one at a smaller batch, with the
  ratio to the kernel path's per-ct time as ``speedup_pallas``.

One JSON line per metric, bench_ext.py's keys plus "device" (the card's
name and power limit).

Run:  python tools/torch_bench_ext.py [--profiles uint6,uint7,uint8]
      [--batch 2048] [--portable-batch 64] [--skip-portable] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from go_tfhe_tpu_torch import cipher, engine, keys, lut, params  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402

REPS = 2
PORTABLE_ROUTE = "blind_rotate_extended"
SEED = 0        # bench_ext.py's PRNGKey(0)


def accuracy(ck: keys.CloudKey, sk: keys.SecretKey, ct: torch.Tensor,
             msgs: np.ndarray, table: torch.Tensor) -> tuple:
    """The table x -> x+1 mod m over ``ct`` (messages ``msgs``), the first
    (warm) batch: ({"accuracy"}, outputs)."""
    m = ck.params.message_modulus
    out = lut.bootstrap_lut(ck, ct, table)
    dec = cipher.lwe_decrypt_message(out, m, sk.lv0).cpu().numpy()
    return {"accuracy": float((dec == (msgs + 1) % m).mean())}, out


def portable_seconds(ck: keys.CloudKey, ct: torch.Tensor,
                     table: torch.Tensor) -> float:
    """Seconds of one portable batch after a warm one."""
    def run():
        return engine._bootstrap(ck, ct, table, key_switch=True, plain=False,
                                 route=PORTABLE_ROUTE)
    run()
    bm.synchronize(ct.device)
    t0 = time.perf_counter()
    run()
    bm.synchronize(ct.device)
    return time.perf_counter() - t0


def bench_profile(name: str, batch: int, portable_batch: int,
                  skip_portable: bool, dev: torch.device, device: dict
                  ) -> None:
    p = params.get_params(name)
    m = p.message_modulus
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    bm.synchronize(dev)

    def emit(rec):
        print(json.dumps({**rec, "device": device}), flush=True)
    emit({"metric": f"keygen_cloud_{name}",
          "value": round((time.perf_counter() - t0) * 1e3, 1), "unit": "ms"})

    msgs = np.arange(batch) % m
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    table = lut.Generator(p, m, device=dev).gen_lut(lambda x: (x + 1) % m)
    acc, _ = accuracy(ck, sk, ct, msgs, table)
    emit({"metric": f"pbs_{name}_accuracy", "value": acc["accuracy"],
          "unit": "fraction", "batch": batch})

    bm.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(REPS):
        lut.bootstrap_lut(ck, ct, table)
    bm.synchronize(dev)
    dt = (time.perf_counter() - t0) / REPS
    emit({"metric": f"pbs_{name}_per_ct",
          "value": round(dt * 1e3 / batch, 3), "unit": "ms", "batch": batch,
          "path": "cuda" if dev.type == "cuda" else "plain",
          "route": engine._route(ck)})
    if skip_portable:
        return
    pb = portable_batch
    dtp = portable_seconds(ck, ct[:pb], table)
    emit({"metric": f"pbs_{name}_portable_per_ct",
          "value": round(dtp * 1e3 / pb, 3), "unit": "ms", "batch": pb,
          "speedup_pallas": round((dtp / pb) / (dt / batch), 1)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profiles", default="uint6")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 2048 on the card, 16 on the host")
    ap.add_argument("--portable-batch", type=int, default=64)
    ap.add_argument("--skip-portable", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bm.card_or_host(args.device)
    batch = args.batch or (2048 if dev.type == "cuda" else 16)
    device = bm.device_info(dev)
    for name in args.profiles.split(","):
        bench_profile(name.strip(), batch, args.portable_batch,
                      args.skip_portable, dev, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
