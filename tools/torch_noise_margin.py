"""Production-scale noise-margin measurement for the shipped profiles, on
the PyTorch/CUDA port (go_tfhe_tpu_torch).

The port's counterpart of tools/noise_margin.py: a batch of NAND gate
bootstraps at real keys and parameters, the phase deviation of the outputs
from the ideal +-1/8 encoding, and its std / max / estimated error per gate
against the 2^29 boolean decision margin.  One JSON line per profile,
noise_margin.py's keys plus "device" (the card's name and power limit).

Run:  python tools/torch_noise_margin.py [--batch 512] [--profiles a,b,c]
      [--device cpu]
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

from go_tfhe_tpu_torch import cipher, engine, keys, params  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402

SEED = 123      # noise_margin.py's PRNGKey(123)


def measure(ck: keys.CloudKey, sk: keys.SecretKey, ct_a: torch.Tensor,
            ct_b: torch.Tensor, bits_a: np.ndarray, bits_b: np.ndarray
            ) -> tuple:
    """NAND of the batch: (noise_margin.py's record, outputs, their phase
    deviations from the ideal +-1/8)."""
    out = engine.bootstrap(ck, engine.prepare_nand(ct_a, ct_b))
    wrong, block, _, dev = bm.bool_noise(out, sk.lv0, ~(bits_a & bits_b))
    return {"profile": ck.params.name, "batch": len(bits_a), **block,
            "wrong_answers": wrong}, out, dev


def measure_profile(p: params.TFHEParams, batch: int, dev: torch.device,
                    seed: int = SEED) -> tuple:
    """Keys made on ``dev`` from ``seed`` and ``batch`` bit pairs through
    :func:`measure`: (the record, the phase deviations)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    bits_a = np.resize([False, True], batch)
    bits_b = np.resize([False, False, True, True], batch)
    ct_a = cipher.lwe_encrypt_bool(gen, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, bits_b, p.lwe_alpha, sk.lv0)
    rec, _, deviation = measure(ck, sk, ct_a, ct_b, bits_a, bits_b)
    return rec, deviation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--profiles", default="128bit_fast,128bit,80bit_fast")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bm.card_or_host(args.device)
    device = bm.device_info(dev)
    for name in args.profiles.split(","):
        rec, _ = measure_profile(params.get_params(name.strip()), args.batch,
                              dev)
        print(json.dumps({**rec, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
