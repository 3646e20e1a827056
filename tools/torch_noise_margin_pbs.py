"""PBS phase-margin measurement for the multi-bit (uint) profiles, on the
PyTorch/CUDA port (go_tfhe_tpu_torch).

The port's counterpart of tools/noise_margin_pbs.py: an identity look-up
table over a batch of encrypted messages, the output phase deviation from
the ideal x/(2m) encoding, against the PBS decision margin 2^32/(4m) (half
the message segment).  It shows the floor-versus-centered gadget split:
the floor offset's bias walk sits at uint6's margin.  One JSON line per
profile, noise_margin_pbs.py's keys plus "device" (the card's name and
power limit).

Run:  python tools/torch_noise_margin_pbs.py [--batch 1024]
      [--profiles uint6,uint6_centered] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from go_tfhe_tpu_torch import cipher, keys, lut, params  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402

SEED = 321      # noise_margin_pbs.py's PRNGKey(321)


def pbs_noise(out: torch.Tensor, key: torch.Tensor, want: np.ndarray,
              m: int) -> dict:
    """Wrong answers of message outputs against ``want`` and the noise
    block of their phases against the ideal want/(2m) and the 2^32/(4m)
    margin (noise_margin_pbs.py:236-252)."""
    want = np.asarray(want)
    dec = cipher.lwe_decrypt_message(out, m, key).cpu().numpy()
    ideal = (want.astype(np.int64) << 32) // (2 * m)
    margin = 2 ** 32 // (4 * m)
    block, _ = bm.noise_block(bm.phase_deviation(out, key, ideal), margin,
                              round(math.log2(margin), 1), "pbs")
    return {**block, "wrong_answers": int((dec != want).sum())}


def measure(ck: keys.CloudKey, sk: keys.SecretKey, ct: torch.Tensor,
            msgs: np.ndarray, table: torch.Tensor) -> tuple:
    """The identity table ``table`` over ``ct`` (messages ``msgs``):
    (noise_margin_pbs.py's record, outputs)."""
    p = ck.params
    m = p.message_modulus
    out = lut.bootstrap_lut(ck, ct, table)
    return {"profile": p.name, "message_modulus": m, "batch": len(msgs),
            **pbs_noise(out, sk.lv0, msgs, m)}, out


def measure_profile(p: params.TFHEParams, batch: int, dev: torch.device,
                    seed: int = SEED) -> dict:
    """Keys made on ``dev`` from ``seed``, ``batch`` messages cycling over
    the message space, through :func:`measure`."""
    m = p.message_modulus
    gen = torch.Generator(device=dev).manual_seed(seed)
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    msgs = np.arange(batch) % m
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    table = lut.Generator(p, m, device=dev).gen_lut(lambda x: x)
    return measure(ck, sk, ct, msgs, table)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--profiles", default="uint6,uint6_centered")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bm.card_or_host(args.device)
    device = bm.device_info(dev)
    for name in args.profiles.split(","):
        rec = measure_profile(params.get_params(name.strip()), args.batch,
                              dev)
        print(json.dumps({**rec, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
