"""Phase-margin measurement for the many-LUT bootstrap (PBSmanyLUT), on the
PyTorch/CUDA port (go_tfhe_tpu_torch).

The port's counterpart of tools/noise_many.py.  The coarse mod switch
multiplies its rounding noise by 2^theta: this tool measures the output
phase deviation of an identity many-LUT bootstrap
(``engine.bootstrap_many``, one function) at theta = 0, 1, 2 on a
production profile, against the half-segment margin 2^32/(4m).  One JSON
line per theta, noise_many.py's keys plus "device" (the card's name and
power limit).  Nothing runs at import.

Run:  python tools/torch_noise_many.py [--profile 128bit_fast]
      [--batch 1024] [--device cpu]
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

from go_tfhe_tpu_torch import cipher, engine, keys, lut, params  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402

MESSAGE_MODULUS = 8
THETAS = (0, 1, 2)
SEED = 0        # noise_many.py's PRNGKey(0)


def measure(ck: keys.CloudKey, sk: keys.SecretKey, ct: torch.Tensor,
            msgs: np.ndarray, m: int, mlut: torch.Tensor, theta: int
            ) -> tuple:
    """The one-function many-LUT table ``mlut`` at ``theta`` over ``ct``
    (messages ``msgs`` of Z_m): (noise_many.py's record, outputs)."""
    out = engine.bootstrap_many(ck, ct, mlut, k=1, theta=theta)[0]
    dec = cipher.lwe_decrypt_message(out, m, sk.lv0).cpu().numpy()
    ideal = msgs.astype(np.int64) << (32 - int(math.log2(m)) - 1)
    margin = 1 << (32 - int(math.log2(m)) - 2)    # half-segment: 2^32/(4m)
    block, _ = bm.noise_block(bm.phase_deviation(out, sk.lv0, ideal), margin,
                              int(math.log2(margin)), "pbs", with_max=False)
    return {"profile": ck.params.name, "message_modulus": m, "theta": theta,
            "batch": len(msgs), **block,
            "wrong_answers": int((dec != msgs).sum())}, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="128bit_fast")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bm.card_or_host(args.device)
    p, m = params.get_params(args.profile), MESSAGE_MODULUS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    table_gen = lut.Generator(p, m, device=dev)
    msgs = np.arange(args.batch) % (m // 2)            # first torus half
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    device = bm.device_info(dev)
    for theta in THETAS:
        mlut = table_gen.gen_multi_lut([lambda x: x], theta=theta)
        rec, _ = measure(ck, sk, ct, msgs, m, mlut, theta)
        print(json.dumps({**rec, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
