"""Programmable bootstrapping: functions of encrypted integers, on the
PyTorch and CUDA port (go_tfhe_tpu_torch).

The port's counterpart of examples/programmable_bootstrap.py: identity,
increment, complement, mod-4 and constant look-up tables over every
message, a table built once and reused, and a batch with a different
table for each ciphertext.  Keys come from a seeded torch.Generator on the
device; every output is decrypted and checked, and main() returns 1 on any
wrong one.

Run:  python examples/torch_programmable_bootstrap.py [--profile uint5]
      [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import go_tfhe_tpu_torch as tfhe  # noqa: E402
from go_tfhe_tpu_torch import cipher, lut  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="test_pbs",
                    help="a multi-bit profile (uint5 for production)")
    ap.add_argument("--device", default="cuda",
                    help="device of keys and ciphertexts; cpu runs the "
                    "kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    p = tfhe.get_params(args.profile)
    dev = torch.device(args.device)
    m = p.message_modulus
    print(f"device: {dev}")
    print(f"profile: {tfhe.security_info(p)}; messageModulus={m}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    sk = tfhe.gen_secret_key(gen, p, dev)
    ck = tfhe.gen_cloud_key(gen, sk, p)
    print(f"keygen: {time.time() - t0:.2f}s")

    msgs = np.arange(m)
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)

    def check(name: str, out, want, what: str) -> bool:
        dec = cipher.lwe_decrypt_message(out, m, sk.lv0).cpu().numpy()
        ok = bool((dec == want).all())
        print(f"{name:>16}: {dec}  [{'ok ' if ok else 'FAIL'}]{what}")
        return ok

    cases = [
        ("identity", lambda x: x),
        ("increment mod m", lambda x: (x + 1) % m),
        ("complement", lambda x: (m - 1) - x),
        ("mod 4", lambda x: x % 4),
        ("constant 3", lambda x: 3),
    ]
    wrong = 0
    for name, f in cases:
        t0 = time.time()
        out = lut.bootstrap_func(ck, ct, f, m)
        want = np.array([f(x) % m for x in msgs])
        wrong += not check(name, out, want, f" ({time.time() - t0:.3f}s "
                           f"for {m} ciphertexts)")

    # A table built once, applied to many ciphertexts.
    tables = lut.Generator(p, m, device=dev)
    out = lut.bootstrap_lut(ck, ct, tables.gen_lut(lambda x: (3 * x) % m))
    wrong += not check("reused 3x-LUT", out, (3 * msgs) % m, "")

    # A different function on each ciphertext, in one call.
    per_ct = torch.stack([tables.gen_lut(lambda x, i=i: (x + i) % m)
                          for i in range(m)])
    out = lut.bootstrap_lut(ck, ct, per_ct)
    wrong += not check("per-ct LUT batch", out, (msgs + np.arange(m)) % m, "")
    print("all results correct" if not wrong else f"{wrong} wrong results")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
