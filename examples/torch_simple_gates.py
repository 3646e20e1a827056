"""Homomorphic boolean gates over all input combinations, on the PyTorch
and CUDA port (go_tfhe_tpu_torch).

The port's counterpart of examples/simple_gates.py: every gate evaluates
the four (a, b) combinations in one batched bootstrap, then MUX over an
encrypted selector.  Keys come from a seeded torch.Generator on the
device; every output is decrypted and checked, and main() returns 1 on any
wrong one.

Run:  python examples/torch_simple_gates.py [--profile 128bit_fast]
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
from go_tfhe_tpu_torch import cipher, gates  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="test_fast",
                    help="parameter profile (e.g. 128bit_fast, 128bit, "
                    "test_fast)")
    ap.add_argument("--device", default="cuda",
                    help="device of keys and ciphertexts; cpu runs the "
                    "kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    p = tfhe.get_params(args.profile)
    dev = torch.device(args.device)
    print(f"device: {dev}")
    print(f"profile: {tfhe.security_info(p)}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    sk = tfhe.gen_secret_key(gen, p, dev)
    ck = tfhe.gen_cloud_key(gen, sk, p)
    print(f"keygen: {time.time() - t0:.2f}s")

    a = np.array([False, False, True, True])
    b = np.array([False, True, False, True])
    ct_a = cipher.lwe_encrypt_bool(gen, a, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, b, p.lwe_alpha, sk.lv0)

    table = {
        "AND": (gates.AND, a & b), "OR": (gates.OR, a | b),
        "NAND": (gates.NAND, ~(a & b)), "NOR": (gates.NOR, ~(a | b)),
        "XOR": (gates.XOR, a ^ b), "XNOR": (gates.XNOR, ~(a ^ b)),
    }
    wrong = 0
    for name, (fn, want) in table.items():
        t0 = time.time()
        out = fn(ck, ct_a, ct_b)
        dec = cipher.lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
        ok = bool((dec == want).all())
        wrong += not ok
        print(f"{name:>5}: {dec.astype(int)}  [{'ok ' if ok else 'FAIL'}] "
              f"({time.time() - t0:.3f}s for all 4 combos)")

    # MUX over an encrypted selector
    sel = np.array([True, False, True, False])
    ct_s = cipher.lwe_encrypt_bool(gen, sel, p.lwe_alpha, sk.lv0)
    out = gates.MUX(ck, ct_s, ct_a, ct_b)
    dec = cipher.lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
    ok = bool((dec == np.where(sel, a, b)).all())
    wrong += not ok
    print(f"  MUX: {dec.astype(int)}  [{'ok' if ok else 'FAIL'}]")
    print("all results correct" if not wrong else f"{wrong} wrong results")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
