"""LWE proxy re-encryption walkthrough, on the PyTorch and CUDA port
(go_tfhe_tpu_torch).

The port's counterpart of examples/proxy_reencryption.py: Alice encrypts;
a proxy turns her ciphertexts into ciphertexts under Bob's key with a
symmetric and with an asymmetric re-encryption key (the latter made from
Bob's public key alone); a 2-hop chain Alice -> Bob -> Carol.  Keys come
from a seeded torch.Generator on the device; every re-encrypted bit is
decrypted and checked, and main() returns 1 on a wrong output beyond the
asymmetric hop's allowance.

The asymmetric key's noise margin at 128bit_fast is about 3.8 sigma by the
reference's design (each table word carries the noise of ~lwe_n public-key
zero-encryptions), so about 1e-4 of its outputs decrypt wrong.  That hop
may miss 0.1% of the bits, rounded up (one of the default 64: about 0.6%
of runs see one miss, about 2e-5 see two); the other hops miss none.

Run:  python examples/torch_proxy_reencryption.py [--profile 128bit_fast]
      [--batch 64] [--device cuda]
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import go_tfhe_tpu_torch as tfhe  # noqa: E402
from go_tfhe_tpu_torch import cipher, proxyreenc  # noqa: E402

ASYM_MAX_WRONG_SHARE = 0.001   # PERF.md section 2: <= 0.1% wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="test_fast")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="device of keys and ciphertexts")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    p = tfhe.get_params(args.profile)
    dev = torch.device(args.device)
    print(f"device: {dev}")
    print(f"profile: {tfhe.security_info(p)}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    alice, bob, carol = (tfhe.gen_secret_key(gen, p, dev).lv0
                         for _ in range(3))
    bits = np.random.default_rng(args.seed).integers(0, 2, args.batch
                                                     ).astype(bool)
    wrong = {}

    def report(label: str, ct, key, max_wrong: int = 0) -> None:
        dec = cipher.lwe_decrypt_bool(ct, key).cpu().numpy()
        wrong[label] = max(0, int((dec != bits).sum()) - max_wrong)
        print(f"{label}: {100.0 * (dec == bits).mean():.0f}% right "
              f"[{'ok' if not wrong[label] else 'FAIL'}]")

    ct = cipher.lwe_encrypt_bool(gen, bits, p.lwe_alpha, alice)
    report(f"Alice encrypted {args.batch} bits; self-decrypt", ct, alice)

    # Symmetric re-encryption key (needs both secret keys).
    t0 = time.time()
    rk_sym = proxyreenc.gen_reencryption_key_symmetric(gen, alice, bob, p)
    print(f"symmetric reenc-key gen: {time.time() - t0:.3f}s")
    t0 = time.time()
    ct_bob = proxyreenc.reencrypt(rk_sym, ct)
    report(f"re-encrypt Alice->Bob ({args.batch} cts, "
           f"{time.time() - t0:.3f}s): Bob decrypts", ct_bob, bob)

    # Asymmetric: the key is made from Bob's public key only.
    pk_bob = proxyreenc.gen_public_key(gen, bob, p)
    t0 = time.time()
    rk_asym = proxyreenc.gen_reencryption_key_asymmetric(gen, alice, pk_bob,
                                                         p)
    print(f"asymmetric reenc-key gen: {time.time() - t0:.3f}s")
    report("asymmetric Alice->Bob: Bob decrypts",
           proxyreenc.reencrypt(rk_asym, ct), bob,
           math.ceil(ASYM_MAX_WRONG_SHARE * args.batch))

    # 2-hop chain.
    rk_bc = proxyreenc.gen_reencryption_key_symmetric(gen, bob, carol, p)
    report("chain Alice->Bob->Carol: Carol decrypts",
           proxyreenc.reencrypt(rk_bc, ct_bob), carol)
    failed = sum(wrong.values())
    print("all results correct" if not failed else f"{failed} wrong results")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
