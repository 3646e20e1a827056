"""8-bit homomorphic addition two ways, on the PyTorch and CUDA port
(go_tfhe_tpu_torch).

The port's counterpart of examples/add_two_numbers.py:

* PBS nibble method: 3 programmable bootstraps on a messageModulus-32
  profile (low-sum, carry and high-sum tables).
* Ripple-carry method: 5 gate bootstraps a bit over encrypted bit vectors.

Both are batched (--batch pairs at once).  Keys come from a seeded
torch.Generator on the device; every sum is decrypted and checked, and
main() returns 1 on any wrong one.

Run:  python examples/torch_add_two_numbers.py [--profile uint5]
      [--bool-profile 128bit_fast] [--batch 4] [--device cuda]
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
from go_tfhe_tpu_torch import bitutils, cipher  # noqa: E402
from go_tfhe_tpu_torch.models import adders  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="test_nibble",
                    help="messageModulus>=32 profile (uint5 for production)")
    ap.add_argument("--bool-profile", default="test_fast",
                    help="boolean profile for the ripple-carry variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="device of keys and ciphertexts; cpu runs the "
                    "kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(f"device: {dev}")

    rng = np.random.default_rng(args.seed)
    va = rng.integers(0, 256, args.batch)
    vb = rng.integers(0, 256, args.batch)
    want = (va + vb) & 0xFF
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    wrong = 0

    # ---- PBS nibble method ----------------------------------------------
    p = tfhe.get_params(args.profile)
    if p.message_modulus < 32:
        raise ValueError(f"profile {p.name!r}: the nibble adder needs "
                         "messageModulus >= 32")
    print(f"[PBS nibble] profile: {tfhe.security_info(p)}")
    t0 = time.time()
    sk = tfhe.gen_secret_key(gen, p, dev)
    ck = tfhe.gen_cloud_key(gen, sk, p)
    print(f"  keygen: {time.time() - t0:.2f}s")

    def enc(v):
        return cipher.lwe_encrypt_message(gen, v, 32, p.lwe_alpha, sk.lv0)

    t0 = time.time()
    sum_low, sum_high = adders.add8_pbs(ck, enc(va & 0xF), enc(va >> 4),
                                        enc(vb & 0xF), enc(vb >> 4))
    lo = cipher.lwe_decrypt_message(sum_low, 32, sk.lv0).cpu().numpy() & 0xF
    hi = cipher.lwe_decrypt_message(sum_high, 32, sk.lv0).cpu().numpy() & 0xF
    dt = time.time() - t0
    got = (hi << 4) | lo
    print(f"  3 bootstraps x {args.batch} adds in {dt:.3f}s "
          f"({dt / 3:.3f}s per batched PBS)")
    for i in range(args.batch):
        ok = got[i] == want[i]
        wrong += not ok
        print(f"  {va[i]:3d} + {vb[i]:3d} = {got[i]:3d} (mod 256)  "
              f"[{'ok ' if ok else 'FAIL'}]")

    # ---- Ripple-carry method --------------------------------------------
    p2 = tfhe.get_params(args.bool_profile)
    print(f"[ripple-carry] profile: {tfhe.security_info(p2)}")
    sk2 = tfhe.gen_secret_key(gen, p2, dev)
    ck2 = tfhe.gen_cloud_key(gen, sk2, p2)
    a_bits = np.stack([bitutils.u8_to_bits(int(v)) for v in va])
    b_bits = np.stack([bitutils.u8_to_bits(int(v)) for v in vb])
    ct_a = bitutils.encrypt_bits(gen, a_bits, p2.lwe_alpha, sk2.lv0)
    ct_b = bitutils.encrypt_bits(gen, b_bits, p2.lwe_alpha, sk2.lv0)

    t0 = time.time()
    s_bits, _carry = adders.ripple_carry_add(ck2, ct_a, ct_b)
    dec = bitutils.decrypt_bits(s_bits, sk2.lv0).cpu().numpy()
    dt = time.time() - t0
    got2 = np.array([bitutils.from_bits(dec[i]) for i in range(args.batch)])
    print(f"  40 gate bootstraps x {args.batch} adds in {dt:.3f}s")
    for i in range(args.batch):
        ok = got2[i] == want[i]
        wrong += not ok
        print(f"  {va[i]:3d} + {vb[i]:3d} = {got2[i]:3d} (mod 256)  "
              f"[{'ok ' if ok else 'FAIL'}]")
    print("all results correct" if not wrong else f"{wrong} wrong results")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
