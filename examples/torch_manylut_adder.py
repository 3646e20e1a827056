"""Multi-LUT bootstrapping: a full adder's sum and carry from one
bootstrap, on the PyTorch and CUDA port (go_tfhe_tpu_torch).

The port's counterpart of examples/manylut_adder.py: a coarse mod switch
and an interleaved test vector (engine.bootstrap_many) read two function
outputs from one blind rotation, so an 8-bit addition takes 8 bootstraps
instead of the ripple-carry adder's 40.  Bits are encrypted as modulus-8
messages (bitutils.encrypt_bits_messages).  Keys come from a seeded
torch.Generator on the device; every sum is decrypted and checked, and
main() returns 1 on any wrong one.

Run:  python examples/torch_manylut_adder.py [--profile 128bit_fast]
      [--batch 4] [--bits 8] [--device cuda]
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
from go_tfhe_tpu_torch import cipher  # noqa: E402
from go_tfhe_tpu_torch.models import adders  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="test_nibble",
                    help="any plain (poly_extend_factor=1) profile; "
                    "128bit_fast for production")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="device of keys and ciphertexts; cpu runs the "
                    "kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    p = tfhe.get_params(args.profile)
    dev = torch.device(args.device)
    print(f"device: {dev}")

    rng = np.random.default_rng(args.seed)
    lim = 1 << args.bits
    va = rng.integers(0, lim, args.batch)
    vb = rng.integers(0, lim, args.batch)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    sk = tfhe.gen_secret_key(gen, p, dev)
    ck = tfhe.gen_cloud_key(gen, sk, p)
    print(f"[{p.name}] keygen: {time.time() - t0:.2f}s")

    # bits -> modulus-8 message encodings, shape (batch, bits, lwe_n+1)
    def enc(vals):
        bits = np.stack([(vals >> i) & 1 for i in range(args.bits)], axis=-1)
        return cipher.lwe_encrypt_message(gen, bits, 8, p.lwe_alpha, sk.lv0)

    ct_a, ct_b = enc(va), enc(vb)
    t0 = time.time()
    s_bits, carry = adders.ripple_add_manylut(ck, ct_a, ct_b)
    s = cipher.lwe_decrypt_message(s_bits, 8, sk.lv0).cpu().numpy()
    cout = cipher.lwe_decrypt_message(carry, 8, sk.lv0).cpu().numpy()
    dt = time.time() - t0
    got = sum((s[..., i].astype(np.int64) & 1) << i
              for i in range(args.bits)) + (cout.astype(np.int64) << args.bits)
    want = va + vb
    print(f"{args.bits}-bit add x{args.batch}: {args.bits} bootstraps "
          f"(vs {5 * args.bits} boolean-gate), {dt:.2f}s")
    for i in range(min(args.batch, 4)):
        print(f"  {va[i]:3d} + {vb[i]:3d} = {got[i]:3d} "
              f"{'ok' if got[i] == want[i] else 'WRONG'}")
    wrong = int((got != want).sum())
    print("all results correct" if not wrong else f"{wrong} wrong results")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
