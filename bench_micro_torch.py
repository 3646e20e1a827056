"""Micro-benchmarks of the PyTorch/CUDA port (go_tfhe_tpu_torch), mirroring
the reference's benchmark families: the port's counterpart of
bench_micro.py.

The Go reference has 19 benchmark functions in 4 families:
* keygen / encrypt / decrypt       (gates/gates_test.go:488-640)
* polynomial kernel                 (poly/poly_test.go:64-124)
* PBS incl. Uint5                   (evaluator/programmable_bootstrap_test.go:212-266,
                                     params/uint_params_test.go:150-216)
* proxy re-encryption               (proxyreenc/proxyreenc_test.go:193-238)

One JSON line PER metric (``utils.metrics.MetricsLogger``, bench_micro.py's
metric names, each line with "device": the card's name and power limit),
then a summary.  On the card: ``128bit`` at batch 4096 (and the
``128bit_fast`` gate rows), PBS at ``uint5``, proxy re-encryption at
``80bit``; on the host (``--device cpu``) ``test_fast``, ``test_nibble``
and ``test_fast`` at batch 16, as bench_micro.py off the TPU.

Where bench_micro.py's rows name XLA's compilation, the port's measure the
first call in the process: ``*_cold``, ``*_compile_overhead`` (first call
minus a steady one) and ``time_to_first_batch_*`` (secret keygen + cloud
keygen + first bootstrap, all first calls) hold the CUDA context's and the
libraries' initialisation and the build of the kernels at their first use
(``ops/_build.py``; none where the library is already loaded), not a
compilation of the computation.

``--quick`` runs the cheap families only (no uint5 PBS).

Run:  python bench_micro_torch.py [--quick] [--device cpu]
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

from go_tfhe_tpu_torch import (cipher, engine, keys, lut, params,  # noqa: E402
                               proxyreenc)
from go_tfhe_tpu_torch.ops.keyswitch import identity_key_switch  # noqa: E402
from go_tfhe_tpu_torch.ops.polymul import negacyclic_mul_binary  # noqa: E402
from go_tfhe_tpu_torch.utils import benchmarking as bm  # noqa: E402
from go_tfhe_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32  # noqa: E402

SEED = 0        # bench_micro.py's PRNGKey(0)


class Families:
    """The four families on one device, each emitting its rows to one
    MetricsLogger with the device's record."""

    def __init__(self, metrics: MetricsLogger, dev: torch.device,
                 batch: int):
        self.metrics, self.dev, self.batch = metrics, dev, batch
        self.device = bm.device_info(dev)

    def emit(self, metric: str, seconds: float, unit_count: float = 1.0,
             unit: str = "ms") -> None:
        self.metrics.emit_seconds(metric, seconds, unit_count, unit,
                                  device=self.device)

    def timed(self, fn, reps: int = 3) -> float:
        return bm.timed(fn, reps, self.dev)

    def first(self, fn) -> tuple:
        """(result, seconds) of one call, synchronized."""
        t0 = time.perf_counter()
        out = fn()
        bm.synchronize(self.dev)
        return out, time.perf_counter() - t0

    def keygen(self, gen: torch.Generator, p: params.TFHEParams) -> tuple:
        """keygen / encrypt family's keygen rows; returns (sk, ck, the
        secret and cloud keygen's first-call seconds)."""
        sk, sk_cold = self.first(lambda: keys.gen_secret_key(gen, p,
                                                             self.dev))
        self.emit(f"keygen_secret_{p.name}_cold", sk_cold)
        self.emit(f"keygen_secret_{p.name}",
                  self.timed(lambda: keys.gen_secret_key(gen, p, self.dev)))
        ck, cold = self.first(lambda: keys.gen_cloud_key(gen, sk, p))
        self.emit(f"keygen_cloud_{p.name}_cold", cold)
        steady = self.timed(lambda: keys.gen_cloud_key(gen, sk, p))
        self.emit(f"keygen_cloud_{p.name}", steady)
        self.emit(f"keygen_cloud_{p.name}_compile_overhead", cold - steady)
        return sk, ck, sk_cold, cold

    def encrypt_decrypt(self, gen, p, sk, bits) -> None:
        self.emit(f"encrypt_bool_{p.name}_per_ct", self.timed(
            lambda: cipher.lwe_encrypt_bool(gen, bits, p.lwe_alpha, sk.lv0)),
            len(bits))
        ct = cipher.lwe_encrypt_bool(gen, bits, p.lwe_alpha, sk.lv0)
        self.emit(f"decrypt_bool_{p.name}_per_ct", self.timed(
            lambda: cipher.lwe_decrypt_bool(ct, sk.lv0)), len(bits))

    def polymul(self, p, sk, rng) -> None:
        a = from_numpy_u32(rng.integers(0, 2 ** 32, size=(self.batch, p.n),
                                        dtype=np.uint64).astype(np.uint32),
                           self.dev)
        self.emit(f"polymul_binary_{p.name}_batch{self.batch}",
                  self.timed(lambda: negacyclic_mul_binary(a, sk.lv1)))

    def gate(self, p, ck, ct, ct_b) -> tuple:
        """Gate bootstrap rows (AND of the batch); returns the first
        batch's seconds and the steady seconds per batch."""
        def run():
            return engine.bootstrap(ck, engine.prepare_and(ct, ct_b))
        _, first_batch = self.first(run)
        dt = self.timed(run)
        self.emit(f"gate_bootstrap_{p.name}_first_batch", first_batch)
        self.emit(f"gate_bootstrap_{p.name}_compile_overhead",
                  first_batch - dt)
        return first_batch, dt

    def latency(self, gen, p, sk, ck) -> None:
        """One-gate latency: the sequential-chain cost a batch-1 caller
        pays (the reference's ~100-150 ms per gate, README.md:131,398)."""
        for lat_b in (1, 128):
            bits_l = np.resize([False, True], lat_b)
            ct_l = cipher.lwe_encrypt_bool(gen, bits_l, p.lwe_alpha, sk.lv0)
            ct_lb = cipher.lwe_encrypt_bool(gen, ~bits_l, p.lwe_alpha,
                                            sk.lv0)
            self.emit(f"gate_latency_{p.name}_batch{lat_b}", self.timed(
                lambda: engine.bootstrap(ck, engine.prepare_and(ct_l,
                                                                ct_lb))))

    def key_switch(self, p, ck, rng) -> None:
        lv1 = from_numpy_u32(rng.integers(0, 2 ** 32,
                                          size=(self.batch, p.n + 1),
                                          dtype=np.uint64).astype(np.uint32),
                             self.dev)
        self.emit(f"key_switch_{p.name}_batch{self.batch}", self.timed(
            lambda: identity_key_switch(p, ck.ksk, lv1)))

    def pbs(self, gen, pu) -> None:
        """PBS family: keygen, x -> x+1 mod m timed (2 reps) and its
        accuracy."""
        sku = keys.gen_secret_key(gen, pu, self.dev)
        cku, secs = self.first(lambda: keys.gen_cloud_key(gen, sku, pu))
        self.emit(f"keygen_cloud_{pu.name}", secs)
        m = pu.message_modulus
        msgs = np.arange(self.batch) % m
        ctu = cipher.lwe_encrypt_message(gen, msgs, m, pu.lwe_alpha, sku.lv0)
        dt = self.timed(lambda: lut.bootstrap_func(cku, ctu,
                                                   lambda x: (x + 1) % m, m),
                        reps=2)
        self.emit(f"pbs_{pu.name}_batch{self.batch}", dt)
        self.emit(f"pbs_{pu.name}_per_ct", dt, self.batch)
        out = lut.bootstrap_func(cku, ctu, lambda x: (x + 1) % m, m)
        dec = cipher.lwe_decrypt_message(out, m, sku.lv0).cpu().numpy()
        ok = (dec == (msgs + 1) % m).mean()
        print(json.dumps({"metric": f"pbs_{pu.name}_accuracy",
                          "value": float(ok), "unit": "fraction",
                          "device": self.device}), flush=True)

    def proxy(self, gen, pp, bits) -> None:
        """Proxy re-encryption family (steady state, as the reference's
        ~23 ms / ~21 ms numbers, CHANGELOG.md:26,49)."""
        alice = keys.gen_secret_key(gen, pp, self.dev)
        bob = keys.gen_secret_key(gen, pp, self.dev)
        self.emit(f"proxy_pubkey_{pp.name}", self.timed(
            lambda: proxyreenc.gen_public_key(gen, bob.lv0, pp)))
        pk_bob = proxyreenc.gen_public_key(gen, bob.lv0, pp)
        self.emit(f"proxy_reenc_keygen_sym_{pp.name}", self.timed(
            lambda: proxyreenc.gen_reencryption_key_symmetric(
                gen, alice.lv0, bob.lv0, pp)))
        # Asymmetric re-encryption keygen (reference: ~4.4 s,
        # CHANGELOG.md:27).
        self.emit(f"proxy_reenc_keygen_asym_{pp.name}", self.timed(
            lambda: proxyreenc.gen_reencryption_key_asymmetric(
                gen, alice.lv0, pk_bob, pp)))
        rk = proxyreenc.gen_reencryption_key_symmetric(gen, alice.lv0,
                                                       bob.lv0, pp)
        cta = cipher.lwe_encrypt_bool(gen, bits, pp.lwe_alpha, alice.lv0)
        self.emit(f"proxy_reencrypt_{pp.name}_batch{self.batch}",
                  self.timed(lambda: proxyreenc.reencrypt(rk, cta)))


def run(families: Families, quick: bool) -> None:
    f, dev, batch = families, families.dev, families.batch
    on_card = dev.type == "cuda"
    p = params.P128 if on_card else params.TEST_FAST
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    # --- keygen family (reference: ~5-10 s at 128-bit, README.md:397) ---
    sk, ck, sk_cold, cold = f.keygen(gen, p)
    # --- encrypt / decrypt family ---------------------------------------
    bits = np.resize([False, True], batch)
    f.encrypt_decrypt(gen, p, sk, bits)
    # --- polynomial kernel family (poly/poly_test.go:64-124) ------------
    f.polymul(p, sk, rng)
    # --- gate bootstrap (the headline lives in bench_torch.py) ----------
    ct = cipher.lwe_encrypt_bool(gen, bits, p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, ~bits, p.lwe_alpha, sk.lv0)
    first_batch, dt = f.gate(p, ck, ct, ct_b)
    # Process start -> first decrypted batch, as the first calls of this
    # process paid it: secret keygen + cloud keygen + first bootstrap.
    f.emit(f"time_to_first_batch_{p.name}", sk_cold + cold + first_batch,
           unit="ms (fresh process)")
    f.emit(f"gate_bootstrap_{p.name}_batch{batch}", dt)
    f.emit(f"gate_bootstrap_{p.name}_per_ct", dt, batch)
    # --- single-gate latency --------------------------------------------
    f.latency(gen, p, sk, ck)
    if on_card:
        # the throughput profile (the bgbit=8/l=2 gadget, one key limb
        # dropped)
        pf = params.P128_FAST
        skf = keys.gen_secret_key(gen, pf, dev)
        ckf = keys.gen_cloud_key(gen, skf, pf)
        ctf = cipher.lwe_encrypt_bool(gen, bits, pf.lwe_alpha, skf.lv0)
        ctf_b = cipher.lwe_encrypt_bool(gen, ~bits, pf.lwe_alpha, skf.lv0)
        dt = f.timed(lambda: engine.bootstrap(
            ckf, engine.prepare_and(ctf, ctf_b)))
        f.emit(f"gate_bootstrap_{pf.name}_batch{batch}", dt)
        f.emit(f"gate_bootstrap_{pf.name}_per_ct", dt, batch)
        del skf, ckf
    # --- key switch share -----------------------------------------------
    f.key_switch(p, ck, rng)
    del ck
    # --- PBS family -----------------------------------------------------
    if not quick:
        f.pbs(gen, params.UINT5 if on_card else params.TEST_NIBBLE)
    # --- proxy re-encryption family (CHANGELOG.md:26-28) ----------------
    f.proxy(gen, params.P80 if on_card else params.TEST_FAST, bits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the cheap families only (no uint5 PBS)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = bm.card_or_host(args.device)
    metrics = MetricsLogger()
    families = Families(metrics, dev, 4096 if dev.type == "cuda" else 16)
    run(families, args.quick)
    print(json.dumps({"summary": metrics.summary(),
                      "device": families.device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
