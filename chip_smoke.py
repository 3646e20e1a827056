"""Smoke run of go_tfhe_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed S]

Drives the port's main path once at the full 128-bit parameters
(``128bit_fast``: lwe_n 700, N 1024): builds the two Hopper kernels from
``go_tfhe_tpu_torch/csrc/``, holds each against its plain PyTorch version
at the main path's shapes, generates keys on the card, encrypts a batch of
4096 bit pairs, runs ``gates.NAND`` through ``engine.bootstrap``, decrypts,
checks the truth table, the phase-noise margin and the kernels' launch
counts, times a first batch, two steady batches and a one-gate batch, and
reruns 32 of the gates through the plain versions for bit equality.

Any failed check raises, so the script exits non-zero and prints no
result.  It needs a CUDA device: there is no CPU run.  On success its last
two lines are a JSON object describing each kernel and then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from go_tfhe_tpu_torch import cipher, engine, gates, keys, params
from go_tfhe_tpu_torch.ops import _build, cuda_t

BATCH = 4096
PLAIN_CHECK = 32
MARGIN = 2 ** 29          # the boolean decision margin (+-1/8 of the torus)
MIN_SIGMAS = 8.0          # bench.py's phase-margin floor


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float, what: str = "") -> float:
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"   {what}{dt:.3f} s", flush=True)
    return dt


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def kernels_against_plain(gen, dev):
    """K1 and K2 against their plain versions, exactly (tolerance 0), at
    the main path's shapes, a wide-digit shape and ragged batches.
    Returns ({kernel: max_abs_err}, {kernel: (ms, plain_ms)})."""
    wide = params.TFHEParams(
        name="wide_nd3", lwe_n=4, lwe_alpha=1.0 / (1 << 26), n=256,
        lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=1, message_modulus=8)
    fast, exact = params.P128_FAST, params.P128
    cases = [(fast, BATCH), (exact, BATCH), (wide, 256), (fast, 1),
             (fast, BATCH - 1)]
    errs = {"rotate_decompose_t": 0, "extprod_t": 0}
    times = {}
    for p, b in cases:
        n, nd = p.n, p.digit_limbs
        lo = p.kernel_limb_drop if nd == 1 else 0
        acc = torch.randint(-2 ** 31, 2 ** 31, (2, n, b), dtype=torch.int32,
                            device=dev, generator=gen)
        amounts = torch.randint(0, 2 * n + 1, (b,), dtype=torch.int32,
                                device=dev, generator=gen)
        amounts[: min(b, 2)] = torch.tensor([2 * n, 0][: min(b, 2)],
                                            dtype=torch.int32, device=dev)
        bsk = torch.randint(-2 ** 31, 2 ** 31, (1, 2 * p.l, 2, n),
                            dtype=torch.int32, device=dev, generator=gen)
        if p.key_grid_bits:
            bsk &= ~((1 << p.key_grid_bits) - 1)
        band = cuda_t.pack_bsk_band_t(bsk, lo)[0].contiguous()

        d_k = cuda_t.rotate_decompose_t(p, acc, amounts)
        d_p = cuda_t.rotate_decompose_t_ref(p, acc, amounts)
        o_k = cuda_t.extprod_t(d_p, band, acc, nd)
        o_p = cuda_t.extprod_t_ref(d_p, band, acc, nd)
        torch.cuda.synchronize()
        e1, e2 = max_abs_err(d_k, d_p), max_abs_err(o_k, o_p)
        print(f"   {p.name:12s} B={b:5d}  K1 max|err| {e1}  K2 max|err| {e2}",
              flush=True)
        check(e1 == 0 and e2 == 0,
              f"kernel disagrees with its plain version at {p.name} B={b}")
        errs["rotate_decompose_t"] = max(errs["rotate_decompose_t"], e1)
        errs["extprod_t"] = max(errs["extprod_t"], e2)
        if p is fast and b == BATCH:
            times["rotate_decompose_t"] = (
                cuda_ms(lambda: cuda_t.rotate_decompose_t(p, acc, amounts),
                        20),
                cuda_ms(lambda: cuda_t.rotate_decompose_t_ref(p, acc,
                                                              amounts), 3))
            times["extprod_t"] = (
                cuda_ms(lambda: cuda_t.extprod_t(d_p, band, acc, nd), 20),
                cuda_ms(lambda: cuda_t.extprod_t_ref(d_p, band, acc, nd), 3))
    for name, (ms, plain_ms) in times.items():
        print(f"   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"per call (128bit_fast, B={BATCH})", flush=True)
    return errs, times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s)", flush=True)
    done(t0)

    t0 = phase("2. build the kernels from csrc/")
    built = _build.build()
    _build.load_library()
    print(f"   nvcc seconds: {built['seconds']:.2f} -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"   {line.strip()}")
    done(t0)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = phase("3. kernels against their plain versions")
    errs, times = kernels_against_plain(gen, dev)
    done(t0)

    p = params.P128_FAST
    t0 = phase(f"4. keygen on the card at {p.name}")
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    keygen_s = done(t0, "keygen ")
    nbytes = {f: getattr(ck, f).numel() * getattr(ck, f).element_size()
              for f in ("ksk", "bsk", "bands")}
    print(f"   bytes: ksk {nbytes['ksk']}, bsk {nbytes['bsk']}, "
          f"bands {nbytes['bands']}", flush=True)
    check(not (ck.bsk & 0xFF).any().item(), "BSK is off the key grid")

    t0 = phase(f"5. NAND batch of {BATCH} through engine.bootstrap")
    bits_a = np.resize([False, True], BATCH)
    bits_b = np.resize([False, False, True, True], BATCH)
    ct_a = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_a),
                                   p.lwe_alpha, sk.lv0)
    ct_b = cipher.lwe_encrypt_bool(gen, torch.from_numpy(bits_b),
                                   p.lwe_alpha, sk.lv0)
    torch.cuda.synchronize()
    cuda_t.reset_launch_counts()
    calls = 0
    t1 = time.perf_counter()
    out = gates.NAND(ck, ct_a, ct_b)
    calls += 1
    first_s = done(t1, "first batch ")
    steady = []
    for _ in range(2):
        t1 = time.perf_counter()
        out2 = gates.NAND(ck, ct_a, ct_b)
        calls += 1
        steady.append(done(t1, "steady batch "))
    t1 = time.perf_counter()
    one = gates.NAND(ck, ct_a[:1], ct_b[:1])
    calls += 1
    latency_s = done(t1, "one-gate batch ")
    launches = dict(cuda_t.launch_counts)
    print(f"   launches over {calls} bootstrap calls: {launches}",
          flush=True)
    for name, count in launches.items():
        check(count == p.lwe_n * calls,
              f"{name} launched {count} times, expected {p.lwe_n * calls}")

    check(out.shape == (BATCH, p.lwe_n + 1) and out.dtype == torch.int32,
          f"unexpected output {tuple(out.shape)} {out.dtype}")
    check(torch.equal(out, out2), "two runs of one batch disagree")
    want = ~(bits_a & bits_b)
    dec = cipher.lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
    wrong = int((dec != want).sum())
    check(wrong == 0, f"{wrong}/{BATCH} NAND outputs decrypt wrong")
    check(bool(cipher.lwe_decrypt_bool(one, sk.lv0).item()) == bool(want[0]),
          "the one-gate batch decrypts wrong")
    phase_words = cipher.lwe_phase(out, sk.lv0).cpu().numpy().astype(np.int64)
    ideal = np.where(want, MARGIN, -MARGIN)
    dev_words = (phase_words - ideal + 2 ** 31) % 2 ** 32 - 2 ** 31
    std = float(dev_words.std())
    sigmas = MARGIN / std
    print(f"   phase noise std 2^{np.log2(std):.2f}, max |dev| "
          f"2^{np.log2(np.abs(dev_words).max() + 1):.2f}, margin "
          f"{sigmas:.1f} sigma", flush=True)
    check(sigmas >= MIN_SIGMAS,
          f"noise margin {sigmas:.1f} sigma below {MIN_SIGMAS}")
    steady_rate = BATCH / (sum(steady) / len(steady))
    print(f"   gates/s: first batch {BATCH / first_s:.1f}, steady "
          f"{steady_rate:.1f}; one-gate latency {latency_s * 1e3:.1f} ms; "
          f"peak memory {torch.cuda.max_memory_allocated()} B", flush=True)
    done(t0)

    t0 = phase(f"6. {PLAIN_CHECK} gates through the plain versions")
    prepared = engine.prepare_nand(ct_a[:PLAIN_CHECK], ct_b[:PLAIN_CHECK])
    plain_out = engine.bootstrap(ck, prepared, plain=True)
    check(torch.equal(plain_out, out[:PLAIN_CHECK]),
          "the kernel path disagrees with the plain path")
    check(cuda_t.launch_counts == launches,
          "the plain path launched a kernel")
    done(t0, "bit-equal; ")

    sources = {"rotate_decompose_t": ("go_tfhe_tpu_torch/csrc/rotdec_t.cu",
                                      "go_tfhe_tpu/ops/pallas_t.py:122"),
               "extprod_t": ("go_tfhe_tpu_torch/csrc/extprod_t.cu",
                             "go_tfhe_tpu/ops/pallas_t.py:210")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()],
        "keygen_s": keygen_s, "first_batch_s": first_s,
        "steady_gates_per_s": steady_rate, "one_gate_s": latency_s,
        "margin_sigmas": sigmas}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
