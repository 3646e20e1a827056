"""Smoke run of go_tfhe_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed S]

Drives the port's paths once each, at full crypto parameters, through the
entry points a user calls:

* the gate bootstrap at ``128bit_fast`` (lwe_n 700, N 1024): keygen on
  the card, ``gates.NAND`` on a batch of 4096 bit pairs through
  ``engine.bootstrap`` (kernels K1 + K2), truth table, phase-noise margin,
  launch counts, a first, two steady and a one-gate batch, and 32 gates
  against the plain versions;
* ``gates.AND_OR`` (the many-LUT bootstrap) on the same keys, batch 4096:
  both truth tables, margins, launches, 32 pairs against the plain path;
* programmable bootstrapping with extended look-up tables through
  ``lut.bootstrap_func`` (kernels K4 + K5): ``uint6_centered`` (lwe_n
  1071, N 2048, k 2) at batch 2048 with keygen on the card, a first and a
  steady batch, margins, launches and 8 ciphertexts against the plain
  path; ``uint7_centered`` (lwe_n 1160, k 4) at batch 256.

Before that it builds the four Hopper kernels from
``go_tfhe_tpu_torch/csrc/`` and holds each against its plain PyTorch
version (tolerance 0) at the paths' shapes, a wide-digit shape, ragged
batches and the edge rotation amounts.  Each path runs with the launch
counters set to 0 just before it and read just after.

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

from go_tfhe_tpu_torch import cipher, engine, gates, keys, lut, params
from go_tfhe_tpu_torch.ops import _build, cuda_ext_t, cuda_t

BATCH = 4096
PLAIN_CHECK = 32
MARGIN = 2 ** 29          # the boolean decision margin (+-1/8 of the torus)
MIN_SIGMAS = 8.0          # bench.py's phase-margin floor
UINT6_BATCH = 2048
UINT7_BATCH = 256
PBS_PLAIN_CHECK = 8
K1K2 = ("rotate_decompose_t", "extprod_t")
K4K5 = ("rotate_decompose_ext_t", "extprod_ext_t")


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


def check_launches(launches: dict, per_call: int, calls: int,
                   kernels: tuple) -> None:
    """``kernels`` launched per_call times per bootstrap call, every other
    kernel not at all."""
    for name, count in launches.items():
        want = per_call * calls if name in kernels else 0
        check(count == want,
              f"{name} launched {count} times, expected {want}")


def margin_sigmas(phase_words: np.ndarray, ideal: np.ndarray,
                  margin: int) -> tuple:
    """(margin / std, std, max |dev|) of the phase's deviation from the
    ideal encoding, wrapped to a signed 32-bit difference."""
    dev = (phase_words.astype(np.int64) - ideal + 2 ** 31) % 2 ** 32 - 2 ** 31
    std = float(dev.std())
    return margin / std, std, int(np.abs(dev).max())


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
    errs = dict.fromkeys(cuda_t.launch_counts, 0)
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


def ext_kernels_against_plain(gen, dev, errs, times):
    """K4 and K5 against their plain versions, exactly (tolerance 0), at
    the extended paths' shapes (uint6 B 2048, uint7 B 256), a k = 3,
    nd = 3 shape at N 256, and ragged batches; the amounts include 0, kN,
    2kN - 1 and 2kN.  Adds to ``errs`` and ``times``."""
    wide = params.TFHEParams(
        name="ext3_nd3", lwe_n=6, lwe_alpha=1.0 / (1 << 28), n=256,
        lv1_alpha=1.0 / (1 << 31), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=1, message_modulus=8, poly_extend_factor=3)
    u6, u7 = params.UINT6_CENTERED, params.UINT7_CENTERED
    cases = [(u6, UINT6_BATCH), (u7, UINT7_BATCH), (wide, 256), (u6, 1),
             (u6, UINT6_BATCH - 1)]
    for p, b in cases:
        k, n, nd = p.poly_extend_factor, p.n, p.digit_limbs
        big = 2 * k * n
        acc = torch.randint(-2 ** 31, 2 ** 31, (2, k * n, b),
                            dtype=torch.int32, device=dev, generator=gen)
        amounts = torch.randint(0, big + 1, (b,), dtype=torch.int32,
                                device=dev, generator=gen)
        edges = torch.tensor([big, 0, k * n, big - 1], dtype=torch.int32,
                             device=dev)
        amounts[: min(b, 4)] = edges[: min(b, 4)]
        bsk = torch.randint(-2 ** 31, 2 ** 31, (1, 2 * p.l, 2, n),
                            dtype=torch.int32, device=dev, generator=gen)
        band = cuda_t.pack_bsk_band_t(bsk)[0].contiguous()

        d_k = cuda_ext_t.rotate_decompose_ext_t(p, acc, amounts)
        d_p = cuda_ext_t.rotate_decompose_ext_t_ref(p, acc, amounts)
        o_k = cuda_ext_t.extprod_ext_t(d_p, band, acc, k, nd)
        o_p = cuda_ext_t.extprod_ext_t_ref(d_p, band, acc, k, nd)
        torch.cuda.synchronize()
        e4, e5 = max_abs_err(d_k, d_p), max_abs_err(o_k, o_p)
        print(f"   {p.name:14s} B={b:5d}  K4 max|err| {e4}  K5 max|err| {e5}",
              flush=True)
        check(e4 == 0 and e5 == 0,
              f"kernel disagrees with its plain version at {p.name} B={b}")
        errs["rotate_decompose_ext_t"] = max(errs["rotate_decompose_ext_t"],
                                             e4)
        errs["extprod_ext_t"] = max(errs["extprod_ext_t"], e5)
        if p is u6 and b == UINT6_BATCH:
            times["rotate_decompose_ext_t"] = (
                cuda_ms(lambda: cuda_ext_t.rotate_decompose_ext_t(
                    p, acc, amounts), 20),
                cuda_ms(lambda: cuda_ext_t.rotate_decompose_ext_t_ref(
                    p, acc, amounts), 3))
            times["extprod_ext_t"] = (
                cuda_ms(lambda: cuda_ext_t.extprod_ext_t(d_p, band, acc, k,
                                                         nd), 10),
                cuda_ms(lambda: cuda_ext_t.extprod_ext_t_ref(d_p, band, acc,
                                                             k, nd), 3))
    for name in K4K5:
        ms, plain_ms = times[name]
        print(f"   {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"per call ({u6.name}, B={UINT6_BATCH})", flush=True)


def pbs_phase(gen, dev, p, batch: int, f, steady: bool) -> dict:
    """Keygen on the card, then ``lut.bootstrap_func`` with f on a batch of
    messages cycling over the message space: decryption, phase margin
    against the half-segment 2^31/m/2, launch counts (K4 + K5, lwe_n per
    bootstrap), batch times, peak memory, and PBS_PLAIN_CHECK ciphertexts
    against the plain path.  Returns the figures."""
    m = p.message_modulus
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sk = keys.gen_secret_key(gen, p, dev)
    ck = keys.gen_cloud_key(gen, sk, p)
    keygen_s = done(t0, "keygen ")
    keygen_peak = torch.cuda.max_memory_allocated()
    print(f"   ksk {ck.ksk.numel() * 4} B, bands {ck.bands.numel() * 4} B; "
          f"keygen peak memory {keygen_peak} B", flush=True)
    msgs = np.arange(batch) % m
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_t.reset_launch_counts()
    calls = 0
    t1 = time.perf_counter()
    out = lut.bootstrap_func(ck, ct, f, m)
    calls += 1
    first_s = done(t1, "first batch ")
    steady_s = None
    if steady:
        t1 = time.perf_counter()
        out2 = lut.bootstrap_func(ck, ct, f, m)
        calls += 1
        steady_s = done(t1, "steady batch ")
        check(torch.equal(out, out2), "two runs of one batch disagree")
    launches = dict(cuda_t.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    print(f"   launches over {calls} bootstrap call(s): {launches}; peak "
          f"memory {peak} B", flush=True)
    check_launches(launches, p.lwe_n, calls, K4K5)

    check(out.shape == (batch, p.lwe_n + 1) and out.dtype == torch.int32,
          f"unexpected output {tuple(out.shape)} {out.dtype}")
    want = np.asarray([f(int(x)) for x in msgs])
    dec = cipher.lwe_decrypt_message(out, m, sk.lv0).cpu().numpy()
    wrong = int((dec != want).sum())
    check(wrong == 0, f"{wrong}/{batch} {p.name} outputs decrypt wrong")
    half = 2 ** 31 // m // 2
    sig, std, worst = margin_sigmas(
        cipher.lwe_phase(out, sk.lv0).cpu().numpy(),
        cipher.encode_message(want, m).astype(np.int64), half)
    rate = batch / (steady_s if steady else first_s)
    print(f"   {batch}/{batch} right; phase noise std 2^{np.log2(std):.2f}, "
          f"max |dev| 2^{np.log2(worst + 1):.2f}, margin {sig:.1f} sigma of "
          f"the 2^{np.log2(half):.0f} half-segment; PBS/s "
          f"{rate:.1f}", flush=True)

    t1 = time.perf_counter()
    table = lut.Generator(p, m, device=dev).gen_lut(f)
    plain = engine.bootstrap(ck, ct[:PBS_PLAIN_CHECK], testvec=table,
                             plain=True)
    check(torch.equal(plain, out[:PBS_PLAIN_CHECK]),
          f"{p.name}: the kernel path disagrees with the plain path")
    check(cuda_t.launch_counts == launches, "the plain path launched a kernel")
    done(t1, f"{PBS_PLAIN_CHECK} ciphertexts bit-equal through the plain "
         "path; ")
    return {"keygen_s": keygen_s, "keygen_peak_bytes": keygen_peak,
            "first_batch_s": first_s, "steady_batch_s": steady_s,
            "pbs_per_s": rate, "margin_sigmas": sig,
            "peak_bytes": peak, "launches": launches}


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
    ext_kernels_against_plain(gen, dev, errs, times)
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
    check_launches(launches, p.lwe_n, calls, K1K2)

    check(out.shape == (BATCH, p.lwe_n + 1) and out.dtype == torch.int32,
          f"unexpected output {tuple(out.shape)} {out.dtype}")
    check(torch.equal(out, out2), "two runs of one batch disagree")
    want = ~(bits_a & bits_b)
    dec = cipher.lwe_decrypt_bool(out, sk.lv0).cpu().numpy()
    wrong = int((dec != want).sum())
    check(wrong == 0, f"{wrong}/{BATCH} NAND outputs decrypt wrong")
    check(bool(cipher.lwe_decrypt_bool(one, sk.lv0).item()) == bool(want[0]),
          "the one-gate batch decrypts wrong")
    sigmas, std, worst = margin_sigmas(
        cipher.lwe_phase(out, sk.lv0).cpu().numpy(),
        np.where(want, MARGIN, -MARGIN), MARGIN)
    print(f"   phase noise std 2^{np.log2(std):.2f}, max |dev| "
          f"2^{np.log2(worst + 1):.2f}, margin {sigmas:.1f} sigma",
          flush=True)
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

    t0 = phase(f"7. AND_OR batch of {BATCH} through engine.bootstrap_many")
    torch.cuda.synchronize()
    cuda_t.reset_launch_counts()
    t1 = time.perf_counter()
    out_and, out_or = gates.AND_OR(ck, ct_a, ct_b)
    and_or_s = done(t1, "batch ")
    and_or_launches = dict(cuda_t.launch_counts)
    print(f"   launches: {and_or_launches}", flush=True)
    check_launches(and_or_launches, p.lwe_n, 1, K1K2)
    and_or_sigmas = []
    for name, got, truth in (("AND", out_and, bits_a & bits_b),
                             ("OR", out_or, bits_a | bits_b)):
        dec = cipher.lwe_decrypt_bool(got, sk.lv0).cpu().numpy()
        wrong = int((dec != truth).sum())
        check(wrong == 0, f"{wrong}/{BATCH} {name} outputs decrypt wrong")
        sig, std, worst = margin_sigmas(
            cipher.lwe_phase(got, sk.lv0).cpu().numpy(),
            np.where(truth, MARGIN, -MARGIN), MARGIN)
        print(f"   {name}: {BATCH}/{BATCH} right, phase noise std "
              f"2^{np.log2(std):.2f}, max |dev| 2^{np.log2(worst + 1):.2f}, "
              f"margin {sig:.1f} sigma", flush=True)
        check(sig >= MIN_SIGMAS,
              f"{name} noise margin {sig:.1f} sigma below {MIN_SIGMAS}")
        and_or_sigmas.append(sig)
    plain_and_or = engine.bootstrap_many(
        ck, ct_a[:PLAIN_CHECK] + ct_b[:PLAIN_CHECK],
        gates.and_or_lut(p, dev), k=2, theta=1, plain=True)
    check(torch.equal(plain_and_or[0], out_and[:PLAIN_CHECK])
          and torch.equal(plain_and_or[1], out_or[:PLAIN_CHECK]),
          "AND_OR: the kernel path disagrees with the plain path")
    check(cuda_t.launch_counts == and_or_launches,
          "the plain path launched a kernel")
    done(t0, f"{PLAIN_CHECK} pairs bit-equal through the plain path; ")

    m6 = params.UINT6_CENTERED.message_modulus
    t0 = phase(f"8. {params.UINT6_CENTERED.name} PBS, batch {UINT6_BATCH}, "
               "through lut.bootstrap_func")
    u6 = pbs_phase(gen, dev, params.UINT6_CENTERED, UINT6_BATCH,
                   lambda x: (3 * x + 1) % m6, steady=True)
    check(u6["margin_sigmas"] >= MIN_SIGMAS,
          f"uint6 noise margin {u6['margin_sigmas']:.1f} sigma below "
          f"{MIN_SIGMAS}")
    done(t0)

    m7 = params.UINT7_CENTERED.message_modulus
    t0 = phase(f"9. {params.UINT7_CENTERED.name} PBS, batch {UINT7_BATCH}, "
               "through lut.bootstrap_func")
    u7 = pbs_phase(gen, dev, params.UINT7_CENTERED, UINT7_BATCH,
                   lambda x: (5 * x + 3) % m7, steady=False)
    done(t0)

    path_launches = {"rotate_decompose_t": launches["rotate_decompose_t"],
                     "extprod_t": launches["extprod_t"],
                     "rotate_decompose_ext_t":
                         u6["launches"]["rotate_decompose_ext_t"],
                     "extprod_ext_t": u6["launches"]["extprod_ext_t"]}
    sources = {
        "rotate_decompose_t": ("go_tfhe_tpu_torch/csrc/rotdec_t.cu",
                               "go_tfhe_tpu/ops/pallas_t.py:122"),
        "extprod_t": ("go_tfhe_tpu_torch/csrc/extprod_t.cu",
                      "go_tfhe_tpu/ops/pallas_t.py:210"),
        "rotate_decompose_ext_t": ("go_tfhe_tpu_torch/csrc/rotdec_ext_t.cu",
                                   "go_tfhe_tpu/ops/pallas_t.py:348"),
        "extprod_ext_t": ("go_tfhe_tpu_torch/csrc/extprod_ext_t.cu",
                          "go_tfhe_tpu/ops/pallas_t.py:433")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()],
        "keygen_s": keygen_s, "first_batch_s": first_s,
        "steady_gates_per_s": steady_rate, "one_gate_s": latency_s,
        "margin_sigmas": sigmas,
        "and_or_batch_s": and_or_s, "and_or_margin_sigmas": and_or_sigmas,
        "uint6_centered": {k: v for k, v in u6.items() if k != "launches"},
        "uint7_centered": {k: v for k, v in u7.items() if k != "launches"},
        "path_launches": {"nand": launches, "and_or": and_or_launches,
                          "uint6_centered": u6["launches"],
                          "uint7_centered": u7["launches"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
