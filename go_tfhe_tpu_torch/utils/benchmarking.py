"""The measuring helpers of the port's entry points (``bench_torch.py``,
``bench_micro_torch.py``, ``bench_scaling_torch.py`` and
``tools/torch_*.py``, the counterparts of the JAX repo's ``bench*.py`` and
``tools/`` scripts): the device a run takes and the record of it, timing
on the card, and the phase-noise block of the JAX scripts' JSON lines.

Each entry point runs on the card unless asked for the host
(:func:`card_or_host`); a run on the card never falls back to the CPU.
"""

from __future__ import annotations

import importlib.util
import math
import os
import subprocess
import sys
import time
from typing import Callable, Tuple

import numpy as np
import torch

from ..cipher import lwe_decrypt_bool, lwe_phase
from .torus import to_numpy_u32


# The boolean decision margin: the +-1/8 phases lie 2^29 from the
# decision boundary at 0 (tlwe/tlwe.go:64-73).
BOOL_MARGIN = 2 ** 29
# The repo's root, where the entry points lie (and under tools/).
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_script(path: str):
    """The module of one of the repo's entry points (``path`` from the
    repo's root; the ``tools/`` ones put the root on sys.path themselves),
    registered under its file's name, so that a script importing another
    (torch_bench_profiles imports bench_torch) shares its module."""
    name = os.path.splitext(os.path.basename(path))[0]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO_ROOT, path))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def card_or_host(name: str = "cuda") -> torch.device:
    """The device of an entry point's run: the card by default, the host
    only when asked (``"cpu"``).  Raises RuntimeError for a CUDA device on
    a torch without one."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{name}: no CUDA device (torch.cuda.is_available() is False); "
            "pass --device cpu to run the kernels' plain versions on the "
            "host")
    return dev


def device_info(device) -> dict:
    """The ``"device"`` field of an entry point's JSON lines: on the card
    its name and power limit as ``nvidia-smi --query-gpu=name,power.limit``
    reads them (a card may be set below its maximum and then runs slower);
    on the host ``{"name": "cpu", "power_limit": None}``."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None}
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    name, limit = (s.strip() for s in
                   smi.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": limit}


def synchronize(device) -> None:
    """Wait for the card's queued work (kernels return before they end);
    nothing to wait for on the host."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, reps: int, device) -> float:
    """Seconds per call of ``fn()``: one warm call excluded, then ``reps``
    calls between two synchronizations (the JAX scripts' ``timed``)."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / reps


def phase_deviation(ct: torch.Tensor, key: torch.Tensor,
                    ideal: np.ndarray) -> np.ndarray:
    """The phase of each ciphertext minus its ideal phase (int64 words),
    wrapped into [-2^31, 2^31)."""
    ph = to_numpy_u32(lwe_phase(ct, key)).astype(np.int64)
    return ((ph - np.asarray(ideal, np.int64) + 2 ** 31) % 2 ** 32) - 2 ** 31


def noise_block(dev: np.ndarray, margin: int, margin_log2, per: str,
                with_max: bool = True) -> Tuple[dict, float]:
    """The JAX scripts' noise block of a phase deviation against a decision
    margin, and the unrounded margin in sigmas: std and max |dev| in log2,
    the margin, its sigmas and the Gaussian tail's error per output
    (``est_error_per_<per>``)."""
    std = float(dev.std())
    sigmas = margin / std if std else float("inf")
    block = {"phase_std_log2": round(math.log2(std), 2) if std else None}
    if with_max:
        block["phase_max_log2"] = round(math.log2(abs(dev).max() + 1), 2)
    block["margin_log2"] = margin_log2
    block["margin_sigmas"] = round(sigmas, 1)
    block[f"est_error_per_{per}"] = float(
        f"{math.erfc(sigmas / math.sqrt(2.0)):.2e}")
    return block, sigmas


def bool_noise(out: torch.Tensor, key: torch.Tensor, want: np.ndarray
               ) -> Tuple[int, dict, float, np.ndarray]:
    """Wrong answers of boolean outputs against ``want``, the noise block of
    their phases against the ideal +-1/8 (``bench.py:116-133``,
    ``tools/noise_margin.py:158-177``), the unrounded margin in sigmas and
    the phase deviations themselves."""
    want = np.asarray(want, bool)
    wrong = int((lwe_decrypt_bool(out, key).cpu().numpy() != want).sum())
    ideal = (np.where(want, 1 / 8, -1 / 8) * 2 ** 32).astype(np.int64)
    dev = phase_deviation(out, key, ideal)
    block, sigmas = noise_block(dev, BOOL_MARGIN, 29, "gate")
    return wrong, block, sigmas, dev
