"""The benchmark's frozen yardstick: the card's peaks, the work a blind
rotation needs, the statistics of a run, the reduction of a profiler trace,
and the card's record.

Nothing here imports the program under test, so a change to the program
cannot move the yardstick.  Its pieces are copies, frozen here:

* the work count is ``go_tfhe_tpu_torch/utils/profiling.py``'s
  ``bootstrap_cost`` (int8 limb-pair multiply-accumulates of the external
  products), with the factor k = poly_extend_factor that the original
  leaves out (an extended profile contracts k blocks a step);
* :func:`device_info` is ``utils/benchmarking.device_info``;
* :func:`noise_sigmas` is the arithmetic of ``utils/benchmarking.bool_noise``
  and ``noise_block`` (the phase deviation's std against the 2^29 margin).
"""

from __future__ import annotations

import bisect
import math
import subprocess

# Dense peaks of one NVIDIA H100 SXM5 at its 700 W power limit (NVIDIA's
# data sheet): int8 tensor-core operations and HBM3 bytes per second.
H100_INT8_OPS = 1979e12
H100_HBM_BYTES = 3.35e12
NUM_KEY_LIMBS = 4       # base-256 limbs of a 32-bit key word
BOOL_MARGIN = 2 ** 29   # the +-1/8 phases lie 2^29 from the decision bound


# ---------------------------------------------------------------------------
# Work of the blind rotation.
# ---------------------------------------------------------------------------

def digit_limbs(params: dict) -> int:
    """Signed base-256 limbs a gadget digit of Bg/2 = 2^(bgbit-1) needs:
    1 up to 2^7, else the least nd with Bg/2 <= 64 * 256^(nd-1)."""
    half_bg = 1 << (params["bgbit"] - 1)
    if half_bg <= 128:
        return 1
    nd = 2
    while half_bg > 64 * 256 ** (nd - 1):
        nd += 1
    return nd


def limb_pairs(params: dict) -> int:
    """(digit limb i, key limb l) pairs of weight 2^(8(i+l)) < 2^32 that an
    exact int8 external product multiplies; key limbs below
    ``kernel_limb_drop`` are zero on the profile's key grid and skipped
    (single-limb digits only)."""
    nd = digit_limbs(params)
    drop = params.get("kernel_limb_drop", 0) if nd == 1 else 0
    return sum(max(0, NUM_KEY_LIMBS - drop - i) for i in range(nd))


def rotation_ops(params: dict, batch: int) -> float:
    """int8 operations (2 per multiply-accumulate) of one blind rotation
    of ``batch`` ciphertexts: per step and ciphertext, the 2L*N digits of
    each of the k blocks times N coefficients of both output channels,
    once per limb pair."""
    l2n = 2 * params["l"] * params["n"]
    macs = (l2n * 2 * limb_pairs(params) * params["n"]
            * params.get("poly_extend_factor", 1) * params["lwe_n"])
    return 2.0 * macs * batch


def rotation_bytes(params: dict, batch: int) -> float:
    """Bytes a blind rotation must move at the least: the raw bootstrapping
    key (lwe_n, 2L, 2, kN) words read once, the ciphertexts and a table
    per ciphertext read once, the accumulators (2, kN) written once."""
    kn = params.get("poly_extend_factor", 1) * params["n"]
    key = params["lwe_n"] * 2 * params["l"] * 2 * kn * 4
    per_ct = (params["lwe_n"] + 1) * 4 + 2 * kn * 4 + 2 * kn * 4
    return float(key + per_ct * batch)


def rotation_bound_s(params: dict, batch: int) -> float:
    """The least time an H100 needs for the rotation: the larger of its
    operations over the int8 peak and its bytes over the HBM peak."""
    return max(rotation_ops(params, batch) / H100_INT8_OPS,
               rotation_bytes(params, batch) / H100_HBM_BYTES)


# ---------------------------------------------------------------------------
# Statistics.
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all ``values``: the smallest
    value with at least q% of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def median(values) -> float:
    ordered = sorted(values)
    mid = len(ordered) // 2
    return (ordered[mid] if len(ordered) % 2
            else 0.5 * (ordered[mid - 1] + ordered[mid]))


def noise_sigmas(deviations) -> float:
    """The boolean decision margin 2^29 over the std of the outputs' phase
    deviations from +-1/8 (in torus words)."""
    n = len(deviations)
    mean = sum(deviations) / n
    std = math.sqrt(sum((d - mean) ** 2 for d in deviations) / n)
    return BOOL_MARGIN / std if std else math.inf


# ---------------------------------------------------------------------------
# Profiler trace reduction.
# ---------------------------------------------------------------------------

def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, start: float, end: float):
    """The stretches of [start, end] that no interval covers, in order."""
    out, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(s, e) for s, e in out if e > s]


class HostOps:
    """The host operations of one thread, properly nested, to name what
    the host was doing at a moment: the innermost operation running then."""

    def __init__(self, ops):
        ops = sorted(ops, key=lambda o: (o[1], -o[2]))    # (name, s, e)
        self.names = [o[0] for o in ops]
        self.starts = [o[1] for o in ops]
        self.ends = [o[2] for o in ops]
        self.parent, stack = [], []
        for i, (_, s, _) in enumerate(ops):
            while stack and self.ends[stack[-1]] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        if i is None or i < 0:
            return "host outside any torch op"
        return self.names[i]


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its argument list, at most ``width``
    characters: 'void ns::k<1, 0>(int const*, int)' -> 'void ns::k<1, 0>'."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i]
                break
    return name[:width].strip()


def reduce_trace(device_ops, host_ops, start: float, end: float,
                 calls: int) -> dict:
    """A traced stretch [start, end] (seconds, one clock) of ``calls``
    calls: ``device_ops`` (name, start, end, is_kernel) that ran on the
    card, ``host_ops`` (name, start, end) of the calling thread.  Returns
    the busy and window seconds, kernels per call, the ten device
    operations with the most time and the ten host operations under which
    the device was idle longest (summed over their gaps)."""
    inside = [(short_name(n), max(s, start), min(e, end), k)
              for n, s, e, k in device_ops if e > start and s < end]
    spans = [(s, e) for _, s, e, _ in inside]
    by_name: dict = {}
    for n, s, e, _ in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    host = HostOps(host_ops)
    idle: dict = {}
    for s, e in gaps(spans, start, end):
        name = host.at(0.5 * (s + e))
        idle[name] = idle.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": union_length(spans), "window_s": end - start,
            "kernels": sum(1 for op in inside if op[3]), "calls": calls,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in top_idle]}


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------

def device_info(index: int = 0) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (a card
    set below its 700 W maximum runs slower under load)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"name": None, "power_limit": f"unread: {exc}"}
    if smi.returncode or not smi.stdout.strip():
        return {"name": None, "power_limit": "unread: " + smi.stderr.strip()}
    name, limit = (s.strip() for s in
                   smi.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"name": name, "power_limit": limit}
