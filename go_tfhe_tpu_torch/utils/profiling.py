"""Cost model, speed of light and tracing of the bootstrap on an NVIDIA
H100 (port of ``go_tfhe_tpu/utils/profiling.py``).

The cost model counts the blind rotation's external-product work from the
profile alone, so that a measured throughput reads against the same work
whatever kernel computes it.  Per step and ciphertext, digit limb i of the
2L*N digits multiplies the key limbs l >= drop of weight 2^(8(i+l)) < 2^32
(:func:`limb_pairs`; drop = ``params.band_limb_drop``, the key limbs the
bands are packed without), in both output channels:

    MACs/step/ct = (2L*N) * 2 * limb_pairs(p) * N

``steps``, ``macs_per_ct`` and ``flops_per_ct`` are the JAX module's word
for word.  Like it, they count one N-block a step for the extended profiles
(poly_extend_factor k > 1) too, whose external products contract k blocks:
uint6_centered (k 2) counts as uint5 (k 1) does.  Where the port differs
(each difference pinned by tests/test_torch_profiling.py):

* the peaks are :data:`H100_PEAKS`, from NVIDIA's H100 SXM5 data sheet
  (dense rates), in place of the TPU peaks; the default generation is
  ``"h100"``;
* ``dot_dtype`` is ``"int8"`` for every profile: the port's external
  products (K2, K5, K8, K3, K9) run s8 tensor-core limb pairs at every
  profile, where the JAX module says ``"bf16"`` for 3 digit limbs (its TPU
  kernel's split-K branch, which the port does not have);
* ``bsk_bytes`` is the size of the port's resident bands, (lwe_n, 2, 2L,
  2N) int32 (``keys.CloudKey.bands``), not of the Pallas band layout, and
  :func:`key_memory_usage` reports the port's CloudKey fields;
* :func:`trace` is a ``torch.profiler`` scope, with the program's
  recorder (``utils/tracing.py``) on.

``chip_smoke.py``'s per-kernel bounds read :func:`limb_pairs` and
:data:`H100_PEAKS` from here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator

import torch

from ..params import TFHEParams, band_limb_drop
from . import tracing

# Dense peaks of one NVIDIA H100 SXM5 at its 700 W limit (NVIDIA's data
# sheet): bf16 tensor-core TFLOP/s, int8 tensor-core TOP/s, HBM3 GB/s.  A
# card set to a lower power limit runs below them.
H100_PEAKS: Dict[str, Dict[str, float]] = {
    "h100": {"bf16_tflops": 989.0, "int8_tops": 1979.0, "hbm_gbps": 3350.0},
}

NUM_KERNEL_LIMBS = 4  # balanced base-256 limbs of a 32-bit band word


def limb_pairs(p: TFHEParams) -> int:
    """The (digit limb i, key limb l) pairs an external product multiplies:
    l >= drop (``band_limb_drop(p)``) and i + l < 4, since pairs of weight
    2^32 and above vanish mod 2^32."""
    drop = band_limb_drop(p)
    return sum(max(0, NUM_KERNEL_LIMBS - drop - i)
               for i in range(p.digit_limbs))


@dataclasses.dataclass(frozen=True)
class BootstrapCost:
    """Analytic cost of one batched gate/PBS bootstrap."""
    batch: int
    steps: int                  # lwe_n sequential CMUX iterations
    macs_per_ct: float          # tensor-core MACs per ciphertext
    flops_per_ct: float
    dot_dtype: str              # "int8": the s8 tensor-core limb pairs
    bsk_bytes: int              # resident bands (keys.CloudKey.bands)
    ksk_bytes: int

    def seconds_at(self, tflops: float) -> float:
        """Compute-bound lower bound for the whole batch."""
        return self.batch * self.flops_per_ct / (tflops * 1e12)

    def bootstraps_per_sec_at(self, tflops: float) -> float:
        return self.batch / self.seconds_at(tflops)


def bootstrap_cost(p: TFHEParams, batch: int = 1) -> BootstrapCost:
    """The cost of a bootstrap at profile p (see the module docstring)."""
    macs_step = (2 * p.l * p.n) * 2 * limb_pairs(p) * p.n
    macs = float(macs_step) * p.lwe_n
    bsk_bytes = p.lwe_n * 2 * 2 * p.l * 2 * p.n * 4
    ksk_bytes = p.n * p.iks_t * p.base * (p.lwe_n + 1) * 4
    return BootstrapCost(batch=batch, steps=p.lwe_n, macs_per_ct=macs,
                         flops_per_ct=2 * macs, dot_dtype="int8",
                         bsk_bytes=bsk_bytes, ksk_bytes=ksk_bytes)


def speed_of_light_report(p: TFHEParams, measured_bootstraps_per_sec: float,
                          generation: str = "h100",
                          peaks: Dict[str, float] | None = None) -> str:
    """Human-readable speed-of-light table for the bootstrap hot loop."""
    peak = (peaks or H100_PEAKS[generation])["int8_tops"]
    c = bootstrap_cost(p)
    sol = c.bootstraps_per_sec_at(peak)
    util = measured_bootstraps_per_sec / sol if sol else 0.0
    lines = [
        f"profile {p.name}: {c.steps} blind-rotate steps, "
        f"{p.digit_limbs} digit limb(s), {c.dot_dtype} tensor-core dot",
        f"  compute/ct:      {c.flops_per_ct / 1e9:.2f} GFLOP",
        f"  BSK bands:       {c.bsk_bytes / 1e6:.1f} MB resident",
        f"  KSK:             {c.ksk_bytes / 1e6:.1f} MB resident",
        f"  speed of light:  {sol:.0f} bootstraps/s at {peak:.0f} TOP/s "
        f"({generation})",
        f"  measured:        {measured_bootstraps_per_sec:.0f} bootstraps/s "
        f"({100 * util:.1f}% of SoL)",
    ]
    return "\n".join(lines)


def bootstrap_utilization(p: TFHEParams, measured_bootstraps_per_sec: float,
                          generation: str = "h100") -> Dict[str, object]:
    """Machine-readable MFU summary for benchmark JSON: the measured rate
    over the speed of light of :func:`bootstrap_cost`'s work at the
    generation's peak."""
    c = bootstrap_cost(p)
    sol = c.bootstraps_per_sec_at(H100_PEAKS[generation]["int8_tops"])
    return {
        "gflop_per_ct": round(c.flops_per_ct / 1e9, 2),
        "dot_dtype": c.dot_dtype,
        "sol_bootstraps_per_sec": round(sol, 0),
        "mfu": round(measured_bootstraps_per_sec / sol, 4) if sol else 0.0,
    }


def key_memory_usage(ck) -> Dict[str, int]:
    """Bytes of each tensor of a CloudKey, and their total (the
    reference's BufferPool.MemoryUsage analogue)."""
    out = {name: getattr(ck, name).numel() * getattr(ck, name).element_size()
           for name in ("testvec", "ksk", "bsk", "bands")}
    out["total"] = sum(out.values())
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` scope over the CPU and, where a card is
    present, its CUDA activity; on exit (after a synchronize) it writes a
    Chrome trace, ``<host>_<pid>.<time>.pt.trace.json``, into ``log_dir``
    (viewable in Perfetto or TensorBoard).  Yields the profiler, whose
    ``key_averages()`` sum the events by name.  The program's recorder
    (:mod:`.tracing`) is on for the scope, so the trace carries its
    spans."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing.enabled(), profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
