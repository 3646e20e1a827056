"""blind_rotation.k4_roofline: K4's share of its byte bound, in percent.
K4 (``go_tfhe_tpu_torch/csrc/rotdec_ext_t.cu``) rotates and decomposes the
extended rotation's (2, kN, B) accumulator once a step.  Its least bytes
a step are K6's (``blind_rotation.k6_roofline.step_bytes``): the int32
accumulator and the B int32 rotation amounts read once, and the int8
digits written once, 2L * nd planes of k*N rows of B.  The scratch of its
two-pass plan is not counted, so the share reads the same work whatever
plan runs it.  Those bytes for lwe_n steps of each bootstrap call
(``obs["bootstrap_calls"]`` a profiled call), over 3.35 TB/s, are the
least time; the share is that over the summed device seconds of the
profile's K4 entries: ``rotdec_kernel`` (the staged-column body of
``csrc/rotdec_col.cuh``) and ``untile_kernel`` (the second pass).

K4 runs the same kernel as K1 (``rotdec_col::rotdec_kernel``), so the
name match is sound only in a cell whose rotation runs no K1, one at
k > 1 on the transposed route.  K6's ``rotdec_ext_kernel`` is not
counted.  None where no K4 entry is among the profile's ten costliest
device operations."""

import re

from benchmark import harness, yardstick

KERNEL = re.compile(r"\b(rotdec_kernel|untile_kernel)\b")


def read(obs):
    prof = obs.get("profile")
    if not prof:
        return None
    seconds = sum(s for name, s in prof["device_ops"] if KERNEL.search(name))
    if not seconds:
        return None
    steps = obs["params"]["lwe_n"] * prof["calls"] * obs["bootstrap_calls"]
    least = harness.load_reader("blind_rotation.k6_roofline").step_bytes(
        obs["params"], obs["batch"]) * steps
    return 100.0 * least / yardstick.H100_HBM_BYTES / seconds
