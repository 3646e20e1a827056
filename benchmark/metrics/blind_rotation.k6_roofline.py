"""blind_rotation.k6_roofline: K6's share of its byte bound, in percent.
K6 (``go_tfhe_tpu_torch/csrc/rotdec_ext.cu``, ``rotdec_ext_kernel``)
rotates and decomposes the extended rotation's (2, B, kN) accumulator once
a step.  Its least bytes a step: the int32 accumulator and the B int32
rotation amounts read once, and the int8 digits written once, 2L * nd
planes of B*k rows of N (nd: the signed base-256 limbs of a digit).  Those
bytes for lwe_n steps of each bootstrap call (``obs["bootstrap_calls"]``
a profiled call), over 3.35 TB/s, are the least time; the share is that
over the summed device seconds of the profile's ``rotdec_ext_kernel``
entries.  None where K6 is not among the profile's ten costliest device
operations."""

import re

from benchmark import yardstick

KERNEL = re.compile(r"\brotdec_ext_kernel\b")


def step_bytes(params: dict, batch: int) -> int:
    """The bytes K6 must move in one step of ``batch`` ciphertexts."""
    kn = params["poly_extend_factor"] * params["n"]
    acc = 2 * batch * kn * 4
    amounts = batch * 4
    digits = 2 * params["l"] * yardstick.digit_limbs(params) * batch * kn
    return acc + amounts + digits


def read(obs):
    prof = obs.get("profile")
    if not prof:
        return None
    seconds = sum(s for name, s in prof["device_ops"] if KERNEL.search(name))
    if not seconds:
        return None
    steps = obs["params"]["lwe_n"] * prof["calls"] * obs["bootstrap_calls"]
    least = step_bytes(obs["params"], obs["batch"]) * steps
    return 100.0 * least / yardstick.H100_HBM_BYTES / seconds
