"""blind_rotation.k8_roofline: K8's share of its int8 bound, in percent.
K8 (``go_tfhe_tpu_torch/csrc/extprod.cu``, ``extprod_kernel``) is the
row-major external product of the extended rotation, all k blocks against
one band: its least time for the profiled calls is the rotation's int8
operations (the yardstick's ``rotation_ops`` of the cell's batch, k
counted) times the calls and each call's bootstrap calls
(``obs["bootstrap_calls"]``, the op's) over 1,979 TOP/s; the share is
that over the summed device seconds of the profile's ``extprod_kernel``
entries (not K2's ``extprod_t_kernel``).  None where K8 is not among the
profile's ten costliest device operations."""

import re

from benchmark import yardstick

KERNEL = re.compile(r"\bextprod_kernel\b")


def read(obs):
    prof = obs.get("profile")
    if not prof:
        return None
    seconds = sum(s for name, s in prof["device_ops"] if KERNEL.search(name))
    if not seconds:
        return None
    ops = (yardstick.rotation_ops(obs["params"], obs["batch"])
           * prof["calls"] * obs["bootstrap_calls"])
    return 100.0 * ops / yardstick.H100_INT8_OPS / seconds
