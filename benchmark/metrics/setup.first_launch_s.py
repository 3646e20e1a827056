"""setup.first_launch_s: the host seconds of the first launch of each of
the program's kernel entries on the card, summed: the one-time cost of the
kernels' first use, which the warm call of the set-up pays (the kernel
library's load and build not included).  Read from the program's
first-run records (``go_tfhe_tpu_torch/utils/tracing.py``, always kept).
None where the program keeps no such record or launched no kernel."""

import importlib


def read(obs):
    try:
        tracing = importlib.import_module("go_tfhe_tpu_torch.utils.tracing")
    except ImportError:
        return None
    first = tracing.snapshot()["first_launch_s"]
    return sum(first.values()) if first else None
