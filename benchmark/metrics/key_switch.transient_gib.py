"""key_switch.transient_gib: the most bytes the key switch holds at its
product in one call (the table's int8 limbs and float32 limb form, the
digits, the float32 one-hot, the product), in GiB: the program's own peak
``key_switch.transient_bytes`` (``go_tfhe_tpu_torch/utils/tracing.py``,
always kept), over the run's calls.  None where the program keeps no such
record."""

import importlib


def read(obs):
    try:
        tracing = importlib.import_module("go_tfhe_tpu_torch.utils.tracing")
    except ImportError:
        return None
    value = tracing.snapshot()["peaks"].get("key_switch.transient_bytes")
    return None if value is None else value / float(1 << 30)
