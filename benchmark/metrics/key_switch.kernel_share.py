"""key_switch.kernel_share: the share of the run's key switches
(``go_tfhe_tpu_torch/utils/tracing.key_switch_counts["switches"]``: every
call of ``ops.keyswitch.digit_table_switch``) that launched the
gather-and-sum kernel (``ops/cuda_t.launch_counts["key_switch"]``), in
percent.  None where the program has no such counters (a program whose key
switch has no kernel) or ran no key switch."""

import importlib


def read(obs):
    try:
        tracing = importlib.import_module("go_tfhe_tpu_torch.utils.tracing")
    except ImportError:
        return None
    switches = getattr(tracing, "key_switch_counts", {}).get("switches")
    kernel = getattr(tracing, "launch_counts", {}).get("key_switch")
    if not switches or kernel is None:
        return None
    return 100.0 * kernel / switches
