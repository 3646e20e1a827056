"""rotation.fused_step_share: the share of the run's blind-rotation steps
through ``blind_rotate_t`` that ran as one launch, K1's rotate and
decompose made inside K2's small form
(``go_tfhe_tpu_torch/ops/cuda_t.launch_counts["step_t_small"]``), against
those that launched K1 apart (``launch_counts["rotate_decompose_t"]``), in
percent.  None where the program has no such counter (a program without
the fused step) or launched neither."""

import importlib


def read(obs):
    try:
        cuda_t = importlib.import_module("go_tfhe_tpu_torch.ops.cuda_t")
    except ImportError:
        return None
    counts = getattr(cuda_t, "launch_counts", None) or {}
    fused = counts.get("step_t_small")
    if fused is None:
        return None
    total = fused + counts.get("rotate_decompose_t", 0)
    if not total:
        return None
    return 100.0 * fused / total
