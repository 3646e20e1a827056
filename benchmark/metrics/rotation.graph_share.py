"""rotation.graph_share: the share of the run's blind rotations through
``blind_rotate_t`` (``go_tfhe_tpu_torch/ops/blindrotate.rotation_counts
["rotations"]``) whose steps were replayed from a CUDA graph
(``rotation_counts["replayed"]``), in percent.  None where the program has
no such counter (a program that launches every step from the host) or ran
no such rotation."""

import importlib


def read(obs):
    try:
        blindrotate = importlib.import_module(
            "go_tfhe_tpu_torch.ops.blindrotate")
    except ImportError:
        return None
    counts = getattr(blindrotate, "rotation_counts", None)
    if counts is None or not counts.get("rotations"):
        return None
    return 100.0 * counts.get("replayed", 0) / counts["rotations"]
