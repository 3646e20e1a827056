"""extprod.small_batch_share: the share of the run's external products
(K2 launches, ``go_tfhe_tpu_torch/ops/cuda_t.launch_counts["extprod_t"]``)
that took K2's small-batch form (``launch_counts["extprod_t_small"]``), in
percent.  None where the program has no such counter (a program without
the small form) or launched no K2."""

import importlib


def read(obs):
    try:
        cuda_t = importlib.import_module("go_tfhe_tpu_torch.ops.cuda_t")
    except ImportError:
        return None
    counts = cuda_t.launch_counts
    small, total = counts.get("extprod_t_small"), counts.get("extprod_t", 0)
    if small is None or not total:
        return None
    return 100.0 * small / total
