"""rotation.ext_t_share: the share of the run's blind rotations that took
the transposed extended route, ``blind_rotate_extended_t`` (K4 + K5), in
percent: ``go_tfhe_tpu_torch/utils/tracing.route_counts`` (the blind
rotations by route, always kept) over all its rotations.  None where the
program has no such count (a program that counts rotations only
together) or ran no rotation."""

import importlib

ROUTE = "blind_rotate_extended_t"


def read(obs):
    try:
        tracing = importlib.import_module("go_tfhe_tpu_torch.utils.tracing")
    except ImportError:
        return None
    counts = getattr(tracing, "route_counts", None)
    if counts is None:
        return None
    total = sum(counts.values())
    if not total:
        return None
    return 100.0 * counts.get(ROUTE, 0) / total
