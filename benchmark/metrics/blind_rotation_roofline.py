"""blind_rotation_roofline: the blind rotation's share of its roofline, in
percent: the least time an H100 needs for the rotation of the cell's batch
(the yardstick's int8 operations over 1,979 TOP/s or bytes over 3.35 TB/s,
the larger) over the median time of ``engine.bootstrap_without_key_switch``
on that batch (CUDA events; the sample extraction inside it is a copy)."""

from benchmark import yardstick


def read(obs):
    times = obs.get("spans", {}).get("engine.bootstrap_without_key_switch")
    if not times:
        return None
    bound = yardstick.rotation_bound_s(obs["params"], obs["batch"])
    return 100.0 * bound / yardstick.median(times)
