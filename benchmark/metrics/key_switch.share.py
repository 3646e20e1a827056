"""key_switch.share: the key switch's share of a bootstrap, in percent:
(t(engine.bootstrap) - t(engine.bootstrap_without_key_switch)) /
t(engine.bootstrap), medians of the CUDA-event times on the cell's batch."""

from benchmark import yardstick


def read(obs):
    spans = obs.get("spans", {})
    whole = spans.get("engine.bootstrap")
    rotation = spans.get("engine.bootstrap_without_key_switch")
    if not whole or not rotation:
        return None
    t_all, t_rot = yardstick.median(whole), yardstick.median(rotation)
    return 100.0 * (t_all - t_rot) / t_all
