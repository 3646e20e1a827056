"""device.idle_share.batch: the share of the profiled calls' wall time in
which no operation ran on the card, in percent (1 - union of the device
operations' intervals / window, torch.profiler)."""


def read(obs):
    prof = obs.get("profile")
    if not prof or not prof["window_s"] or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
