"""launch.host_ms_per_call: the host's time from a call's start to its
return, before the wait for the card (what enqueueing the call's work
costs), in milliseconds: the median over the window's calls."""

from benchmark import yardstick


def read(obs):
    times = obs.get("host_return_s")
    if not times:
        return None
    return 1e3 * yardstick.median(times)
