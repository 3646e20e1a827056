"""latency_p50_ms.chain: the median of all the window's calls, from a
call's start to the end of the wait for its output, in milliseconds: the
chain's typical gate, beside the tail that its end-to-end metric holds."""

from benchmark import yardstick


def read(obs):
    times = obs.get("latency_s")
    if not times:
        return None
    return 1e3 * yardstick.percentile(times, 50)
