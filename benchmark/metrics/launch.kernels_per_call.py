"""launch.kernels_per_call: kernels that ran on the card per call, the
library's and the program's alike, counted in the profiler's trace of a
few of the cell's calls."""


def read(obs):
    prof = obs.get("profile")
    if not prof or not prof["kernels"]:
        return None
    return prof["kernels"] / prof["calls"]
