"""The program's own spans and counters in one benchmark cell, on the card.

    python3 tools/torch_program_trace.py --workload <cell> --seed <n>
        [--seconds 30] [--on-cost] [--out trace.json]

Sets the cell up as ``benchmark/run.py`` does (the same data from the
seed, the same warm call), runs its measured window with the recorder
(``go_tfhe_tpu_torch/utils/tracing.py``) off, times the layer spans of the
benchmark's traced run (``key_switch.share``'s subtraction), then runs the
cell's own calls in two passes with the recorder on:

(a) without the profiler, so that host times carry no profiler cost:

    * ``key_switch.span_share``: device ms of ``key_switch`` over device ms
      of ``engine.bootstrap`` in the same call, in percent, median over
      calls;
    * ``key_switch.transient_gib``: the largest ``transient_bytes`` of a
      call's ``key_switch`` span, in GiB;
    * ``blind_rotation.host_us_per_step``: host duration of
      ``engine.rotation`` over its steps (``rotation.steps`` over the
      rotations), median over calls, in µs;
    * ``launch.host_us_per_kernel``: ``launch.host_ns`` over the pass's
      kernel launches (``ops.cuda_t.launch_counts``), in µs;
    * ``entry_host_ms_per_call``: host duration of the ``entry.*`` span,
      median over calls (beside the window's ``launch.host_ms_per_call``,
      taken with the recorder off: the difference is the recorder's cost);
    * ``rotation.ext_blocks``: the extended rotation's set-up (k > 1, one
      span a bootstrap), its host and device ms, medians over calls;
    * ``rotation.block_rows``: the counter over the rotations, the rows
      K8 (or K5) contracts a step (B * k);
    * ``launches_per_call_by_entry``: each kernel entry's launches a call
      (``ops.cuda_t.launch_counts``, whose ``extprod_t_small`` and
      ``step_t_small`` are parts of ``extprod_t``; ``lwe_n`` of
      ``rotate_decompose_ext`` and of ``extprod`` a call at uint8);
    * ``sites``: each span's host and device ms, medians over calls;

(b) under ``torch.profiler``: each stretch in which no operation ran on the
card is put down to the innermost program span the host was in then
(``idle_gaps_by_span``; "outside the program" where it was in none), and
``device.idle_share.in_program`` is the idle time while the host was inside
an ``entry.*`` span over the traced window, in percent.

With ``--on-cost`` four more windows of ``--seconds`` follow, recorder
off, on, on, off, each giving ``bootstraps_per_s`` and ``latency_p50_ms``:
the recorder's cost on the cell's end-to-end metrics, on one seed in one
process.  The process's first-run records (``first_run_s``,
``first_launch_s``) close the line.  The last window's outputs are held to
the plain reference (``correct``).  Prints one JSON line; ``--out`` also
writes it to a file.  Needs a CUDA card.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, yardstick  # noqa: E402

WINDOW = "program_trace.window"
OUTSIDE = "outside the program"


def _median(values):
    return yardstick.median(values) if values else None


def _calls(r, n: int) -> None:
    """n of the cell's own calls, each waited for, as the window makes
    them."""
    tr, prev = r.traffic, None
    for k in range(n):
        out = tr.call(r.port, r.ck, tr.request(r.inputs, k, prev))
        prev = out if tr.chain else None
        harness._sync(r.device)


def _kernel_launches(counts: dict) -> int:
    """The launches in ``launch_counts``: its sub-counts
    (``utils/tracing.SUB_COUNTS``: ``extprod_t_small`` and ``step_t_small``,
    parts of ``extprod_t``'s count) are not launches of their own."""
    from go_tfhe_tpu_torch.utils import tracing
    return sum(v for k, v in counts.items() if k not in tracing.SUB_COUNTS)


def _per_rotation(snap: dict, counter: str):
    """A counter over the pass's rotations (``engine.rotation`` spans)."""
    rotations = sum(s["name"] == "engine.rotation" for s in snap["spans"])
    value = snap["counters"].get(counter)
    return value / rotations if rotations and value is not None else None


def pass_a(r, tracing, n: int) -> dict:
    """The recorder on, no profiler (see the module docstring)."""
    from go_tfhe_tpu_torch.ops import cuda_t
    tracing.reset()
    counts = dict(cuda_t.launch_counts)
    before = _kernel_launches(counts)
    with tracing.enabled():
        _calls(r, n)
    snap = tracing.snapshot()
    launches = _kernel_launches(snap["launches"]) - before
    by_call: dict = {}
    for s in snap["spans"]:
        by_call.setdefault(s["call"], []).append(s)
    share, per_step, entry_ms, transient = [], [], [], []
    sites: dict = {}
    steps = _per_rotation(snap, "rotation.steps")
    for spans in by_call.values():
        named = {}
        for s in spans:
            named.setdefault(s["name"], []).append(s)
            host_ms = (s["end_ns"] - s["start_ns"]) / 1e6
            site = sites.setdefault(s["name"], {"host_ms": [],
                                                "device_ms": []})
            site["host_ms"].append(host_ms)
            if s["device_ms"] is not None:
                site["device_ms"].append(s["device_ms"])
            if s["name"].startswith("entry."):
                entry_ms.append(host_ms)
            if s["name"] == "engine.rotation" and steps:
                per_step.append(1e3 * host_ms / steps)
            if s["name"] in ("key_switch", "reencrypt"):
                transient.append(s["attrs"].get("transient_bytes", 0))
        boot, switch = named.get("engine.bootstrap"), named.get("key_switch")
        if (boot and switch and len(boot) == 1 and len(switch) == 1
                and switch[0]["parent"] == boot[0]["id"]
                and boot[0]["device_ms"]):
            share.append(100.0 * switch[0]["device_ms"] / boot[0]["device_ms"])
    host_ns = snap["counters"].get("launch.host_ns")
    sites = {name: {k: _median(v) for k, v in site.items()}
             for name, site in sites.items()}
    return {
        "calls": len(by_call),
        "key_switch.span_share": _median(share),
        "key_switch.transient_gib": (max(transient) / float(1 << 30)
                                     if transient else None),
        "blind_rotation.host_us_per_step": _median(per_step),
        "launch.host_us_per_kernel": (host_ns / 1e3 / launches
                                      if host_ns and launches else None),
        "launches_per_call": launches / max(1, len(by_call)),
        "launches_per_call_by_entry": {
            name: (count - counts.get(name, 0)) / max(1, len(by_call))
            for name, count in snap["launches"].items()
            if count != counts.get(name, 0)},
        "entry_host_ms_per_call": _median(entry_ms),
        "rotation.ext_blocks": sites.get("rotation.ext_blocks"),
        "rotation.block_rows": _per_rotation(snap, "rotation.block_rows"),
        "sites": sites,
        "dropped": snap["dropped"],
    }


def pass_b(r, tracing, n: int) -> dict:
    """The recorder on under torch.profiler: idle stretches by span."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if r.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    tracing.reset()
    harness._sync(r.device)
    with tracing.enabled(), profile(activities=activities) as prof:
        with record_function(WINDOW):
            _calls(r, n)
    names = {s["name"] for s in tracing.snapshot()["spans"]}
    device_ops, spans, window = [], [], None
    events = prof.events()
    for e in events:
        if e.name == WINDOW and e.device_type != torch.autograd.DeviceType.CUDA:
            window, thread = (e.time_range.start / 1e6,
                              e.time_range.end / 1e6), e.thread
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in names | {WINDOW, "Command Buffer Full"}):
                device_ops.append((s, t))
        elif e.thread == thread and e.name in names:
            spans.append((e.name, s, t))
    inner = yardstick.HostOps(spans)
    entries = yardstick.HostOps([x for x in spans
                                 if x[0].startswith("entry.")])
    outside = yardstick.HostOps([]).at(0.0)
    by_span: dict = {}
    in_program = 0.0
    for s, t in yardstick.gaps(device_ops, *window):
        mid = 0.5 * (s + t)
        name = inner.at(mid)
        name = OUTSIDE if name == outside else name
        by_span[name] = by_span.get(name, 0.0) + (t - s)
        if entries.at(mid) != outside:
            in_program += t - s
    width = window[1] - window[0]
    busy = yardstick.union_length(
        [(max(s, window[0]), min(t, window[1])) for s, t in device_ops
         if t > window[0] and s < window[1]])
    return {"window_s": width, "busy_s": busy,
            "device.idle_share": 100.0 * (1.0 - busy / width),
            "device.idle_share.in_program": 100.0 * in_program / width,
            "idle_gaps_by_span": sorted(([k, v] for k, v in by_span.items()),
                                        key=lambda kv: -kv[1])}


def window_reading(r) -> dict:
    lat_ms = [1e3 * s for s in r.latency_s]
    return {"calls": r.calls, "window_s": r.window_s,
            "bootstraps_per_s": r.calls * r.traffic.batch / r.window_s,
            "latency_p50_ms": yardstick.percentile(lat_ms, 50),
            "launch.host_ms_per_call":
                1e3 * yardstick.median(r.obs["host_return_s"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--on-cost", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    from go_tfhe_tpu_torch.utils import tracing
    cell = harness.load_cell(args.workload)
    r = harness.Run(cell, args.seed, args.seconds, "cuda:0", T_PROCESS)
    r.setup()
    r.window()
    line = {"workload": cell.name, "seed": args.seed,
            "window_off": window_reading(r)}
    r.spans()
    line["key_switch.share"] = harness.load_reader("key_switch.share").read(
        r.obs)
    n = harness.PROFILED_CALLS[r.traffic.chain]
    line["pass_a"] = pass_a(r, tracing, n)
    line["pass_b"] = pass_b(r, tracing, n)
    if args.on_cost:
        runs = []
        for on in (False, True, True, False):
            tracing.reset()
            with tracing.enabled() if on else contextlib.nullcontext():
                r.window()
            runs.append({"recorder": on, **window_reading(r)})
        line["on_cost"] = runs
    tracing.reset()
    snap = tracing.snapshot()
    line["first_run_s"] = snap["first_run_s"]
    line["first_launch_s"] = snap["first_launch_s"]
    line["setup_split"] = r.split
    r.free_program()
    verdict = r.judge()
    line["correct"] = verdict["failed"] == 0 and verdict["attempted"] > 0
    line["device"] = yardstick.device_info(0)
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
