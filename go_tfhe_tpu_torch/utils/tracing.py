"""The program's own spans and counters, on the profiler's clock.

Off by default.  Switch it on around the calls to trace::

    from go_tfhe_tpu_torch.utils import tracing
    with tracing.enabled():
        out = gates.NAND(ck, a, b)
    rec = tracing.snapshot()          # spans, counters, launches, ...
    tracing.dump("trace.jsonl")       # or keep rec; tracing.reset()

``enable()`` and ``disable()`` switch it for the rest of the process;
``utils.profiling.trace`` switches it on for its scope, so a profiler trace
taken there (``chip_smoke.py --profile``) carries the spans.

**Spans**, one per layer boundary (the entry, the engine, the blind
rotation, the sample extraction, the key switch).  A record holds the
span's name, its id, its parent's id (the innermost span open in the same
thread or task when it opened), a call id (a root span opens a new one;
its spans inherit it, so the spans of one request share it), its host
start and end in ``time.time_ns()`` (the clock of the profiler's events:
``trace_start_ns`` plus an event's relative start), its attributes and,
for a span on a CUDA device, its device time in ms between two CUDA events
recorded on the device's current stream (resolved in :func:`snapshot`, so
the traced calls never wait for the card).  While on, each span also
enters ``torch.profiler.record_function(name)``.

=========================  ==============================================
span                       covers
=========================  ==============================================
``entry.gate``             a gate of ``gates.py`` (attributes ``gate``,
                           ``batch``): preparation and bootstrap(s)
``entry.lut``              ``lut.bootstrap_func`` / ``bootstrap_lut``
                           (``batch``)
``lut.table``              the host's table for ``bootstrap_func``
                           (``Generator`` and ``gen_lut``, and its upload)
``engine.bootstrap``       ``engine._bootstrap`` and ``bootstrap_many``
                           (``route``, ``batch``, ``key_switch``)
``engine.rotation``        the blind rotation: all ``lwe_n`` steps
``rotation.ext_blocks``    an extended rotation's set-up (k > 1 only,
                           every extended route): the mod switch at 2kN,
                           the k blocks' first rotation and the
                           accumulator's layout for the step kernels
``engine.sample_extract``  the sample extraction
``key_switch``             ``ops.keyswitch.identity_key_switch``
``reencrypt``              ``proxyreenc.reencrypt``
``key_switch.limb_form``   the table's float32 limb form (a call)
``key_switch.contract``    the one-hot contraction, all chunks
=========================  ==============================================

**Counters** (while on): ``rotation.steps``, the blind-rotation steps run
(``lwe_n`` a rotation); ``rotation.block_rows``, the rows an extended
rotation's product contracts in each step (B * k a rotation: K8's or K5's
batch with the k blocks folded in); ``launch.host_ns``, the host's
nanoseconds inside ``ops.cuda_t.launch`` (library lookup, device guard,
stream, the ctypes call).  The program's kernel launches are
:data:`launch_counts` (``ops.cuda_t.launch_counts``), always counted;
:func:`snapshot` reads them.

**Always on**, whatever the switch:

* ``key_switch.transient_bytes`` (a peak, :func:`note_peak`): the largest,
  over a call's chunks and all calls since :func:`reset`, of the bytes of
  the tensors alive at the key switch's product (the table's int8 limbs
  and float32 limb form, the digits, the float32 one-hot, the product),
  read from the tensors; while on, also the ``key_switch`` (``reencrypt``)
  span's attribute ``transient_bytes`` for that call;
* the rotation counts, :data:`rotation_counts`
  (``ops.blindrotate.rotation_counts``): the blind rotations run, and of
  them those whose steps were replayed from a CUDA graph; and
  :data:`route_counts` (``ops.blindrotate.route_counts``): the same
  rotations by route, a name of ``ops.blindrotate.ROUTES``; :func:`reset`
  zeroes both;
* first-run records: the host seconds of each span site's first run in the
  process (``first_run_s``, with ``library.load`` and ``library.nvcc``,
  the kernel library's load and its build, 0 where it was built already),
  and of each kernel entry's first launch on each card
  (``first_launch_s``, keyed ``<entry>@cuda:<index>``, the library's load
  not included).  These describe the process: :func:`reset` keeps them.

**Cost.** Off, a span site costs a flag check and a set lookup, a launch a
flag check and a dict lookup, and a key switch the bytes of five tensors
summed.  On, a span costs about 11 µs on the host (``record_function``)
and two CUDA events; a launch two clock reads.  Nothing is recorded per
rotation step.  At most :data:`MAX_SPANS` records are kept; the rest are
counted in ``dropped``.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import time
from typing import Iterator

import torch

MAX_SPANS = 65536

# The switch.  Read as ``tracing.active`` by the span sites and the launch.
active = False

_spans: list = []            # finished span records, oldest first
_dropped = 0
_counters: dict = {}
_peaks: dict = {}
_first_run: dict = {}        # span site (or library.*) -> host seconds
# The always-kept counts, which the ops add to: ops.cuda_t.launch_counts
# and ops.blindrotate.rotation_counts are these objects (the benchmark's
# readers read them there).
# Kernel launches by wrapper name (ops.cuda_t.launch).  Two keys are
# sub-counts, no kernels of their own (SUB_COUNTS): "extprod_t_small"
# counts the "extprod_t" launches that took K2's small-batch form, and
# "step_t_small" those of them that also did K1's work (the fused step),
# so a total of launches leaves both out.
launch_counts = {"rotate_decompose_t": 0, "extprod_t": 0,
                 "rotate_decompose_ext_t": 0, "extprod_ext_t": 0,
                 "rotate_decompose_ext": 0, "rotate_decompose": 0,
                 "extprod": 0, "fused_rotate_step": 0, "pipe_step": 0,
                 "extprod_t_small": 0, "step_t_small": 0}
SUB_COUNTS = ("extprod_t_small", "step_t_small")
rotation_counts = {"rotations": 0, "replayed": 0}
# The rotations by route (a name of ops.blindrotate.ROUTES): a route
# appears at its first rotation since reset().
route_counts: dict = {}
# (entry, card index) -> host seconds of its first launch; ops.cuda_t.launch
# looks its key up on every launch and writes it on the first.
first_launches: dict = {}
_seen: set = set()           # span sites whose first run has started
_ids = itertools.count(1)
_calls = itertools.count(1)
# The innermost open span's record in this thread or task.
_open: contextvars.ContextVar = contextvars.ContextVar(
    "go_tfhe_tpu_torch_open_span", default=None)
_NULL = contextlib.nullcontext()


def enable() -> None:
    global active
    active = True


def disable() -> None:
    global active
    active = False


@contextlib.contextmanager
def enabled() -> Iterator[None]:
    """The recorder on for the scope, then as it was."""
    global active
    was, active = active, True
    try:
        yield
    finally:
        active = was


class _FirstRun:
    """Off: times a span site's first run in the process."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _seen.add(self.name)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _first_run[self.name] = time.perf_counter() - self.t0
        return False


class _Span:
    """On: one span record (see the module docstring)."""

    __slots__ = ("rec", "device", "first", "token", "rf", "events", "t0")

    def __init__(self, name: str, device, attrs: dict):
        self.rec = {"name": name, "attrs": attrs}
        self.device = device

    def __enter__(self):
        rec = self.rec
        name = rec["name"]
        self.first = name not in _seen
        if self.first:
            _seen.add(name)
        parent = _open.get()
        rec["id"] = next(_ids)
        rec["parent"] = None if parent is None else parent["id"]
        rec["call"] = next(_calls) if parent is None else parent["call"]
        self.token = _open.set(rec)
        self.rf = torch.profiler.record_function(name)
        self.rf.__enter__()
        self.events = None
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            stream = torch.cuda.current_stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        self.t0 = time.perf_counter()
        rec["start_ns"] = time.time_ns()
        return rec

    def __exit__(self, *exc):
        global _dropped
        rec = self.rec
        rec["end_ns"] = time.time_ns()
        if self.first:
            _first_run[rec["name"]] = time.perf_counter() - self.t0
        if self.events is not None:
            self.events[1].record(self.events[2])
            rec["_events"] = self.events[:2]
        self.rf.__exit__(*exc)
        _open.reset(self.token)
        if len(_spans) < MAX_SPANS:
            _spans.append(rec)
        else:
            _dropped += 1
        return False


def span(name: str, device=None, **attrs):
    """A context manager around one layer's work: a span record while the
    recorder is on, the site's first-run record on its first run, else
    nothing.  ``device``: the device the work runs on (CUDA events are
    recorded on its current stream); ``attrs``: the record's attributes.
    While on, ``with span(...) as rec`` gives the record."""
    if active:
        return _Span(name, device, attrs)
    if name in _seen:
        return _NULL
    return _FirstRun(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if active:
        _counters[name] = _counters.get(name, 0) + n


def note_peak(name: str, value) -> None:
    """Keep the largest ``value`` seen under ``name`` (always); while on,
    also set it as an attribute of the innermost open span."""
    if name not in _peaks or value > _peaks[name]:
        _peaks[name] = value
    if active:
        rec = _open.get()
        if rec is not None:
            rec["attrs"][name.rsplit(".", 1)[-1]] = value


def note_first_run(name: str, seconds: float) -> None:
    """A first-run record made outside a span (the kernel library)."""
    _first_run.setdefault(name, seconds)


def reset() -> None:
    """Drop the span records, counters and peaks and zero the rotation
    counts, overall and by route (not the first-run records, which
    describe the process)."""
    global _dropped
    _spans.clear()
    _counters.clear()
    _peaks.clear()
    _dropped = 0
    rotation_counts.update(dict.fromkeys(rotation_counts, 0))
    route_counts.clear()


def snapshot() -> dict:
    """What was recorded since :func:`reset`: ``spans`` (records, oldest
    first, each with ``device_ms``: None off a CUDA device), ``counters``,
    ``peaks``, ``rotations`` (:data:`rotation_counts`, and under
    ``by_route`` :data:`route_counts`), ``launches``
    (:data:`launch_counts` as they stand), ``first_run_s``,
    ``first_launch_s`` and ``dropped``.  Waits for the card where a span's
    end event has not completed."""
    for rec in _spans:
        events = rec.pop("_events", None)
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
        else:
            rec.setdefault("device_ms", None)
    return {"spans": [dict(rec) for rec in _spans],
            "counters": dict(_counters), "peaks": dict(_peaks),
            "rotations": {**rotation_counts, "by_route": dict(route_counts)},
            "launches": dict(launch_counts),
            "first_run_s": dict(_first_run),
            "first_launch_s": {f"{entry}@cuda:{index}": s
                               for (entry, index), s
                               in first_launches.items()},
            "dropped": _dropped}


def dump(path: str) -> dict:
    """Write :func:`snapshot` as JSON lines: one line of everything but
    the spans (``"kind": "summary"``), then one line a span
    (``"kind": "span"``).  Returns the snapshot."""
    snap = snapshot()
    with open(path, "w") as f:
        summary = {k: v for k, v in snap.items() if k != "spans"}
        f.write(json.dumps({"kind": "summary", **summary}) + "\n")
        for rec in snap["spans"]:
            f.write(json.dumps({"kind": "span", **rec}) + "\n")
    return snap
