"""The program's recorder (go_tfhe_tpu_torch/utils/tracing.py): off it
records nothing and calls no ``record_function``; on, a gate or a PBS
gives the span tree of its layers under one call id, on the profiler's
clock, with the counters and the key switch's transient bytes that the
profile's shapes give; outputs are the same words either way."""

import ast
import contextlib
import dataclasses
import importlib.util
import inspect
import json
import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import (cipher, engine, gates, keys, lut,  # noqa: E402
                               params, proxyreenc)
from go_tfhe_tpu_torch.ops import (_build, blindrotate, cuda_t,  # noqa: E402
                                   keyswitch)
from go_tfhe_tpu_torch.utils import profiling, tracing  # noqa: E402

SWITCH_TREE = {"key_switch": "engine.bootstrap",
               "key_switch.limb_form": "key_switch",
               "key_switch.contract": "key_switch",
               "engine.rotation": "engine.bootstrap",
               "engine.sample_extract": "engine.bootstrap"}


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _setup(profile):
    p = params.get_params(profile)
    gen = torch.Generator().manual_seed(17)
    sk = keys.gen_secret_key(gen, p, "cpu")
    return p, gen, sk, keys.gen_cloud_key(gen, sk, p)


@pytest.fixture(scope="module")
def fast():
    return _setup("test_fast")


@pytest.fixture(scope="module")
def pbs():
    return _setup("test_pbs")


def _bits(gen, p, sk, n=3):
    bits = torch.randint(0, 2, (n,), generator=gen).bool()
    return cipher.lwe_encrypt_bool(gen, bits, p.lwe_alpha, sk.lv0)


def _calls(fast, pbs):
    """Each traced entry as (profile, entry span, bootstraps, fn)."""
    p, gen, sk, ck = fast
    a, b, c = (_bits(gen, p, sk) for _ in range(3))
    q, qgen, qsk, qck = pbs
    msg = cipher.lwe_encrypt_message(qgen, [1, 5, 7], q.message_modulus,
                                     q.lwe_alpha, qsk.lv0)
    return {
        "nand": (p, "entry.gate", 1, lambda: gates.NAND(ck, a, b)),
        "mux": (p, "entry.gate", 2, lambda: gates.MUX(ck, a, b, c)),
        "and_or": (p, "entry.gate", 1,
                   lambda: torch.stack(gates.AND_OR(ck, a, b))),
        "lut": (q, "entry.lut", 1, lambda: lut.bootstrap_func(
            qck, msg, lambda x: (3 * x + 1) % q.message_modulus,
            q.message_modulus)),
    }


def _run_on(fn):
    with tracing.enabled():
        out = fn()
    return out, tracing.snapshot()


# ---------------------------------------------------------------------------
# Off.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["nand", "lut"])
def test_off_records_no_span_and_calls_no_record_function(
        which, fast, pbs, monkeypatch):
    _, _, _, fn = _calls(fast, pbs)[which]
    fn()                                    # the sites' first runs
    uses = []
    real = torch.profiler.record_function

    def counted(*args, **kwargs):
        uses.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    fn()
    snap = tracing.snapshot()
    assert uses == []
    assert snap["spans"] == [] and snap["counters"] == {}
    _, snap = _run_on(fn)                   # the same patch sees the spans
    assert len(uses) == len(snap["spans"]) > 0


@pytest.mark.parametrize("which", ["nand", "lut"])
def test_on_gives_the_layer_tree_of_one_call(which, fast, pbs):
    _, entry, _, fn = _calls(fast, pbs)[which]
    _, snap = _run_on(fn)
    spans = snap["spans"]
    by_id = {s["id"]: s for s in spans}
    names = sorted(s["name"] for s in spans)
    want = {"engine.bootstrap": entry, **SWITCH_TREE}
    if which == "lut":
        want["lut.table"] = entry
    assert names == sorted([entry, *want])
    assert len({s["call"] for s in spans}) == 1
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] is None                    # a CPU run
        if s["name"] == entry:
            assert s["parent"] is None
            assert s["attrs"]["batch"] == 3
            continue
        parent = by_id[s["parent"]]
        assert parent["name"] == want[s["name"]]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]
    boot = next(s for s in spans if s["name"] == "engine.bootstrap")
    assert boot["attrs"] == {"route": "blind_rotate_t", "batch": 3,
                             "key_switch": True}


@pytest.mark.parametrize("which", ["nand", "mux", "and_or", "lut"])
def test_rotation_steps_count_lwe_n_a_bootstrap(which, fast, pbs):
    p, _, boots, fn = _calls(fast, pbs)[which]
    _, snap = _run_on(fn)
    assert snap["counters"]["rotation.steps"] == boots * p.lwe_n
    assert sum(s["name"] == "engine.rotation"
               for s in snap["spans"]) == boots


def _transient_bytes(p, rows_b):
    """The bytes alive at the key switch's product, from the shapes."""
    rows, w = p.n * p.iks_t * p.base, p.lwe_n + 1
    limbs = 4 * rows * w                                   # int8
    table_f = rows * 4 * w * 4                             # float32
    digits = rows_b * p.n * p.iks_t * 4                    # int32
    onehot = rows_b * p.n * p.iks_t * p.base * 4           # float32
    acc = rows_b * 4 * w * 4
    return limbs + table_f + digits + onehot + acc


@pytest.mark.parametrize("profile,batch,chunk", [
    ("test_fast", 3, 4096), ("test_pbs", 5, 4096), ("test_fast", 7, 3)])
def test_transient_bytes_match_the_shapes(profile, batch, chunk, fast, pbs,
                                          monkeypatch):
    p, gen, _, ck = fast if profile == "test_fast" else pbs
    monkeypatch.setattr(keyswitch, "_CHUNK", chunk)
    lv1 = torch.randint(-2 ** 31, 2 ** 31, (batch, p.n + 1),
                        generator=gen, dtype=torch.int32)
    keyswitch.identity_key_switch(p, ck.ksk, lv1)          # off: a peak
    want = _transient_bytes(p, min(batch, chunk))
    assert tracing.snapshot()["peaks"] == {
        "key_switch.transient_bytes": want}
    tracing.reset()
    _, snap = _run_on(lambda: keyswitch.identity_key_switch(p, ck.ksk, lv1))
    switch = next(s for s in snap["spans"] if s["name"] == "key_switch")
    assert switch["attrs"] == {"transient_bytes": want}
    assert snap["peaks"]["key_switch.transient_bytes"] == want


@pytest.mark.parametrize("which", ["mux", "reencrypt"])
def test_mux_and_reencrypt_record_their_switch_spans(which, fast):
    p, gen, sk, ck = fast
    if which == "mux":
        a, b, c = (_bits(gen, p, sk) for _ in range(3))
        _, snap = _run_on(lambda: gates.MUX(ck, a, b, c))
        root, switch = "entry.gate", "key_switch"
    else:
        rk = proxyreenc.gen_reencryption_key_symmetric(gen, sk.lv0, sk.lv0,
                                                       p)
        ct = _bits(gen, p, sk)
        _, snap = _run_on(lambda: proxyreenc.reencrypt(rk, ct))
        root = switch = "reencrypt"
    by_id = {s["id"]: s for s in snap["spans"]}
    switches = [s for s in snap["spans"] if s["name"] == switch]
    assert len(switches) == 1
    children = sorted(s["name"] for s in snap["spans"]
                      if s["parent"] == switches[0]["id"])
    assert children == ["key_switch.contract", "key_switch.limb_form"]
    if which == "mux":
        assert by_id[switches[0]["parent"]]["name"] == root
        boots = [s for s in snap["spans"] if s["name"] == "engine.bootstrap"]
        assert [s["attrs"]["key_switch"] for s in boots] == [False, False]
    assert "transient_bytes" in switches[0]["attrs"]


@pytest.mark.parametrize("which", ["nand", "mux", "and_or", "lut"])
def test_outputs_equal_on_and_off(which, fast, pbs):
    _, _, _, fn = _calls(fast, pbs)[which]
    off = fn()
    on, snap = _run_on(fn)
    assert snap["spans"]
    assert torch.equal(on, off)


# ---------------------------------------------------------------------------
# The extended routes (k > 1).
# ---------------------------------------------------------------------------

# The two extended routes by the key's layout (engine._route): K4/K5 for a
# transposed key where the transposed kernels fit, K6/K8 otherwise.
EXT_ROUTES = {True: "blind_rotate_extended_t",
              False: "blind_rotate_extended_rm"}


@pytest.fixture(scope="module")
def ext9():
    """A toy profile at uint8's k = 9, gadget and key switch, on N 256."""
    p = dataclasses.replace(params.UINT8_CENTERED, name="toy_uint8",
                            lwe_n=24, n=256, nbit=8, message_modulus=16)
    gen = torch.Generator().manual_seed(23)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    msgs = torch.arange(5) % p.message_modulus
    ct = cipher.lwe_encrypt_message(gen, msgs, p.message_modulus,
                                    p.lwe_alpha, sk.lv0)
    return p, ck, ct


def _ext_call(ext9, transposed):
    p, ck, ct = ext9
    ck = dataclasses.replace(ck, transposed=transposed)
    assert engine._route(ck) == EXT_ROUTES[transposed]
    return lambda: lut.bootstrap_func(
        ck, ct, lambda x: (3 * x + 1) % p.message_modulus, p.message_modulus)


@pytest.mark.parametrize("transposed", [True, False], ids=["k4k5", "k6k8"])
def test_ext_blocks_is_recorded_once_a_bootstrap(transposed, ext9):
    fn = _ext_call(ext9, transposed)
    with tracing.enabled():
        fn()
        fn()
    spans = tracing.snapshot()["spans"]
    by_id = {s["id"]: s for s in spans}
    blocks = [s for s in spans if s["name"] == "rotation.ext_blocks"]
    rotations = [s for s in spans if s["name"] == "engine.rotation"]
    assert len(blocks) == len(rotations) == 2
    assert [by_id[s["parent"]]["name"] for s in blocks] == [
        "engine.rotation"] * 2
    assert len({s["call"] for s in blocks}) == 2
    boots = [s for s in spans if s["name"] == "engine.bootstrap"]
    assert {s["attrs"]["route"] for s in boots} == {EXT_ROUTES[transposed]}


@pytest.mark.parametrize("transposed", [True, False], ids=["k4k5", "k6k8"])
def test_block_rows_count_b_times_k_a_rotation(transposed, ext9):
    p, _, ct = ext9
    _, snap = _run_on(_ext_call(ext9, transposed))
    assert snap["counters"]["rotation.block_rows"] == (
        ct.shape[0] * p.poly_extend_factor)
    assert snap["counters"]["rotation.steps"] == p.lwe_n


@pytest.mark.parametrize("transposed", [True, False], ids=["k4k5", "k6k8"])
def test_ext_blocks_off_records_nothing_and_gives_the_same_words(
        transposed, ext9):
    fn = _ext_call(ext9, transposed)
    off = fn()
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    on, snap = _run_on(fn)
    assert snap["counters"]["rotation.block_rows"] > 0
    assert torch.equal(on, off)


def test_k1_rotations_record_no_ext_blocks(fast):
    p, gen, sk, ck = fast
    _, snap = _run_on(lambda: gates.NAND(ck, _bits(gen, p, sk),
                                         _bits(gen, p, sk)))
    assert "rotation.ext_blocks" not in {s["name"] for s in snap["spans"]}
    assert "rotation.block_rows" not in snap["counters"]


# ---------------------------------------------------------------------------
# Clock, switch, bounds, export.
# ---------------------------------------------------------------------------

def test_spans_lie_on_the_profilers_clock(fast):
    from torch.profiler import ProfilerActivity, profile
    p, gen, sk, ck = fast
    a, b = _bits(gen, p, sk), _bits(gen, p, sk)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.enabled():
            gates.NAND(ck, a, b)
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(
            origin + 1000 * e.time_range.start)
    spans = tracing.snapshot()["spans"]
    assert len(spans) == 7
    for s in spans:
        (start,) = events[s["name"]]
        assert abs(start - s["start_ns"]) < 1e6, s["name"]


def test_profiling_trace_switches_the_recorder(fast, tmp_path):
    p, gen, sk, ck = fast
    a, b = _bits(gen, p, sk), _bits(gen, p, sk)
    assert not tracing.active
    with profiling.trace(str(tmp_path)):
        assert tracing.active
        gates.NAND(ck, a, b)
    assert not tracing.active
    assert len(tracing.snapshot()["spans"]) == 7
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"entry.gate", "engine.rotation", "key_switch"} <= names


def test_enabled_restores_the_switch():
    tracing.enable()
    with tracing.enabled():
        assert tracing.active
    assert tracing.active
    tracing.disable()
    with tracing.enabled():
        pass
    assert not tracing.active


def test_the_record_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with tracing.enabled():
        for _ in range(5):
            with tracing.span("test.leaf"):
                pass
    snap = tracing.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2
    tracing.reset()
    assert tracing.snapshot()["dropped"] == 0


def test_threads_keep_their_own_parents():
    seen = {}

    def work(tag):
        with tracing.span("test.root", tag=tag) as root:
            with tracing.span("test.child", tag=tag) as child:
                seen[tag] = (root["id"], root["call"], child["parent"],
                             child["call"])

    with tracing.enabled():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len({v[1] for v in seen.values()}) == 4
    for root_id, call, parent, child_call in seen.values():
        assert parent == root_id and child_call == call


def test_first_runs_are_recorded_and_outlive_reset(fast):
    p, gen, sk, ck = fast
    gates.NAND(ck, _bits(gen, p, sk), _bits(gen, p, sk))
    tracing.reset()
    first = tracing.snapshot()["first_run_s"]
    for name in ("entry.gate", "engine.bootstrap", "engine.rotation",
                 "engine.sample_extract", "key_switch",
                 "key_switch.limb_form", "key_switch.contract"):
        assert first[name] >= 0.0, name


def test_the_always_kept_counts_are_the_recorders_own(monkeypatch):
    """ops.cuda_t.launch_counts and ops.blindrotate.rotation_counts are
    the recorder's objects, under the names the benchmark's readers read;
    reset() zeroes the rotations and keeps the launches."""
    assert cuda_t.launch_counts is tracing.launch_counts
    assert blindrotate.rotation_counts is tracing.rotation_counts
    assert "extprod_t_small" in tracing.launch_counts
    monkeypatch.setitem(tracing.launch_counts, "extprod_t", 5)
    monkeypatch.setitem(tracing.rotation_counts, "rotations", 3)
    monkeypatch.setitem(tracing.rotation_counts, "replayed", 2)
    snap = tracing.snapshot()
    assert snap["launches"]["extprod_t"] == 5
    assert snap["rotations"] == {"rotations": 3, "replayed": 2,
                                 "by_route": {}}
    tracing.reset()
    assert blindrotate.rotation_counts == {"rotations": 0, "replayed": 0}
    assert cuda_t.launch_counts["extprod_t"] == 5


@pytest.mark.parametrize("transposed", [True, False], ids=["k4k5", "k6k8"])
def test_rotations_are_counted_by_route(transposed, fast, ext9):
    """Always kept, the recorder off: each rotation adds one to its route's
    count (the extended key's, a gate's, a route asked for by name), the
    snapshot carries them under ``rotations["by_route"]`` and reset()
    zeroes them."""
    assert blindrotate.route_counts is tracing.route_counts
    p, gen, sk, ck = fast
    x = _bits(gen, p, sk)
    ext = _ext_call(ext9, transposed)
    ext()
    ext()
    engine.bootstrap(ck, x)
    engine._bootstrap(ck, x, None, True, False, route="blind_rotate")
    assert not tracing.active
    want = {EXT_ROUTES[transposed]: 2, "blind_rotate_t": 1,
            "blind_rotate": 1}
    assert blindrotate.route_counts == want
    assert sum(want.values()) == blindrotate.rotation_counts["rotations"]
    assert tracing.snapshot()["rotations"]["by_route"] == want
    tracing.reset()
    assert blindrotate.route_counts == {}
    assert tracing.snapshot()["rotations"] == {
        "rotations": 0, "replayed": 0, "by_route": {}}


def _ext_t_share():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "metrics",
        "rotation.ext_t_share.py")
    spec = importlib.util.spec_from_file_location("ext_t_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


def test_ext_t_share_reads_the_route_counts(monkeypatch):
    """benchmark/metrics/rotation.ext_t_share.py: 100 x the rotations on
    blind_rotate_extended_t over all the run's rotations; None where no
    rotation ran or the program keeps no count by route."""
    reader = _ext_t_share()
    monkeypatch.setitem(tracing.route_counts, "blind_rotate_extended_t", 6)
    assert reader.read({}) == 100.0
    monkeypatch.setitem(tracing.route_counts, "blind_rotate_extended_rm", 2)
    assert reader.read({}) == 75.0
    monkeypatch.delitem(tracing.route_counts, "blind_rotate_extended_t")
    assert reader.read({}) == 0.0
    tracing.reset()
    assert reader.read({}) is None
    monkeypatch.delattr(tracing, "route_counts")
    assert reader.read({}) is None
    monkeypatch.setitem(sys.modules, "go_tfhe_tpu_torch.utils.tracing", None)
    assert reader.read({}) is None


def test_the_recorder_imports_nothing_from_ops():
    """utils/tracing.py sits below the layers it records: no import of
    go_tfhe_tpu_torch.ops, at the top or inside a function."""
    for node in ast.walk(ast.parse(inspect.getsource(tracing))):
        if isinstance(node, ast.ImportFrom):
            names = ["." * node.level + (node.module or "") + "." + a.name
                     for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            assert "ops" not in name.split("."), name


@pytest.mark.parametrize("on", [False, True])
def test_launch_records_first_launch_and_host_time(on, monkeypatch):
    """ops.cuda_t.launch against a stand-in library and card (no CUDA
    here): the first launch of an entry on a card is timed once; the host
    time is counted only while on."""
    class Lib:
        def __init__(self):
            self.calls = []

        def tfhe_test_entry(self, *args):
            self.calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    lib = Lib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    monkeypatch.setitem(cuda_t.launch_counts, "extprod_t",
                        cuda_t.launch_counts["extprod_t"])
    monkeypatch.setattr(tracing, "first_launches", {})
    before = cuda_t.launch_counts["extprod_t"]
    with tracing.enabled() if on else contextlib.nullcontext():
        for index in (0, 0, 1):
            cuda_t.launch("extprod_t", "tfhe_test_entry",
                          torch.device("cuda", index), 7)
    snap = tracing.snapshot()
    assert lib.calls == [(7, 0)] * 3
    assert cuda_t.launch_counts["extprod_t"] == before + 3
    assert sorted(snap["first_launch_s"]) == ["tfhe_test_entry@cuda:0",
                                              "tfhe_test_entry@cuda:1"]
    assert ("launch.host_ns" in snap["counters"]) == on
    if on:
        assert snap["counters"]["launch.host_ns"] > 0


def test_dump_writes_json_lines(fast, tmp_path):
    p, gen, sk, ck = fast
    with tracing.enabled():
        gates.NAND(ck, _bits(gen, p, sk), _bits(gen, p, sk))
    path = tmp_path / "trace.jsonl"
    snap = tracing.dump(str(path))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[0]["kind"] == "summary"
    assert lines[0]["counters"] == snap["counters"]
    assert [r["name"] for r in lines[1:]] == [s["name"]
                                              for s in snap["spans"]]
    assert {r["kind"] for r in lines[1:]} == {"span"}


def test_engine_spans_carry_the_route(fast):
    p, gen, sk, ck = fast
    x = _bits(gen, p, sk)
    with tracing.enabled():
        engine.bootstrap(ck, x)
        engine.bootstrap(ck, x, plain=True)
        engine._bootstrap(ck, x, None, True, False, route="blind_rotate")
    boots = [s for s in tracing.snapshot()["spans"]
             if s["name"] == "engine.bootstrap"]
    assert [s["attrs"]["route"] for s in boots] == [
        "blind_rotate_t", "blind_rotate_t", "blind_rotate"]
    assert all(s["parent"] is None for s in boots)
    assert len({s["call"] for s in boots}) == 3


def test_small_batch_share_reads_the_k2_counters(monkeypatch):
    """benchmark/metrics/extprod.small_batch_share.py: the share of the
    run's K2 launches that took the small form, in percent; None where no
    K2 launched or the program has no such counter (one without the small
    form)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "metrics",
        "extprod.small_batch_share.py")
    spec = importlib.util.spec_from_file_location("small_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    monkeypatch.setitem(cuda_t.launch_counts, "extprod_t", 700)
    monkeypatch.setitem(cuda_t.launch_counts, "extprod_t_small", 700)
    assert reader.read({}) == 100.0
    monkeypatch.setitem(cuda_t.launch_counts, "extprod_t_small", 175)
    assert reader.read({}) == 25.0
    monkeypatch.setitem(cuda_t.launch_counts, "extprod_t_small", 0)
    assert reader.read({}) == 0.0
    monkeypatch.setitem(cuda_t.launch_counts, "extprod_t", 0)
    assert reader.read({}) is None
    monkeypatch.setitem(cuda_t.launch_counts, "extprod_t", 700)
    monkeypatch.delitem(cuda_t.launch_counts, "extprod_t_small")
    assert reader.read({}) is None


def test_program_trace_counts_small_form_launches_once():
    """tools/torch_program_trace.py's launch count (the base of
    ``launch.host_us_per_kernel``): a K2 launch of the small form counts
    once, under ``extprod_t``, not again under ``extprod_t_small``."""
    from go_tfhe_tpu_torch.utils.benchmarking import load_script
    tool = load_script("tools/torch_program_trace.py")
    counts = dict.fromkeys(cuda_t.launch_counts, 0)
    counts.update(rotate_decompose_t=700, extprod_t=700,
                  extprod_t_small=700)
    assert tool._kernel_launches(counts) == 1400


def test_program_trace_counts_a_fused_step_once():
    """A launch of the fused step (K1 inside K2's small form) counts once,
    under ``extprod_t``: not again under ``extprod_t_small`` or
    ``step_t_small``, and K1 is not launched apart."""
    from go_tfhe_tpu_torch.utils.benchmarking import load_script
    tool = load_script("tools/torch_program_trace.py")
    counts = dict.fromkeys(cuda_t.launch_counts, 0)
    counts.update(extprod_t=700, extprod_t_small=700, step_t_small=700)
    assert tool._kernel_launches(counts) == 700


def test_program_trace_reads_the_extended_set_up(ext9, monkeypatch):
    """tools/torch_program_trace.py's pass (a) on a toy k 9 cell: the
    ``rotation.ext_blocks`` span's host ms a call and ``rotation.block_rows``
    a rotation (B * k).  The CPU runs the kernels' plain versions, so the
    span has no device ms and no entry launches."""
    import time

    from go_tfhe_tpu_torch.utils.benchmarking import load_script
    tool = load_script("tools/torch_program_trace.py")
    harness = tool.harness
    p = ext9[0]
    monkeypatch.setitem(params.PROFILES, p.name, p)
    config = {"profile": p.name,
              "reference": "benchmark/reference/tfhe_ext.py",
              "params": {f: getattr(p, f) for f in harness.PROFILE_FIELDS}}
    mix = {"op": "lut", "table": [(3 * x + 1) % 16 for x in range(16)],
           "batch": 4, "loop": "closed", "chain": False,
           "distinct_batches": 1}
    cell = harness.Cell("toy", 1, config,
                        harness.load_reference(config["reference"]), mix,
                        [], [])
    r = harness.Run(cell, 2 ** 33 + 7, 0.0, "cpu", time.time())
    r.setup()
    line = tool.pass_a(r, tracing, 2)
    assert line["calls"] == 2
    assert line["rotation.block_rows"] == 4 * p.poly_extend_factor
    assert line["rotation.ext_blocks"]["host_ms"] > 0
    assert line["rotation.ext_blocks"]["device_ms"] is None
    assert line["launches_per_call_by_entry"] == {}
