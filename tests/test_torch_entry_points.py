"""The port's measuring entry points on the host: ``bench_torch.py``,
``bench_micro_torch.py``, ``bench_scaling_torch.py`` and
``tools/torch_*.py``, the counterparts of the JAX repo's ``bench.py``,
``bench_micro.py``, ``bench_scaling.py`` and tools.

* Each script's ``main`` at a toy profile with ``--device cpu`` (a mesh of
  two host shards for the scaling script) returns 0; every JSON record it
  prints names the device.
* Each prints at least the keys of the dict literals that its JAX script
  prints, and a metric of every name the JAX script emits; both are read
  from the JAX script with ``ast`` (it is not imported).
* On JAX keys and ciphertexts carried across (``keys.cloud_key_from_numpy``,
  ``secret_key_from_numpy``), each measuring core's outputs and noise block
  equal, exactly, the JAX script's formula applied to the JAX engine's
  outputs.  JAX runs in this process on the CPU.
* bench_torch.py's guard: ``--selftest-guard`` (a masked copy of the key)
  and a wrong truth table each give exit 1 with ``"value": null``, as
  torch_bench_profiles.py does; the routing flags are restored.
* Without ``--device cpu`` every script asks for the card, and on a torch
  without one it raises.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import engine, keys, params  # noqa: E402
from go_tfhe_tpu_torch.utils.benchmarking import load_script  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import (from_numpy_u32,  # noqa: E402
                                           to_numpy_u32)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# port script -> (its JAX script, the argv of a host run at a toy profile)
SCRIPTS = {
    "bench_torch.py": ("bench.py", ["--profile", "test_fast"]),
    "bench_micro_torch.py": ("bench_micro.py", []),
    "bench_scaling_torch.py": ("bench_scaling.py", []),
    "tools/torch_bench_profiles.py": (
        "tools/bench_profiles.py", ["--profiles", "test_fast", "--batch",
                                    "32"]),
    "tools/torch_bench_ext.py": (
        "tools/bench_ext.py", ["--profiles", "test_ext2",
                               "--portable-batch", "8"]),
    "tools/torch_noise_margin.py": (
        "tools/noise_margin.py", ["--profiles", "test_fast", "--batch",
                                  "64"]),
    "tools/torch_noise_margin_pbs.py": (
        "tools/noise_margin_pbs.py", ["--profiles", "test_pbs", "--batch",
                                      "64"]),
    "tools/torch_noise_many.py": (
        "tools/noise_many.py", ["--profile", "test_fast", "--batch", "64"]),
}
HOST = {"bench_scaling_torch.py": ["--devices", "cpu,cpu"]}
GUARD_ARGV = ["--profile", "test_fast", "--device", "cpu"]


def _main(path, argv):
    """(exit code, JSON records printed) of the script's main(argv)."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = load_script(path).main(argv)
    return rc, [json.loads(line) for line in log.getvalue().splitlines()
                if line.startswith("{")]


@pytest.fixture(scope="module")
def host_run():
    """Each script's host run, made once."""
    cache = {}

    def get(path):
        if path not in cache:
            argv = SCRIPTS[path][1] + HOST.get(path, ["--device", "cpu"])
            cache[path] = _main(path, argv)
        return cache[path]
    return get


# ---------------------------------------------------------------------------
# What the JAX scripts print, read with ast.
# ---------------------------------------------------------------------------

def _is_json_dumps(func):
    return (isinstance(func, ast.Attribute) and func.attr == "dumps"
            and isinstance(func.value, ast.Name) and func.value.id == "json")


def _printed_dicts(path):
    """The dict literals the JAX script prints: json.dumps's argument, or
    what a function returns whose call json.dumps takes."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    funcs = {f.name: f for f in ast.walk(tree)
             if isinstance(f, ast.FunctionDef)}
    dicts = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_json_dumps(node.func)
                and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Dict):
            dicts.append(arg)
        elif (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name)
              and arg.func.id in funcs):
            dicts += [r.value for r in ast.walk(funcs[arg.func.id])
                      if isinstance(r, ast.Return)
                      and isinstance(r.value, ast.Dict)]
    return dicts


def _pattern(node):
    """A regex of a metric name: a constant, or an f-string whose
    formatted parts match anything."""
    if isinstance(node, ast.Constant):
        return re.escape(node.value)
    assert isinstance(node, ast.JoinedStr), ast.dump(node)
    return "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                   else ".+" for v in node.values)


def _jax_keys(path):
    return [{k.value for k in d.keys if isinstance(k, ast.Constant)}
            for d in _printed_dicts(path)]


def _jax_metric_patterns(path):
    """The metric names the JAX script prints: the "metric" values of its
    printed dicts and the names it passes to emit()."""
    found = [_pattern(v) for d in _printed_dicts(path)
             for k, v in zip(d.keys, d.values)
             if isinstance(k, ast.Constant) and k.value == "metric"]
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    found += [_pattern(node.args[0]) for node in ast.walk(tree)
              if isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name) and node.func.id == "emit"]
    return found


def test_the_jax_scripts_print_what_is_compared():
    """The ast reading finds each JAX script's printed keys and metrics."""
    bench = _jax_keys("bench.py")
    assert len(bench) == 2
    assert any({"metric", "value", "unit", "vs_baseline", "utilization",
                "noise"} <= keys_ for keys_ in bench)
    assert any({"error", "profile", "noise"} <= keys_ for keys_ in bench)
    assert {"profile", "batch", "margin_sigmas", "est_error_per_gate",
            "wrong_answers"} <= _jax_keys("tools/noise_margin.py")[0]
    assert len(_jax_metric_patterns("bench_micro.py")) >= 20


# ---------------------------------------------------------------------------
# The host runs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(SCRIPTS))
def test_entry_point_runs_on_the_host(host_run, path):
    rc, records = host_run(path)
    assert rc == 0, records
    assert records
    for rec in records:
        assert rec["device"] == {"platform": "cpu", "name": "cpu",
                                 "power_limit": None}, rec


@pytest.mark.parametrize("path", sorted(SCRIPTS))
def test_entry_point_prints_the_jax_keys(host_run, path):
    """Every dict the JAX script prints has a record of the port with at
    least its keys (bench.py's error record: the guard's run)."""
    records = host_run(path)[1]
    if path == "bench_torch.py":
        records = records + _main(path, GUARD_ARGV + ["--selftest-guard"])[1]
    for want in _jax_keys(SCRIPTS[path][0]):
        assert any(want <= set(rec) for rec in records), (
            f"no record with the keys {sorted(want)}")


@pytest.mark.parametrize("path", sorted(SCRIPTS))
def test_entry_point_prints_the_jax_metrics(host_run, path):
    metrics = [rec["metric"] for rec in host_run(path)[1] if "metric" in rec]
    for pattern in _jax_metric_patterns(SCRIPTS[path][0]):
        assert any(re.fullmatch(pattern, m) for m in metrics), (
            f"no metric named like {pattern!r} in {metrics}")


@pytest.mark.parametrize("path", sorted(SCRIPTS))
def test_entry_point_defaults_to_the_card(path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError):
            load_script(path).main(SCRIPTS[path][1])


# ---------------------------------------------------------------------------
# bench_torch.py's guard and flags.
# ---------------------------------------------------------------------------

def test_selftest_guard_exits_1():
    rc, records = _main("bench_torch.py", GUARD_ARGV + ["--selftest-guard"])
    assert rc == 1
    assert len(records) == 1
    assert records[0]["value"] is None
    assert "error" in records[0]


@pytest.mark.parametrize("path", ["bench_torch.py",
                                  "tools/torch_bench_profiles.py"])
def test_wrong_truth_table_exits_1(path, monkeypatch):
    """AND in place of NAND: every answer is wrong, so the guard reports
    no value and the run exits 1."""
    monkeypatch.setattr(engine, "prepare_nand", engine.prepare_and)
    argv = (GUARD_ARGV if path == "bench_torch.py" else
            ["--profiles", "test_fast", "--batch", "32", "--device", "cpu"])
    rc, records = _main(path, argv)
    assert rc == 1
    assert records[0]["value"] is None
    assert "truth-table mismatches" in records[0]["error"]


def test_selftest_masks_a_copy():
    bench = load_script("bench_torch.py")
    p = params.TEST_FAST
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    bands, bsk = ck.bands.clone(), ck.bsk.clone()
    masked = bench.masked_copy(ck)
    assert torch.equal(ck.bands, bands) and torch.equal(ck.bsk, bsk)
    assert not (masked.bands & 0xFFFF).any()
    assert not (masked.bsk & 0xFFFF).any()
    assert torch.equal(masked.bands >> 16, bands >> 16)


@pytest.mark.parametrize("flag,profile,route", [
    ("--block", "test_block", "blind_rotate_block"),
    ("--pipe", "test_fast", "blind_rotate_pipe")])
def test_routing_flags_are_restored(flag, profile, route):
    before = engine.PREFER_BLOCK_ROTATION, engine.PREFER_PIPE
    rc, records = _main("bench_torch.py", [flag, "--profile", profile,
                                           "--batch", "16", "--device",
                                           "cpu"])
    assert rc == 0
    assert records[0]["route"] == route
    assert (engine.PREFER_BLOCK_ROTATION, engine.PREFER_PIPE) == before


# ---------------------------------------------------------------------------
# The measuring cores against the JAX scripts' formulas on the JAX
# engine's outputs.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import engine as jengine
    from go_tfhe_tpu import lut as jlut
    return types.SimpleNamespace(jax=jax, cipher=jcipher, engine=jengine,
                                 lut=jlut)


def _port_keys(sk, ck):
    return (keys.cloud_key_from_numpy(
                ck.params.name, np.asarray(ck.testvec), np.asarray(ck.ksk),
                np.asarray(ck.bsk), ck.block_binary, device="cpu"),
            keys.secret_key_from_numpy(np.asarray(sk.lv0),
                                       np.asarray(sk.lv1), device="cpu"))


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _jax_noise(jx, out, lv0, ideal, margin, margin_log2, per,
               with_max=True):
    """The JAX scripts' noise block (bench.py:120-133,
    tools/noise_margin.py:159-177, noise_margin_pbs.py:238-251,
    noise_many.py:318-331) on the JAX engine's outputs."""
    ph = np.asarray(jx.cipher.lwe_phase(out, lv0)).astype(np.int64)
    dev = ((ph - ideal + 2 ** 31) % 2 ** 32) - 2 ** 31
    std = float(dev.std())
    sigmas = margin / std if std else float("inf")
    block = {"phase_std_log2": round(math.log2(std), 2) if std else None}
    if with_max:
        block["phase_max_log2"] = round(math.log2(abs(dev).max() + 1), 2)
    block["margin_log2"] = margin_log2
    block["margin_sigmas"] = round(sigmas, 1)
    block[f"est_error_per_{per}"] = float(
        f"{math.erfc(sigmas / math.sqrt(2.0)):.2e}")
    return block


@pytest.fixture(scope="module")
def nand(jx, fast_keys):
    """JAX NAND of 32 bit pairs at test_fast: keys, inputs, outputs."""
    p, sk, ck = fast_keys
    ka, kb = jx.jax.random.split(jx.jax.random.PRNGKey(61))
    bits_a = np.resize([False, True], 32)
    bits_b = np.resize([False, False, True, True], 32)
    ct_a = jx.cipher.lwe_encrypt_bool(ka, bits_a, p.lwe_alpha, sk.lv0)
    ct_b = jx.cipher.lwe_encrypt_bool(kb, bits_b, p.lwe_alpha, sk.lv0)
    out = jx.engine.bootstrap(ck, jx.engine.prepare_nand(ct_a, ct_b))
    want = ~(bits_a & bits_b)
    dec = np.asarray(jx.cipher.lwe_decrypt_bool(out, sk.lv0))
    ideal = (np.where(want, 1 / 8, -1 / 8) * 2 ** 32).astype(np.int64)
    return types.SimpleNamespace(
        p=p, sk=sk, ct_a=ct_a, ct_b=ct_b, bits_a=bits_a, bits_b=bits_b,
        out=out, wrong=int((dec != want).sum()),
        noise=_jax_noise(jx, out, sk.lv0, ideal, 2 ** 29, 29, "gate"),
        port=_port_keys(sk, ck))


def test_bench_measure_matches_jax(nand):
    tck, tsk = nand.port
    rec, out = load_script("bench_torch.py").measure(
        tck, tsk, _t(nand.ct_a), _t(nand.ct_b), nand.bits_a, nand.bits_b)
    np.testing.assert_array_equal(to_numpy_u32(out), np.asarray(nand.out))
    assert rec["wrong_answers"] == nand.wrong
    assert rec["noise"] == nand.noise


def test_noise_margin_measure_matches_jax(nand):
    tck, tsk = nand.port
    rec, _, _ = load_script("tools/torch_noise_margin.py").measure(
        tck, tsk, _t(nand.ct_a), _t(nand.ct_b), nand.bits_a, nand.bits_b)
    assert rec == {"profile": nand.p.name, "batch": 32, **nand.noise,
                   "wrong_answers": nand.wrong}


def test_noise_margin_pbs_measure_matches_jax(jx, pbs_keys):
    p, sk, ck = pbs_keys
    m = p.message_modulus
    msgs = np.arange(32) % m
    ct = jx.cipher.lwe_encrypt_message(jx.jax.random.PRNGKey(62), msgs, m,
                                       p.lwe_alpha, sk.lv0)
    table = jx.lut.Generator(p, m).gen_lut(lambda x: x)
    out = jx.lut.bootstrap_lut(ck, ct, table)
    dec = np.asarray(jx.cipher.lwe_decrypt_message(out, m, sk.lv0))
    margin = 2 ** 32 // (4 * m)
    want = {"profile": p.name, "message_modulus": m, "batch": 32,
            **_jax_noise(jx, out, sk.lv0,
                         (msgs.astype(np.int64) << 32) // (2 * m), margin,
                         round(math.log2(margin), 1), "pbs"),
            "wrong_answers": int((dec != msgs).sum())}
    tck, tsk = _port_keys(sk, ck)
    rec, tout = load_script("tools/torch_noise_margin_pbs.py").measure(
        tck, tsk, _t(ct), msgs, _t(table))
    np.testing.assert_array_equal(to_numpy_u32(tout), np.asarray(out))
    assert rec == want


@pytest.mark.parametrize("theta", [0, 1, 2])
def test_noise_many_measure_matches_jax(jx, fast_keys, theta):
    p, sk, ck = fast_keys
    m = 8
    msgs = np.arange(32) % (m // 2)
    ct = jx.cipher.lwe_encrypt_message(jx.jax.random.PRNGKey(63), msgs, m,
                                       p.lwe_alpha, sk.lv0)
    mlut = jx.lut.Generator(p, m).gen_multi_lut([lambda x: x], theta=theta)
    out = jx.engine.bootstrap_many(ck, ct, mlut, k=1, theta=theta)[0]
    dec = np.asarray(jx.cipher.lwe_decrypt_message(out, m, sk.lv0))
    margin = 1 << (32 - int(math.log2(m)) - 2)
    want = {"profile": p.name, "message_modulus": m, "theta": theta,
            "batch": 32,
            **_jax_noise(jx, out, sk.lv0,
                         msgs.astype(np.int64) << (32 - int(math.log2(m))
                                                   - 1),
                         margin, int(math.log2(margin)), "pbs",
                         with_max=False),
            "wrong_answers": int((dec != msgs).sum())}
    tck, tsk = _port_keys(sk, ck)
    with pytest.warns(UserWarning) if theta >= 2 else contextlib.nullcontext():
        rec, tout = load_script("tools/torch_noise_many.py").measure(
            tck, tsk, _t(ct), msgs, m, _t(mlut), theta)
    np.testing.assert_array_equal(to_numpy_u32(tout), np.asarray(out))
    assert rec == want
