"""Cells, configurations, mixes and metrics load as data, by name; the
traffic is the seed's and only the seed's."""

import json
import os
import re

import pytest
import torch

from benchmark import harness, traffic
from benchmark.reference import tfhe as ref
from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics + BENCH["configs"]
             + BENCH["workloads"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.mix["batch"] >= 1 and c.config["params"]["lwe_n"] > 0
    # judged by the reference that its configuration names
    assert os.path.samefile(c.ref.__file__,
                            os.path.join(ROOT, c.config["reference"]))


def test_a_configuration_without_a_reference_is_refused(tmp_path):
    entry = BENCH["configs"][0]
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    del cfg["reference"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    path = tmp_path / entry["file"]
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(cfg))
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["config"] == entry["name"])
    with pytest.raises(ValueError, match="names no reference"):
        harness.load_cell(cell, root=str(tmp_path))
    with pytest.raises(ValueError, match="outside the checkout"):
        harness.load_reference("../reference/tfhe.py")


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_each_configuration_is_the_programs_profile(config):
    from go_tfhe_tpu_torch import params
    with open(os.path.join(ROOT, config["file"])) as f:
        cfg = json.load(f)
    assert cfg["source"] == config["source"]
    harness.check_profile(params.get_params(cfg["profile"]), cfg["params"])
    harness.load_reference(cfg["reference"]).Params.from_config(
        cfg["params"])


def test_a_changed_number_is_refused():
    from go_tfhe_tpu_torch import params
    with open(os.path.join(ROOT, "benchmark/configs/gate-128bit.json")) as f:
        cfg = json.load(f)
    cfg["params"]["iks_t"] = 8
    with pytest.raises(ValueError, match="iks_t"):
        harness.check_profile(params.get_params("128bit"), cfg["params"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    from go_tfhe_tpu_torch.utils import tracing
    tracing.reset()                 # an earlier test's run leaves its peaks
    reader = harness.load_reader(metric["name"])
    assert reader.read({"params": {}, "batch": 1, "calls": 0}) is None


def test_the_chains_median_is_read_from_every_call_of_the_window():
    """``latency_p50_ms.chain`` is the nearest-rank median of the window's
    call latencies, in ms: the number that the end-to-end metric
    ``latency_p50_ms`` was, now read per layer."""
    from conftest import toy_run
    reader = harness.load_reader("latency_p50_ms.chain")
    assert reader.read({"latency_s": [0.004, 0.001, 0.003, 0.002]}) == 2.0
    r = toy_run("chain", trace=True)
    assert r["correct"] and r["metrics"]["latency_p50_ms.chain"]["value"] > 0


def test_each_mix_loads_and_unknown_keys_are_refused(tmp_path):
    for w in BENCH["workloads"]:
        traffic.load(os.path.join(ROOT, "benchmark/traffic",
                                  w["traffic"] + ".json"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"op": "gate", "gate": "NAND", "batch": 1,
                               "loop": "closed", "rate": 5}))
    with pytest.raises(ValueError, match="rate"):
        traffic.load(str(bad))


def _inputs(mix, seed):
    prm = ref.Params(lwe_n=16, lwe_alpha=2 ** -20, n=128, nbit=7,
                     lv1_alpha=2 ** -28, bgbit=8, l=2, basebit=4, iks_t=6,
                     message_modulus=2 if mix["op"] == "gate" else 8)
    gen = torch.Generator().manual_seed(seed)
    keys = ref.make_keys(gen, prm)
    tr = traffic.Traffic(mix, ref, prm, "cpu")
    return keys, tr.make_inputs(gen, keys)


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, list):
        return [t for x in tree for t in _flat(x)]
    return [tree]


@pytest.mark.parametrize("kind", ["nand", "chain", "lut"])
def test_traffic_is_deterministic_in_the_seed(kind):
    from conftest import MIXES
    mix = MIXES[kind]
    k1, a = _inputs(mix, 2 ** 33 + 1)
    k2, b = _inputs(mix, 2 ** 33 + 1)
    _, c = _inputs(mix, 2 ** 33 + 2)
    for x, y, z in zip(_flat(a), _flat(b), _flat(c)):
        assert torch.equal(x, y) and x.shape == z.shape
    assert torch.equal(k1["bsk"], k2["bsk"])
    assert any(not torch.equal(x, z) for x, z in zip(_flat(a), _flat(c)))


def test_gate_batches_carry_the_truth_table():
    from conftest import NAND_MIX
    _, inputs = _inputs(dict(NAND_MIX, batch=4096), 9)
    for batch in inputs["batches"]:
        pair = batch["plain_a"].long() * 2 + batch["plain_b"].long()
        assert torch.equal(torch.bincount(pair, minlength=4),
                           torch.full((4,), 1024))
