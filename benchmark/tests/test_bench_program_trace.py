"""The per-layer metrics read from the program's own records (source
``program_counter`` or ``program_span`` in BENCHMARK.json, such as
``metrics/key_switch.transient_gib.py``): a traced toy run prints what the
program recorded, and a program without the records (a parent commit's)
leaves them out and keeps the others."""

import json
import os
import re
import sys

import pytest

from benchmark import harness
from conftest import ROOT, toy_run

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    RECORDED = [m["name"] for m in json.load(_f)["per_layer"]
                if m["source"] in ("program_counter", "program_span")]


def _record_modules() -> set:
    """The program's modules that the readers of RECORDED take the records
    from."""
    found = set()
    for name in RECORDED:
        with open(os.path.join(ROOT, "benchmark", "metrics",
                               name + ".py")) as f:
            found |= set(re.findall(r'"(go_tfhe_tpu_torch(?:\.\w+)+)"',
                                    f.read()))
    return found


def _transient_gib(profile: str, batch: int) -> float:
    """The key switch's bytes at its product, from the profile's shapes."""
    from go_tfhe_tpu_torch import params
    p = params.get_params(profile)
    rows, w = p.n * p.iks_t * p.base, p.lwe_n + 1
    total = (4 * rows * w + rows * 4 * w * 4 + batch * p.n * p.iks_t * 4
             + batch * p.n * p.iks_t * p.base * 4 + batch * 4 * w * 4)
    return total / float(1 << 30)


@pytest.mark.parametrize("kind,profile,batch", [("nand", "test_fast", 8),
                                                ("chain", "test_fast", 1),
                                                ("lut", "test_pbs", 8)])
def test_a_traced_run_prints_the_key_switch_bytes(kind, profile, batch):
    from go_tfhe_tpu_torch.utils import tracing
    tracing.reset()
    r = toy_run(kind, trace=True)
    assert r["correct"]
    metrics = r["metrics"]
    assert metrics["key_switch.transient_gib"] == {
        "value": _transient_gib(profile, batch), "unit": "GiB"}
    # the CPU runs the kernels' plain versions: no launch to read
    assert "setup.first_launch_s" not in metrics
    assert not tracing.active                   # the harness never turns it on


def test_first_launches_are_summed(monkeypatch):
    from go_tfhe_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "first_launches",
                        {("tfhe_rotdec_t", 0): 0.25, ("tfhe_extprod_t", 0): 1.5})
    assert harness.load_reader("setup.first_launch_s").read({}) == 1.75


def test_without_the_records_the_old_metrics_stay(monkeypatch):
    """The program as it stood before it kept these records: the modules
    that hold them cannot be imported, the run completes, every metric of
    the program's records is left out and every other one is read as
    before."""
    assert {"key_switch.transient_gib", "setup.first_launch_s",
            "rotation.ext_t_share", "key_switch.kernel_share"} <= set(
        RECORDED)
    modules = _record_modules()
    assert "go_tfhe_tpu_torch.utils.tracing" in modules
    whole = toy_run("nand", trace=True)["metrics"]
    for name in modules:
        monkeypatch.setitem(sys.modules, name, None)
    bare = toy_run("nand", trace=True)
    assert bare["correct"]
    assert not set(RECORDED) & set(bare["metrics"])
    assert set(bare["metrics"]) == set(whole) - set(RECORDED)
    for name in RECORDED:
        assert harness.load_reader(name).read({}) is None
