"""The per-layer metrics read from the program's own records
(``metrics/key_switch.transient_gib.py``, ``metrics/setup.first_launch_s.py``):
a traced toy run prints what the program recorded, and a program without
the records (a parent commit's) leaves them out and keeps the others."""

import sys

import pytest

from benchmark import harness
from conftest import toy_run

NEW = ("key_switch.transient_gib", "setup.first_launch_s")


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
    """The program as it stood before it kept these records: its module
    cannot be imported, the run completes, the new metrics are left out
    and every other one is read as before."""
    whole = toy_run("nand", trace=True)["metrics"]
    monkeypatch.setitem(sys.modules, "go_tfhe_tpu_torch.utils.tracing", None)
    bare = toy_run("nand", trace=True)
    assert bare["correct"]
    assert not set(NEW) & set(bare["metrics"])
    assert set(bare["metrics"]) == set(whole) - set(NEW)
    for name in NEW:
        assert harness.load_reader(name).read({}) is None
