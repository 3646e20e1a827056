"""The whole run with the timed path broken underneath: the harness,
its look for a card skipped, must report ``correct`` false for each fault
a cell can have.  (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

from conftest import return_state_unchanged, toy_run


def test_sound_runs_are_correct():
    for kind in ("nand", "chain", "lut", "ext"):
        r = toy_run(kind)
        assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
        assert list(r)[-1] == "checks"
        assert r["checks"]["mismatched_ciphertexts"] == {"value": 0,
                                                         "limit": 0}


@pytest.mark.parametrize("kind", ["nand", "chain", "lut", "ext"])
def test_a_step_that_returns_its_state_unchanged(kind, monkeypatch):
    return_state_unchanged(monkeypatch)
    r = toy_run(kind)
    assert not r["correct"] and r["failed"] == r["attempted"]


@pytest.mark.parametrize("kind", ["nand", "lut", "ext"])
def test_half_of_the_batch_left_out(kind, monkeypatch):
    from go_tfhe_tpu_torch import engine
    whole = engine.bootstrap

    def half(ck, ct, testvec=None, plain=False):
        h = ct.shape[0] // 2
        out = whole(ck, ct[:h], testvec, plain)
        return torch.cat([out, out])            # the rest copied, not run

    monkeypatch.setattr(engine, "bootstrap", half)
    r = toy_run(kind)
    assert not r["correct"] and 0 < r["failed"] < r["attempted"]


@pytest.mark.parametrize("kind", ["nand", "chain", "lut", "ext"])
def test_an_answer_altered_where_it_is_produced(kind, monkeypatch):
    from go_tfhe_tpu_torch import engine
    whole = engine.bootstrap

    def altered(ck, ct, testvec=None, plain=False):
        out = whole(ck, ct, testvec, plain)
        out[0, 0] += 1
        return out

    monkeypatch.setattr(engine, "bootstrap", altered)
    r = toy_run(kind)
    assert not r["correct"] and r["failed"] >= 1


def test_a_traced_run_judges_alike(monkeypatch):
    from go_tfhe_tpu_torch import engine
    r = toy_run("nand", trace=True)
    assert r["correct"] and "breakdown" in r
    whole = engine.bootstrap

    def altered(ck, ct, testvec=None, plain=False):
        out = whole(ck, ct, testvec, plain)
        out[-1, -1] ^= 1 << 20
        return out

    monkeypatch.setattr(engine, "bootstrap", altered)
    assert not toy_run("nand", trace=True)["correct"]
