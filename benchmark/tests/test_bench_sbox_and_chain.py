"""The configuration ``pbs-uint8-centered`` and its cell
``pbs-uint8-centered.sbox-b256`` (the AES S-box over 8-bit messages, k 9),
and the chained 5-bit cell ``pbs-uint5.lut-chain-b1``: they load by name,
the configuration is the program's profile and names the extended
reference, the S-box is FIPS-197's, and toy runs of both mixes through the
harness are ``correct`` until a fault of the timed path turns them false."""

import dataclasses
import json
import os

import pytest
import torch

from benchmark import control, harness, traffic
from conftest import ROOT, TFHE, TFHE_EXT, return_state_unchanged, toy_cell

SBOX_CELL = "pbs-uint8-centered.sbox-b256"
CHAIN_CELL = "pbs-uint5.lut-chain-b1"


def _mix(name: str) -> dict:
    return traffic.load(os.path.join(ROOT, "benchmark", "traffic",
                                     name + ".json"))


# ---------------------------------------------------------------------------
# The data.
# ---------------------------------------------------------------------------

def test_both_cells_load_by_name():
    sbox = harness.load_cell(SBOX_CELL)
    assert sbox.config["profile"] == "uint8_centered"
    assert sbox.config["reference"] == TFHE_EXT
    assert (sbox.mix["batch"], sbox.mix["chain"]) == (256, False)
    assert {m["name"] for m in sbox.end_to_end} == {
        "bootstraps_per_s", "peak_mem_gib", "setup_s"}
    assert {"blind_rotation.k8_roofline", "blind_rotation.k6_roofline",
            "blind_rotation_roofline", "key_switch.share",
            "key_switch.transient_gib"} <= {m["name"] for m in sbox.per_layer}
    chain = harness.load_cell(CHAIN_CELL)
    assert chain.config["profile"] == "uint5"
    assert chain.config["reference"] == TFHE
    assert (chain.mix["batch"], chain.mix["chain"]) == (1, True)
    assert {m["name"] for m in chain.end_to_end} == {
        "latency_p95_ms", "peak_mem_gib", "setup_s"}
    assert {"extprod.small_batch_share", "latency_p50_ms.chain"} <= {
        m["name"] for m in chain.per_layer}


def test_the_configuration_is_uint8_centered_judged_by_the_ext_reference():
    from go_tfhe_tpu_torch import params
    cell = harness.load_cell(SBOX_CELL)
    harness.check_profile(params.get_params("uint8_centered"),
                          cell.config["params"])
    assert os.path.samefile(cell.ref.__file__,
                            os.path.join(ROOT, "benchmark", "reference",
                                         "tfhe_ext.py"))
    prm = cell.ref.Params.from_config(cell.config["params"])
    assert (prm.poly_extend_factor, prm.n, prm.lwe_n) == (9, 2048, 1160)
    # the floor gadget's profile is refused: the configuration is centered
    with pytest.raises(ValueError, match="centered_decomposition"):
        harness.check_profile(params.get_params("uint8"),
                              cell.config["params"])


def test_the_traffic_takes_the_256_entry_table():
    cell = harness.load_cell(SBOX_CELL)
    prm = cell.ref.Params.from_config(cell.config["params"])
    tr = traffic.Traffic(cell.mix, cell.ref, prm, "cpu")
    assert tr.table == cell.mix["table"] and len(tr.table) == 256
    assert sorted(tr.table) == list(range(256))          # a permutation
    with pytest.raises(ValueError, match="table of 256"):
        traffic.Traffic(cell.mix, cell.ref,
                        dataclasses.replace(prm, message_modulus=128), "cpu")


def _gf_mul(a: int, b: int) -> int:
    """a * b in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = (a << 1) ^ (0x11B if a & 0x80 else 0)
        b >>= 1
    return out


def _sbox(x: int) -> int:
    """FIPS-197 section 5.1.1: the multiplicative inverse (0 to 0), then
    the affine map b ^ rotl(b, 1..4) ^ 0x63."""
    inv = next((y for y in range(1, 256) if _gf_mul(x, y) == 1), 0)
    rotl = [((inv << s) | (inv >> (8 - s))) & 0xFF for s in range(1, 5)]
    return inv ^ rotl[0] ^ rotl[1] ^ rotl[2] ^ rotl[3] ^ 0x63


def test_the_table_is_the_aes_sbox():
    table = _mix("sbox-b256")["table"]
    assert table == [_sbox(x) for x in range(256)]
    # FIPS-197 Figure 7's corners and its worked example {53} -> {ed}
    assert (table[0x00], table[0x53], table[0xFF]) == (0x63, 0xED, 0x16)


def test_the_chain_table_is_cell_2s_permutation():
    chain, batch = _mix("lut-chain-b1"), _mix("lut-b2048")
    assert chain["table"] == batch["table"]
    assert sorted(chain["table"]) == list(range(32))


# ---------------------------------------------------------------------------
# Toy runs through the harness, sound and broken.
# ---------------------------------------------------------------------------

@pytest.fixture
def toys(monkeypatch, toy_uint, toy_uint8):
    """Two registered toy profiles and each mix's toy form: the S-box mix
    at uint8's k 9, gadget and key switch (message modulus 256) with a
    batch of 8, and the chain mix at uint5's gadget and key switch
    (message modulus 32)."""
    from go_tfhe_tpu_torch import params
    sbox = dataclasses.replace(toy_uint8, name="toy_uint8_sbox",
                               message_modulus=256)
    chain = dataclasses.replace(toy_uint, name="toy_uint_chain",
                                message_modulus=32)
    for p in (sbox, chain):
        monkeypatch.setitem(params.PROFILES, p.name, p)
    return {"sbox": toy_cell(sbox.name, dict(_mix("sbox-b256"), batch=8)),
            "chain": toy_cell(chain.name, _mix("lut-chain-b1"))}


def _run(cell, trace=False):
    import time
    return harness.run(cell, 2 ** 33 + 11, 0.2, trace, "cpu", time.time())


@pytest.mark.parametrize("kind", ["sbox", "chain"])
def test_sound_toy_runs_are_correct(kind, toys):
    r = _run(toys[kind])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["mismatched_ciphertexts"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("kind", ["sbox", "chain"])
def test_a_step_that_returns_its_state_unchanged(kind, toys, monkeypatch):
    return_state_unchanged(monkeypatch)
    r = _run(toys[kind])
    # In the chain only the first request differs: its output is the
    # key-switched test vector, a ciphertext with a = 0, on which no step
    # rotates, so every later request is bootstrapped alike either way.
    want = r["attempted"] if kind == "sbox" else 1
    assert not r["correct"] and r["failed"] == want


def test_half_of_the_batch_left_out(toys, monkeypatch):
    from go_tfhe_tpu_torch import engine
    whole = engine.bootstrap

    def half(ck, ct, testvec=None, plain=False):
        h = ct.shape[0] // 2
        out = whole(ck, ct[:h], testvec, plain)
        return torch.cat([out, out])            # the rest copied, not run

    monkeypatch.setattr(engine, "bootstrap", half)
    r = _run(toys["sbox"])
    assert not r["correct"] and 0 < r["failed"] < r["attempted"]


@pytest.mark.parametrize("kind", ["sbox", "chain"])
def test_an_answer_altered_where_it_is_produced(kind, toys, monkeypatch):
    from go_tfhe_tpu_torch import engine
    whole = engine.bootstrap

    def altered(ck, ct, testvec=None, plain=False):
        out = whole(ck, ct, testvec, plain)
        out[0, 0] += 1
        return out

    monkeypatch.setattr(engine, "bootstrap", altered)
    r = _run(toys[kind])
    assert not r["correct"] and r["failed"] >= 1


def test_a_traced_toy_sbox_run_reads_nothing_of_the_card(toys):
    """The CPU runs the kernels' plain versions: no K6 or K8 in the
    profile, so the two rooflines are left out and the run stays correct."""
    r = _run(toys["sbox"], trace=True)
    assert r["correct"]
    assert "blind_rotation.k8_roofline" not in r["metrics"]
    assert "blind_rotation.k6_roofline" not in r["metrics"]
    assert r["metrics"]["key_switch.share"]["value"] > 0


@pytest.mark.parametrize("kind", ["sbox", "chain"])
def test_the_control_fails_the_toy_runs(kind, toys):
    row = control.control_run(toys[kind], 2 ** 31 + 9, 4, 24, "cpu")
    assert 0 < row["mismatched_ciphertexts"] <= row["attempted"]


# ---------------------------------------------------------------------------
# The readers of the two rooflines.
# ---------------------------------------------------------------------------

def _params():
    with open(os.path.join(ROOT, "benchmark/configs/"
                           "pbs-uint8-centered.json")) as f:
        return json.load(f)["params"]


def test_the_rooflines_bound_k8_by_operations_and_k6_by_bytes():
    """At uint8, B 256: K8's least time a step is 0.3516 ms (the rotation's
    int8 operations over 1,979 TOP/s), K6's 0.0197 ms (66 MB a step over
    3.35 TB/s); a profile of two calls at K8's time reads 100%, at twice
    K6's 50%, and only the named kernels count."""
    p = _params()
    k8 = harness.load_reader("blind_rotation.k8_roofline")
    k6 = harness.load_reader("blind_rotation.k6_roofline")
    acc = 2 * 256 * 9 * 2048 * 4
    assert k6.step_bytes(p, 256) == acc + 256 * 4 + 2 * 3 * 256 * 9 * 2048
    k8_s = harness.yardstick.rotation_ops(p, 256) / 1160 / 1979e12
    k6_s = k6.step_bytes(p, 256) / 3.35e12
    assert k8_s == pytest.approx(0.3516e-3, rel=1e-3)
    assert k6_s == pytest.approx(0.0197e-3, rel=1e-2)
    ops = [["void extprod_kernel<3, 0>", 2 * 1160 * k8_s / 2],
           ["void rotdec_ext_kernel", 2 * 1160 * k6_s * 2],
           ["void extprod_t_kernel<3, 0>", 9.0],
           ["void rotdec_ext_t_kernel", 9.0],
           ["void extprod_kernel<3, 0>", 2 * 1160 * k8_s / 2]]
    obs = {"params": p, "batch": 256,
           "bootstrap_calls": 1,
           "profile": {"calls": 2, "device_ops": ops}}
    assert k8.read(obs) == pytest.approx(100.0)
    assert k6.read(obs) == pytest.approx(50.0)
    obs["profile"]["device_ops"] = ops[2:4]
    assert k8.read(obs) is None and k6.read(obs) is None
