"""The configuration ``pbs-uint6-centered`` and its cell
``pbs-uint6-centered.relu6-b2048`` (the signed 6-bit ReLU, k 2, on K4/K5),
and the mid-batch cell ``gate-128bit.nand-b256``: they load by name, the
configuration is the program's profile and names the extended reference,
the table is the ReLU of a two's-complement 6-bit message, the extended
reference equals the program word for word at uint6's gadget and key
switch (a toy ring on the CPU, floor and centered, both extended routes;
the published widths at the cell's batch of 2048 on the card), toy runs
of both mixes through the harness are ``correct`` until a fault of the
timed path turns them false, and the readers of K5's and K4's rooflines
count only their own kernels."""

import dataclasses
import os

import pytest
import torch

from benchmark import control, harness, traffic
from benchmark.reference import tfhe_ext
from conftest import ROOT, TFHE_EXT, toy_cell
from test_bench_reference_ext import (ROUTES, _keys, _messages,
                                      _program_key)

RELU_CELL = "pbs-uint6-centered.relu6-b2048"
NAND_CELL = "gate-128bit.nand-b256"


def _mix(name: str) -> dict:
    return traffic.load(os.path.join(ROOT, "benchmark", "traffic",
                                     name + ".json"))


# ---------------------------------------------------------------------------
# The data.
# ---------------------------------------------------------------------------

def test_both_cells_load_by_name():
    relu = harness.load_cell(RELU_CELL)
    assert relu.config["profile"] == "uint6_centered"
    assert relu.config["reference"] == TFHE_EXT
    assert (relu.mix["batch"], relu.mix["chain"]) == (2048, False)
    assert relu.mix["distinct_batches"] == 2
    assert {m["name"] for m in relu.end_to_end} == {
        "bootstraps_per_s", "peak_mem_gib", "setup_s"}
    assert {"blind_rotation.k5_roofline", "blind_rotation.k4_roofline",
            "rotation.ext_t_share", "blind_rotation_roofline",
            "key_switch.share", "device.idle_share.batch",
            "key_switch.transient_gib", "setup.first_launch_s"} <= {
        m["name"] for m in relu.per_layer}
    nand = harness.load_cell(NAND_CELL)
    assert nand.config["profile"] == "128bit"
    assert (nand.mix["batch"], nand.mix["chain"]) == (256, False)
    assert {m["name"] for m in nand.end_to_end} == {
        "bootstraps_per_s", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in nand.per_layer}
    assert {"blind_rotation_roofline", "key_switch.share",
            "device.idle_share.batch", "key_switch.transient_gib",
            "setup.first_launch_s"} <= names
    # the K4/K5 readers and the route share are the uint6 cell's alone
    assert not names & {"blind_rotation.k5_roofline",
                        "blind_rotation.k4_roofline", "rotation.ext_t_share"}


def test_the_configuration_is_uint6_centered_judged_by_the_ext_reference():
    from go_tfhe_tpu_torch import params
    from go_tfhe_tpu_torch.ops.cuda_ext_t import ext_t_fits
    cell = harness.load_cell(RELU_CELL)
    harness.check_profile(params.get_params("uint6_centered"),
                          cell.config["params"])
    assert os.path.samefile(cell.ref.__file__,
                            os.path.join(ROOT, "benchmark", "reference",
                                         "tfhe_ext.py"))
    prm = cell.ref.Params.from_config(cell.config["params"])
    assert (prm.poly_extend_factor, prm.n, prm.lwe_n) == (2, 2048, 1071)
    # the transposed extended kernels take the profile (engine._route)
    assert ext_t_fits(params.get_params("uint6_centered"))
    # the floor gadget's profile is refused: the configuration is centered
    with pytest.raises(ValueError, match="centered_decomposition"):
        harness.check_profile(params.get_params("uint6"),
                              cell.config["params"])


def test_the_table_is_the_signed_6_bit_relu():
    cell = harness.load_cell(RELU_CELL)
    table = _mix("relu6-b2048")["table"]
    assert len(table) == 64
    signed = [m - 64 if m >= 32 else m for m in range(64)]
    assert table == [max(v, 0) for v in signed]
    prm = cell.ref.Params.from_config(cell.config["params"])
    tr = traffic.Traffic(cell.mix, cell.ref, prm, "cpu")
    assert tr.table == table
    with pytest.raises(ValueError, match="table of 64"):
        traffic.Traffic(cell.mix, cell.ref,
                        dataclasses.replace(prm, message_modulus=32), "cpu")


def test_the_mid_batch_mix_is_cell_1s_at_256():
    mid, wide = _mix("nand-b256"), _mix("nand-b4096")
    assert (mid["batch"], wide["batch"]) == (256, 4096)
    drop = ("batch", "why")
    assert ({k: v for k, v in mid.items() if k not in drop}
            == {k: v for k, v in wide.items() if k not in drop})


# ---------------------------------------------------------------------------
# The extended reference against the program at uint6's gadget.
# ---------------------------------------------------------------------------

@pytest.fixture
def toy_uint6():
    """A small extended profile with uint6's k = 2, gadget (bgbit 22, l 1:
    three digit limbs) and key switch (basebit 6, t 3)."""
    from go_tfhe_tpu_torch import params
    return dataclasses.replace(params.UINT6, name="toy_uint6", lwe_n=24,
                               n=256, nbit=8, message_modulus=16)


@pytest.mark.parametrize("centered", [False, True],
                         ids=["floor", "centered"])
def test_extended_bootstrap_equals_the_program_at_uint6s_gadget(
        centered, toy_uint6):
    """Both extended routes (K4/K5's plain versions for a transposed key,
    K6/K8's otherwise) give the reference's words, which decrypt to the
    table."""
    from go_tfhe_tpu_torch import engine, lut
    p = dataclasses.replace(toy_uint6, centered_decomposition=centered)
    prm, gen, km = _keys(p, tfhe_ext, 7, "cpu")
    m, k = prm.message_modulus, prm.poly_extend_factor
    assert (k, p.digit_limbs) == (2, 3)
    msgs, ct, table = _messages(gen, prm, km, 2 * m)
    tv = tfhe_ext.lut_testvec(prm, table, m, "cpu")
    assert torch.equal(lut.Generator(p, m, device="cpu").gen_lut(
        lambda x: table[x]), tv)
    want = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    for transposed, route in ROUTES.items():
        ck = _program_key(p, km, transposed)
        assert engine._route(ck) == route
        assert torch.equal(lut.bootstrap_func(ck, ct, lambda x: table[x], m),
                           want)
    assert torch.equal(tfhe_ext.decrypt_message(want, m, km["lv0"]),
                       torch.tensor(table)[msgs])


def test_the_control_differs_in_every_ciphertext_at_uint6s_gadget(
        toy_uint6):
    p = dataclasses.replace(toy_uint6, centered_decomposition=True)
    prm, gen, km = _keys(p, tfhe_ext, 11, "cpu")
    _, ct, table = _messages(gen, prm, km, 4 * prm.message_modulus)
    tv = tfhe_ext.lut_testvec(prm, table, prm.message_modulus, "cpu")
    exact = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    lower = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"], key_bits=24)(ct, tv)
    assert (lower != exact).any(-1).all()


@pytest.mark.gpu
def test_uint6_at_the_cells_batch_on_the_card(card):
    """uint6_centered at its published widths and the cell's batch of
    2048: K4's two-pass plan and K5 at 4,096 block rows, and K6/K8, each
    equal to the reference word for word, every output decrypting to the
    ReLU's value."""
    from go_tfhe_tpu_torch import engine, lut, params
    p = params.get_params("uint6_centered")
    prm, gen, km = _keys(p, tfhe_ext, 2 ** 31 + 23, card)
    m = prm.message_modulus
    msgs, ct, _ = _messages(gen, prm, km, 2048)
    table = _mix("relu6-b2048")["table"]
    got = {}
    for transposed in (True, False):
        ck = _program_key(p, km, transposed)
        got[engine._route(ck)] = lut.bootstrap_func(
            ck, ct, lambda x: table[x], m)
        del ck
    torch.cuda.empty_cache()
    tv = tfhe_ext.lut_testvec(prm, table, m, card)
    want = tfhe_ext.Bootstrap(prm, km["bsk"], km["ksk"])(ct, tv)
    assert set(got) == set(ROUTES.values())
    for out in got.values():
        assert torch.equal(out, want)
    assert torch.equal(tfhe_ext.decrypt_message(want, m, km["lv0"]),
                       torch.tensor(table, device=card)[msgs])


# ---------------------------------------------------------------------------
# Toy runs through the harness, sound and broken.
# ---------------------------------------------------------------------------

@pytest.fixture
def toys(monkeypatch, toy_uint6):
    """The ReLU mix at uint6's k 2, gadget and key switch (message modulus
    64) with a batch of 8, and the mid-batch NAND mix at the test gate
    profile with a batch of 8."""
    from go_tfhe_tpu_torch import params
    relu = dataclasses.replace(toy_uint6, name="toy_uint6_relu",
                               message_modulus=64,
                               centered_decomposition=True)
    monkeypatch.setitem(params.PROFILES, relu.name, relu)
    return {"relu": toy_cell(relu.name, dict(_mix("relu6-b2048"), batch=8)),
            "nand": toy_cell("test_fast", dict(_mix("nand-b256"), batch=8))}


def _run(cell, trace=False):
    import time
    return harness.run(cell, 2 ** 33 + 13, 0.2, trace, "cpu", time.time())


@pytest.mark.parametrize("kind", ["relu", "nand"])
def test_sound_toy_runs_are_correct(kind, toys):
    r = _run(toys[kind])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["mismatched_ciphertexts"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("kind", ["relu", "nand"])
def test_a_step_that_returns_its_state_unchanged(kind, toys, monkeypatch):
    """Each route's contraction, kernel and plain version alike, hands back
    the accumulator it was given (``rotate`` reads them from ``ROUTES``)."""
    from go_tfhe_tpu_torch.ops import blindrotate

    def unchanged(digits, band, acc, *rest):
        return acc

    for name in ("blind_rotate_t", "blind_rotate_extended_t"):
        r = blindrotate.ROUTES[name]
        monkeypatch.setitem(blindrotate.ROUTES, name, r._replace(
            kernels=(r.kernels[0], unchanged, *r.kernels[2:]),
            plain=(r.plain[0], unchanged, *r.plain[2:])))
    r = _run(toys[kind])
    assert not r["correct"] and r["failed"] == r["attempted"]


def test_a_traced_toy_relu_run_reads_the_route_and_nothing_of_the_card(
        toys):
    """The CPU runs the kernels' plain versions: no K4 or K5 in the
    profile, so their rooflines are left out; every rotation took the
    transposed extended route."""
    from go_tfhe_tpu_torch.utils import tracing
    tracing.reset()              # an earlier test's rotations
    r = _run(toys["relu"], trace=True)
    assert r["correct"]
    assert "blind_rotation.k5_roofline" not in r["metrics"]
    assert "blind_rotation.k4_roofline" not in r["metrics"]
    assert r["metrics"]["rotation.ext_t_share"]["value"] == 100.0
    assert tracing.snapshot()["rotations"]["by_route"] == {
        "blind_rotate_extended_t": tracing.rotation_counts["rotations"]}


@pytest.mark.parametrize("kind", ["relu", "nand"])
def test_the_control_fails_the_toy_runs(kind, toys):
    row = control.control_run(toys[kind], 2 ** 31 + 17, 1, 24, "cpu")
    assert 0 < row["mismatched_ciphertexts"] <= row["attempted"]


# ---------------------------------------------------------------------------
# The readers of K5's and K4's rooflines.
# ---------------------------------------------------------------------------

def _params():
    return harness.load_cell(RELU_CELL).config["params"]


def test_the_rooflines_bound_k5_by_operations_and_k4_by_bytes():
    """At uint6, B 2048: K5's least time a step is 0.625 ms (the rotation's
    int8 operations over 1,979 TOP/s), K4's 35.0 us (117.4 MB a step over
    3.35 TB/s, the two-pass scratch not counted); a profile of two calls
    at K5's time reads 100%, at twice K4's (its two kernels together)
    50%, and only K4's and K5's own kernels count."""
    p = _params()
    k5 = harness.load_reader("blind_rotation.k5_roofline")
    k4 = harness.load_reader("blind_rotation.k4_roofline")
    k6 = harness.load_reader("blind_rotation.k6_roofline")
    step = k6.step_bytes(p, 2048)
    assert step == 2 * 2048 * 2 * 2048 * 4 + 2048 * 4 + 2 * 3 * 2048 * 4096
    assert step == pytest.approx(117.4e6, rel=1e-3)
    k5_s = harness.yardstick.rotation_ops(p, 2048) / 1071 / 1979e12
    k4_s = step / 3.35e12
    assert k5_s == pytest.approx(0.625e-3, rel=1e-3)
    assert k4_s == pytest.approx(35.0e-6, rel=1e-2)
    ops = [["void (anonymous namespace)::extprod_ext_t_kernel<3, 0>",
            2 * 1071 * k5_s / 2],
           ["void rotdec_col::rotdec_kernel<4>", 2 * 1071 * k4_s * 1.5],
           ["(anonymous namespace)::untile_kernel", 2 * 1071 * k4_s / 2],
           ["void (anonymous namespace)::extprod_t_kernel<3, 0>", 9.0],
           ["void (anonymous namespace)::extprod_kernel<3, 0>", 9.0],
           ["(anonymous namespace)::rotdec_ext_kernel", 9.0],
           ["void (anonymous namespace)::extprod_ext_t_kernel<3, 0>",
            2 * 1071 * k5_s / 2]]
    obs = {"params": p, "batch": 2048,
           "bootstrap_calls": 1,
           "profile": {"calls": 2, "device_ops": ops}}
    assert k5.read(obs) == pytest.approx(100.0)
    assert k4.read(obs) == pytest.approx(50.0)
    obs["profile"]["device_ops"] = ops[3:6]
    assert k5.read(obs) is None and k4.read(obs) is None
    assert k5.read({"params": p, "batch": 2048}) is None
