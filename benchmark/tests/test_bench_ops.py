"""A mix's op is a file of its own (``benchmark/ops/<op>.py``): the two
ops that the cells run make the same bytes that the generator made before
they were moved there, an op or a key that no file knows is refused, and
an op from another directory, two dependent bootstraps a request, runs
through the harness, is counted as two, and is judged: ``correct`` until a
fault of the timed path turns it false."""

import dataclasses
import hashlib
import json
import time

import pytest
import torch

from benchmark import harness, traffic
from conftest import (MIXES, PROFILE_OF, return_state_unchanged, toy_cell,
                      toy_run)

# The sha256 of the toy kinds' data at seed 2**33 + 5 (key material,
# inputs, digest weights), as the generator made them before its ops were
# moved into files of their own.
DATA_SHA256 = dict(
    nand="6a25aaf677c2a65740e21ff1d193140e9d58a347c0c18bdb629ed7a8d1c16fab",
    chain="58029651dc8b23aaaa49502d9ce10f39b99ead6f73ece69e253ccbd540084a37",
    lut="be0fc40f6a91688f767c4757c1c401cfdca49f4009c2845539ce1622d2c0aec1",
    ext="30c4358759f48d5f12628e2b8909b1e0541f04e906da220cfc082d19b17f451a",
)


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    return [tree]


def _data_sha256(kind: str, seed: int = 2 ** 33 + 5) -> str:
    r = harness.Run(toy_cell(PROFILE_OF[kind], MIXES[kind]), seed, 0.0,
                    "cpu", time.time())
    r.make_data()
    h = hashlib.sha256()
    for t in _flat([r.inputs, r.weights, r.keys]):
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.contiguous().numpy().tobytes())
    for k in sorted(r.raw):
        h.update(r.raw[k].tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("kind", sorted(DATA_SHA256))
def test_the_moved_ops_make_the_same_bytes(kind):
    assert _data_sha256(kind) == DATA_SHA256[kind]


# ---------------------------------------------------------------------------
# What is refused.
# ---------------------------------------------------------------------------

def _write(tmp_path, mix: dict) -> str:
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    return str(path)


@pytest.mark.parametrize("op", ["adder", "../harness", ".gate", None, 3])
def test_an_op_with_no_file_is_refused(op, tmp_path):
    mix = dict(MIXES["nand"], op=op)
    with pytest.raises(ValueError, match="no op"):
        traffic.load(_write(tmp_path, mix))
    with pytest.raises(ValueError, match="no op"):
        traffic.load_op(op)


@pytest.mark.parametrize("kind,key", [("lut", "gate"), ("nand", "table"),
                                      ("chain", "rate")])
def test_a_key_neither_common_nor_the_ops_is_refused(kind, key, tmp_path):
    """``gate`` is the gate op's key and ``table`` the lut op's: each is
    unknown to the other."""
    mix = dict(MIXES[kind], **{key: 1})
    with pytest.raises(ValueError, match=f"unknown keys \\['{key}'\\]"):
        traffic.load(_write(tmp_path, mix))
    traffic.load(_write(tmp_path, MIXES[kind]))


def test_the_cells_ops_are_files_and_count_one_bootstrap_call():
    from benchmark.reference import tfhe as ref
    prm = ref.Params(lwe_n=16, lwe_alpha=2 ** -20, n=128, nbit=7,
                     lv1_alpha=2 ** -28, bgbit=8, l=2, basebit=4, iks_t=6,
                     message_modulus=2)
    tr = traffic.Traffic(MIXES["nand"], ref, prm, "cpu")
    assert tr.op.__class__.__module__ == "benchmark_op_gate"
    assert (tr.bootstrap_calls(), tr.batch, tr.chain) == (1, 8, False)
    lut = traffic.Traffic(MIXES["lut"], ref,
                          dataclasses.replace(prm, message_modulus=8), "cpu")
    assert lut.bootstrap_calls() == 1
    assert lut.table == MIXES["lut"]["table"]


# ---------------------------------------------------------------------------
# A toy op of two dependent bootstraps, from a directory of its own.
# ---------------------------------------------------------------------------

TOY_OP = '''"""A toy op: XOR(a, b), then AND of that and b, on batch
pairs a call: two dependent gate bootstraps a request."""

import torch

from benchmark import traffic

KEYS = set()


class Op(traffic.Op):

    def bootstrap_calls(self):
        return 2

    def make_inputs(self, gen, keys):
        def encrypt(bits):
            return self.ref.lwe_encrypt(gen, self.ref.encode_bool(bits),
                                        self.prm.lwe_alpha, keys["lv0"])

        batches = []
        for _ in range(self.mix["distinct_batches"]):
            pa, pb = (torch.randint(0, 2, (2, self.batch), generator=gen,
                                    device=gen.device) > 0)
            batches.append({"plain_a": pa, "plain_b": pb,
                            "a": encrypt(pa), "b": encrypt(pb)})
        return {"batches": batches}

    def request(self, inputs, k, previous=None):
        return inputs["batches"][k % len(inputs["batches"])]

    def expected(self, inputs, k, previous=None):
        req = self.request(inputs, k)
        return (req["plain_a"] ^ req["plain_b"]) & req["plain_b"]

    def call(self, port, ck, req):
        x = port.gates.XOR(ck, req["a"], req["b"])
        return port.gates.AND(ck, x, req["b"])

    def engine_args(self, port, ck, req):
        return port.engine.prepare_xor(req["a"], req["b"]), None

    def reference(self, boot, req, testvec):
        x = boot(self.ref.gate_input("XOR", req["a"], req["b"]), testvec)
        return boot(self.ref.gate_input("AND", x, req["b"]), testvec)

    def decrypt(self, out, keys):
        return self.ref.decrypt_bool(out, keys["lv0"])
'''
TOY_MIX = {"op": "xor_and", "batch": 8, "loop": "closed", "chain": False,
           "distinct_batches": 2}


@pytest.fixture
def toy_op(tmp_path):
    """The toy op's cell at ``test_fast``, its op file in a temporary
    directory."""
    (tmp_path / "xor_and.py").write_text(TOY_OP)
    assert traffic.load(_write(tmp_path, TOY_MIX), str(tmp_path)) == TOY_MIX
    with pytest.raises(ValueError, match="no op"):
        traffic.load(_write(tmp_path, TOY_MIX))      # not in benchmark/ops
    return toy_cell("test_fast", TOY_MIX, str(tmp_path))


def _run(cell, trace=False):
    return harness.run(cell, 2 ** 33 + 19, 0.2, trace, "cpu", time.time())


def test_the_toy_op_is_correct_and_counts_two_bootstraps_a_call(
        toy_op, monkeypatch):
    r = _run(toy_op)
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] == r["calls"] * 8
    assert r["metrics"]["bootstraps_per_s"]["value"] == (
        r["calls"] * 2 * 8 / r["window_s"])
    # the readers are told the op's bootstrap calls
    seen = set()
    load_reader = harness.load_reader

    def spy(name):
        reader = load_reader(name)
        read = reader.read
        reader.read = lambda obs: seen.add(obs["bootstrap_calls"]) or read(obs)
        return reader

    monkeypatch.setattr(harness, "load_reader", spy)
    traced = _run(toy_op, trace=True)
    assert traced["correct"] and "breakdown" in traced
    assert seen == {2}


def _half(monkeypatch):
    from go_tfhe_tpu_torch import engine
    whole = engine.bootstrap

    def half(ck, ct, testvec=None, plain=False):
        h = ct.shape[0] // 2
        out = whole(ck, ct[:h], testvec, plain)
        return torch.cat([out, out])            # the rest copied, not run

    monkeypatch.setattr(engine, "bootstrap", half)


def _altered(monkeypatch):
    from go_tfhe_tpu_torch import engine
    whole = engine.bootstrap

    def altered(ck, ct, testvec=None, plain=False):
        out = whole(ck, ct, testvec, plain)
        out[0, 0] += 1
        return out

    monkeypatch.setattr(engine, "bootstrap", altered)


@pytest.mark.parametrize("fault,wrong", [
    (return_state_unchanged, "all"),     # a step returns its state unchanged
    (_half, "some"),                     # half of the batch left out
    (_altered, "one or more"),           # an answer altered where made
], ids=["unchanged_step", "half_batch", "altered_answer"])
def test_each_fault_turns_the_toy_op_false(fault, wrong, toy_op,
                                           monkeypatch):
    fault(monkeypatch)
    r = _run(toy_op)
    assert not r["correct"]
    if wrong == "all":
        assert r["failed"] == r["attempted"]
    elif wrong == "some":
        assert 0 < r["failed"] < r["attempted"]
    else:
        assert r["failed"] >= 1


# ---------------------------------------------------------------------------
# The readers that count a profiled call's work.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,kernel", [
    ("blind_rotation.k4_roofline", "rotdec_col::rotdec_kernel<4>"),
    ("blind_rotation.k5_roofline", "extprod_ext_t_kernel<3, 0>"),
    ("blind_rotation.k6_roofline", "rotdec_ext_kernel"),
    ("blind_rotation.k8_roofline", "extprod_kernel<3, 0>"),
])
def test_the_rooflines_count_every_bootstrap_call_of_a_request(metric,
                                                               kernel):
    """Two bootstrap calls a request in the same device time read twice
    the share of one."""
    params = harness.load_cell("pbs-uint6-centered.relu6-b2048").config[
        "params"]
    reader = harness.load_reader(metric)
    obs = {"params": params, "batch": 64,
           "profile": {"calls": 2, "device_ops": [[kernel, 10.0]]}}
    one = reader.read(dict(obs, bootstrap_calls=1))
    assert one > 0
    assert reader.read(dict(obs, bootstrap_calls=2)) == pytest.approx(2 * one)

