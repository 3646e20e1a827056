"""blind_rotate_t's step graph (ops/blindrotate.py): on a card, at a batch
of at most ``cuda_t.SMALL_BATCH_MAX``, the n_lwe steps are one replay of a
CUDA graph of the eager loop's launches (one launch of the fused step
each, K1 inside K2's small form).  Its rule, its counter, the cache
that ties each graph to its bands, and the benchmark's reader of the
counter (``benchmark/metrics/rotation.graph_share.py``) on the CPU; the
replay's words, counts and buffers on the card (``gpu`` cases, which skip
without one):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_rotation_graph.py
"""

import gc
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, engine, keys  # noqa: E402
from go_tfhe_tpu_torch import params as tparams  # noqa: E402
from go_tfhe_tpu_torch.ops import blindrotate, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.utils import tracing  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import to_numpy_u32  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = cuda_t.SMALL_BATCH_MAX


def _reader():
    path = os.path.join(ROOT, "benchmark", "metrics",
                        "rotation.graph_share.py")
    spec = importlib.util.spec_from_file_location("graph_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


@pytest.mark.parametrize("device,b,plain,engages", [
    ("cuda", 1, False, True),
    ("cuda", 2, False, True),
    ("cuda", TOP, False, True),
    ("cuda", TOP + 1, False, False),
    ("cuda", 4096, False, False),
    ("cuda", 1, True, False),
    ("cpu", 1, False, False),
    ("cpu", TOP + 1, False, False),
    ("meta", 1, False, False),
])
def test_the_graph_engages_only_on_a_card_at_small_batches(device, b, plain,
                                                           engages):
    """Kernels on a card (not their plain versions) at B <= SMALL_BATCH_MAX;
    nothing else."""
    assert blindrotate.takes_graph(torch.device(device), b, plain) is engages


@pytest.fixture(scope="module")
def fast():
    p = tparams.get_params("test_fast")
    gen = torch.Generator().manual_seed(21)
    sk = keys.gen_secret_key(gen, p, "cpu")
    return p, gen, sk, keys.gen_cloud_key(gen, sk, p)


@pytest.mark.parametrize("b", [1, 3])
def test_a_cpu_rotation_counts_and_replays_nothing(fast, b):
    """On the CPU every rotation of blind_rotate_t is counted, none is
    replayed, no graph is cached, and the words are the eager loop's: the
    bootstrap, bootstrap_many and the plain versions alike."""
    p, gen, sk, ck = fast
    x = cipher.lwe_encrypt_bool(gen, torch.ones(b, dtype=torch.bool),
                                p.lwe_alpha, sk.lv0)
    graphs = dict(blindrotate._graphs)
    tracing.reset()
    out = engine.bootstrap(ck, x)
    engine.bootstrap(ck, x, plain=True)
    engine.bootstrap_many(ck, x, ck.testvec, k=2, theta=1)
    assert blindrotate.rotation_counts == {"rotations": 3, "replayed": 0}
    assert tracing.snapshot()["rotations"] == {
        "rotations": 3, "replayed": 0, "by_route": {"blind_rotate_t": 3}}
    assert blindrotate._graphs == graphs
    assert cipher.lwe_decrypt_bool(out, sk.lv0).all()
    tracing.reset()
    assert blindrotate.rotation_counts == {"rotations": 0, "replayed": 0}


def test_the_reader_reads_the_share_of_replayed_rotations(monkeypatch):
    """100 x replayed / rotations; None where no rotation ran."""
    reader = _reader()
    counts = blindrotate.rotation_counts
    monkeypatch.setitem(counts, "rotations", 700)
    monkeypatch.setitem(counts, "replayed", 700)
    assert reader.read({}) == 100.0
    monkeypatch.setitem(counts, "replayed", 175)
    assert reader.read({}) == 25.0
    monkeypatch.setitem(counts, "replayed", 0)
    assert reader.read({}) == 0.0
    monkeypatch.setitem(counts, "rotations", 0)
    assert reader.read({}) is None


def test_the_reader_reads_nothing_from_a_program_without_the_counter(
        monkeypatch):
    """A program that launches every step from the host has no such
    counter; one whose module cannot be imported gives nothing either."""
    reader = _reader()
    monkeypatch.delattr(blindrotate, "rotation_counts")
    assert reader.read({}) is None
    monkeypatch.setitem(sys.modules, "go_tfhe_tpu_torch.ops.blindrotate",
                        None)
    assert reader.read({}) is None


class _StandInGraph:
    """A step graph without a card: records what it was made for, and a
    replay returns a marker in the route's layout (it keeps no reference
    to the bands, as the real one keeps none)."""

    made = []

    def __init__(self, route, p, bands, b, device):
        assert route is blindrotate.ROUTES["blind_rotate_t"]
        self.b, self.n, self.n_lwe = b, p.n, p.lwe_n
        self.made.append((p.name, b))

    def run(self, acc, a_tilda):
        assert acc.shape == (2, self.n, self.b)
        assert a_tilda.shape == (self.n_lwe, self.b)
        return torch.full((2, self.n, self.b), 7, dtype=torch.int32)


def test_the_cache_lives_and_dies_with_the_bands(fast, monkeypatch):
    """Where the graph engages (forced here on the CPU, with a stand-in
    graph): the first rotation at a batch runs eagerly and then captures,
    the next replays; another batch or other bands get entries of their
    own; the bands' end drops theirs, so no graph outlives the bands it
    reads."""
    p, gen, sk, ck = fast
    monkeypatch.setattr(blindrotate, "takes_graph",
                        lambda device, b, plain=False: not plain)
    monkeypatch.setattr(blindrotate, "_StepGraph", _StandInGraph)
    monkeypatch.setattr(_StandInGraph, "made", [])
    monkeypatch.setattr(blindrotate, "rotation_counts",
                        {"rotations": 0, "replayed": 0})
    x1, x3 = (cipher.lwe_encrypt_bool(gen, torch.ones(b, dtype=torch.bool),
                                      p.lwe_alpha, sk.lv0) for b in (1, 3))
    bands, other = ck.bands.clone(), ck.bands.clone()

    def rotate(bands, x):
        return blindrotate.blind_rotate_t(p, bands, x, ck.testvec)

    first = rotate(bands, x1)
    np.testing.assert_array_equal(
        first.numpy(), blindrotate.blind_rotate_t(p, bands, x1, ck.testvec,
                                                  plain=True).numpy())
    assert _StandInGraph.made == [(p.name, 1)]
    assert (rotate(bands, x1) == 7).all()
    assert (rotate(bands, x1) == 7).all()
    assert blindrotate.rotation_counts == {"rotations": 4, "replayed": 2}
    # (the plain call took no graph)
    rotate(bands, x3)
    rotate(other, x1)
    assert _StandInGraph.made == [(p.name, 1), (p.name, 3), (p.name, 1)]
    assert len(blindrotate._graphs_of(bands)) == 2
    assert len(blindrotate._graphs_of(other)) == 1
    key = id(bands)
    del bands
    assert key not in blindrotate._graphs
    assert id(other) in blindrotate._graphs
    key = id(other)
    del other
    gc.collect()
    assert key not in blindrotate._graphs


# ---------------------------------------------------------------------------
# On the card: the replay against the eager loop and the plain versions.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _words(gen, shape, device):
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                         generator=gen).to(torch.int32).to(device)


def _key(p, device, seed):
    """Bands of a uniform-word raw key at the profile's full shapes (the
    words, not decryption, are compared)."""
    gen = torch.Generator().manual_seed(seed)
    bsk = _words(gen, (p.lwe_n, 2 * p.l, 2, p.n), device)
    return cuda_t.pack_bsk_band_t(bsk, cuda_t.band_limb_drop(p))


def _inputs(p, b, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return (_words(gen, (b, p.lwe_n + 1), device),
            _words(gen, (2, p.n), device))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, TOP])
@pytest.mark.parametrize("profile", ["test_fast", "128bit", "uint5"])
def test_replay_equals_the_eager_loop_and_plain_on_gpu(cuda_device, profile,
                                                       b, monkeypatch):
    """The first call at a batch runs eagerly and captures; the replays
    that follow give the eager loop's words and the plain versions', and
    each counts as a replayed rotation."""
    p = tparams.get_params(profile)
    bands = _key(p, cuda_device, 1)
    ct, tv = _inputs(p, b, cuda_device, 2)
    ct2, _ = _inputs(p, b, cuda_device, 3)
    before = dict(blindrotate.rotation_counts)
    first = blindrotate.blind_rotate_t(p, bands, ct, tv)
    assert blindrotate.rotation_counts["replayed"] == before["replayed"]
    graph = [blindrotate.blind_rotate_t(p, bands, c, tv) for c in (ct, ct2)]
    assert blindrotate.rotation_counts["replayed"] == before["replayed"] + 2
    with monkeypatch.context() as m:
        m.setattr(blindrotate, "takes_graph", lambda *args: False)
        eager = [blindrotate.blind_rotate_t(p, bands, c, tv)
                 for c in (ct, ct2)]
    plain = [blindrotate.blind_rotate_t(p, bands, c, tv, plain=True)
             for c in (ct, ct2)]
    assert blindrotate.rotation_counts["replayed"] == before["replayed"] + 2
    assert blindrotate.rotation_counts["rotations"] == \
        before["rotations"] + 7
    np.testing.assert_array_equal(to_numpy_u32(first), to_numpy_u32(eager[0]))
    for g, e, q in zip(graph, eager, plain):
        assert g.shape == (b, 2, p.n) and g.is_contiguous()
        np.testing.assert_array_equal(to_numpy_u32(g), to_numpy_u32(e))
        np.testing.assert_array_equal(to_numpy_u32(g), to_numpy_u32(q))


@pytest.mark.gpu
def test_batch_above_the_small_form_takes_no_graph_on_gpu(cuda_device):
    p = tparams.get_params("test_fast")
    bands = _key(p, cuda_device, 4)
    ct, tv = _inputs(p, TOP + 1, cuda_device, 5)
    before = dict(blindrotate.rotation_counts)
    blindrotate.blind_rotate_t(p, bands, ct, tv)
    torch.cuda.synchronize()
    assert blindrotate.rotation_counts == {
        "rotations": before["rotations"] + 1, "replayed": before["replayed"]}
    assert id(bands) not in blindrotate._graphs


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
def test_a_result_outlives_the_next_replay_on_gpu(cuda_device, b):
    """The returned tensor is the caller's: a second call overwrites the
    graph's output buffer, not the first call's result (at B 1 the
    layout back is a view, so without a copy it would be that buffer)."""
    p = tparams.get_params("test_fast")
    bands = _key(p, cuda_device, 6)
    (ct, tv), (ct2, _) = (_inputs(p, b, cuda_device, s) for s in (7, 8))
    blindrotate.blind_rotate_t(p, bands, ct2, tv)          # eager, captures
    first = blindrotate.blind_rotate_t(p, bands, ct, tv)
    kept = first.clone()
    second = blindrotate.blind_rotate_t(p, bands, ct2, tv)
    torch.cuda.synchronize()
    assert not torch.equal(second, kept)
    np.testing.assert_array_equal(to_numpy_u32(first), to_numpy_u32(kept))
    graph = blindrotate._graphs[id(bands)][1]
    outs = {g.out.untyped_storage().data_ptr() for g in graph.values()}
    assert first.untyped_storage().data_ptr() not in outs
    assert second.untyped_storage().data_ptr() not in outs


@pytest.mark.gpu
def test_two_keys_get_two_entries_and_a_freed_key_drops_its_own_on_gpu(
        cuda_device):
    p = tparams.get_params("test_fast")
    one, two = _key(p, cuda_device, 9), _key(p, cuda_device, 10)
    ct, tv = _inputs(p, 1, cuda_device, 11)
    a, b = (blindrotate.blind_rotate_t(p, k, ct, tv) for k in (one, two))
    assert not torch.equal(a, b)
    assert len(blindrotate._graphs[id(one)][1]) == 1
    assert len(blindrotate._graphs[id(two)][1]) == 1
    key = id(one)
    del one
    assert key not in blindrotate._graphs
    assert id(two) in blindrotate._graphs
    # the other key's graph still replays its own words
    again = blindrotate.blind_rotate_t(p, two, ct, tv)
    np.testing.assert_array_equal(to_numpy_u32(again), to_numpy_u32(b))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("profile", ["128bit", "uint5"])
def test_a_replayed_fused_rotation_equals_k1_k2_and_plain_on_gpu(
        cuda_device, profile, b, monkeypatch):
    """The steps replayed from the graph run the fused step (K1 inside
    K2's small form); their words equal the eager fused loop's, the eager
    loop of K1 then K2 (the fused rule turned off), and the plain
    versions'."""
    p = tparams.get_params(profile)
    bands = _key(p, cuda_device, 14)
    ct, tv = _inputs(p, b, cuda_device, 15)
    blindrotate.blind_rotate_t(p, bands, ct, tv)             # eager, captures
    graph = blindrotate.blind_rotate_t(p, bands, ct, tv)
    (step_graph,) = blindrotate._graphs_of(bands).values()
    assert step_graph.launches["step_t_small"] == p.lwe_n
    with monkeypatch.context() as m:
        m.setattr(blindrotate, "takes_graph", lambda *args: False)
        eager = blindrotate.blind_rotate_t(p, bands, ct, tv)
        m.setattr(blindrotate, "takes_fused_step", lambda *args: False)
        before = dict(cuda_t.launch_counts)
        pair = blindrotate.blind_rotate_t(p, bands, ct, tv)
        assert cuda_t.launch_counts["rotate_decompose_t"] == \
            before["rotate_decompose_t"] + p.lwe_n
        assert cuda_t.launch_counts["step_t_small"] == before["step_t_small"]
    plain = blindrotate.blind_rotate_t(p, bands, ct, tv, plain=True)
    for other in (eager, pair, plain):
        np.testing.assert_array_equal(to_numpy_u32(graph),
                                      to_numpy_u32(other))


@pytest.mark.gpu
@pytest.mark.parametrize("profile", ["128bit", "uint5"])
def test_each_replay_counts_its_launches_on_gpu(cuda_device, profile):
    """A replay adds what the card ran: n_lwe launches of the fused step,
    each also a K2 launch of the small form, and no K1; the capture
    itself counts nothing."""
    p = tparams.get_params(profile)
    bands = _key(p, cuda_device, 12)
    ct, tv = _inputs(p, 1, cuda_device, 13)
    blindrotate.blind_rotate_t(p, bands, ct, tv)     # warm step, capture
    before = dict(cuda_t.launch_counts)
    blindrotate.blind_rotate_t(p, bands, ct, tv)
    torch.cuda.synchronize()
    added = {name: cuda_t.launch_counts[name] - n
             for name, n in before.items()}
    n = p.lwe_n
    assert added == dict(dict.fromkeys(added, 0), step_t_small=n,
                         extprod_t=n, extprod_t_small=n)
    assert added["rotate_decompose_t"] == 0
    graph = blindrotate._graphs[id(bands)][1]
    assert [g.launches for g in graph.values()] == [
        {"step_t_small": n, "extprod_t": n, "extprod_t_small": n}]
