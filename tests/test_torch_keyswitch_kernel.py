"""The key switch's gather-and-sum kernel (``csrc/keyswitch.cu``, launched
by ``ops/keyswitch.digit_table_switch`` for CUDA tensors): its rule, its
counts (``utils/tracing.key_switch_counts``, ``launch_counts
["key_switch"]``), the plain path's choice of it, and the benchmark's
reader of them (``benchmark/metrics/key_switch.kernel_share.py``) on the
CPU; the kernel against the plain version, word for word, at every
profile's KSK shape and at proxy re-encryption's, and against the JAX
package's recorded words, on the card (``gpu`` cases, which skip without
one):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_keyswitch_kernel.py
"""

import contextlib
import hashlib
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import engine, keys, proxyreenc  # noqa: E402
from go_tfhe_tpu_torch import params as tparams  # noqa: E402
from go_tfhe_tpu_torch.ops import _build, cuda_t, keyswitch  # noqa: E402
from go_tfhe_tpu_torch.utils import tracing  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import (from_numpy_u32,  # noqa: E402
                                           to_numpy_u32)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The registered profiles whose KSK shapes the kernel is held to on the
# card: the cells' (128bit, uint5, uint6_centered, uint8_centered), the
# fast gadget's, and the smallest test profiles'.
PROFILES = ("128bit", "128bit_fast", "uint5", "uint6_centered",
            "uint8_centered", "test_fast", "test_pbs")
# Batches: one ciphertext, ragged ones around the kernel's 32-ciphertext
# rows and tiles, the cells' 256 and 2048; the leading axes they come in.
BATCHES = {1: (1,), 3: (3,), 4: (2, 2), 32: (32,), 33: (3, 11),
           256: (4, 64), 2048: (2, 1024)}
# The JAX package's identity_key_switch on jax_case(profile)'s inputs: the
# sha256 of its output's little-endian u32 words.
# tests/test_torch_keyswitch_shared.py computes them with the JAX package
# on the CPU; the card, which has no JAX, is held to them here.
JAX_WORDS_SHA256 = {
    "test_fast":
        "310494d035b2802110c5dc75a3bcc0b60c1ff34da7da8a261644d5d5156de0d3",
    "test_pbs":
        "3915e113ea3ddc38e68b8eddd50b0899fbe0e945155a888e465de5344fbb59e9",
    "128bit":
        "9e0e1c5d49cd23f8622da74f25d49dd197bde4566d3bac1254e8a91fe8b6f9a6",
}
JAX_SEED = 2025


def _reader():
    path = os.path.join(ROOT, "benchmark", "metrics",
                        "key_switch.kernel_share.py")
    spec = importlib.util.spec_from_file_location("kernel_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


def _words(gen, shape, device="cpu"):
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                         generator=gen).to(torch.int32).to(device)


def _table(gen, n, t, basebit, w, device="cpu"):
    """A random digit table whose digit-0 rows are zero, as every keygen's
    (keys.gen_ksk, proxyreenc's keygens)."""
    table = _words(gen, (n, t, 1 << basebit, w), device)
    table[:, :, 0, :] = 0
    return table


def _edge_words(basebit, t):
    """0, 2^32 - 1, 2^31 - 1, 2^31, and the words at and beside the
    digits' rounding edges: a + 2^(31 - basebit*t) crosses a multiple of
    2^(32 - basebit*t), the lowest digit's step, at k * 2^(32 - basebit*t)
    - 2^(31 - basebit*t); the k here also move every higher digit."""
    step, half = 1 << (32 - basebit * t), 1 << (31 - basebit * t)
    words = [0, 2 ** 32 - 1, 2 ** 31 - 1, 2 ** 31]
    for k in (0, 1, 2, 1 << (basebit * t - 1), (1 << basebit * t) - 1):
        words += [(k * step - half + d) % 2 ** 32 for d in (-1, 0, 1)]
    return torch.tensor(words, dtype=torch.int64).to(torch.int32)


def _ciphertexts(gen, lead, n, basebit, t, device="cpu"):
    """Random words of shape lead + (n+1,): the edge words laid over the
    first ciphertext's a-part, and one edge word in each of the others, at
    a position and of a choice that move from one to the next."""
    ct = _words(gen, lead + (n + 1,))
    rows = ct.view(-1, n + 1)
    edges = _edge_words(basebit, t)
    m = min(len(edges), n)
    rows[0, :m] = edges[:m]
    for k in range(1, rows.shape[0]):
        rows[k, (7 * k) % n] = edges[k % len(edges)]
    return ct.to(device)


def _raw_words(seed, count):
    """count u32 words of PCG64's raw stream, whose output is the same on
    every numpy version, so the CPU and the card draw the same inputs."""
    raw = np.random.PCG64(seed).random_raw((count + 1) // 2)
    return raw.astype("<u8").view("<u4")[:count].astype(np.uint32)


def jax_case(profile):
    """(params, KSK, ciphertexts) of the JAX comparison at ``profile``: a
    KSK of raw words with zero digit-0 rows, as keygen leaves them, and
    (2, 3) level-1 ciphertexts of raw words, the digits' edge words laid
    over the first one's a-part; numpy u32 arrays."""
    p = tparams.get_params(profile)
    ksk = _raw_words(JAX_SEED, p.n * p.iks_t * p.base * (p.lwe_n + 1)
                     ).reshape(p.n, p.iks_t, p.base, p.lwe_n + 1)
    ksk[:, :, 0] = 0
    ct = _raw_words(JAX_SEED + 1, 6 * (p.n + 1)).reshape(2, 3, p.n + 1)
    edges = _edge_words(p.basebit, p.iks_t).numpy().view(np.uint32)
    m = min(len(edges), p.n)
    ct[0, 0, :m] = edges[:m]
    return p, ksk, ct


def words_sha256(words) -> str:
    """The sha256 of u32 words (a numpy array or an int32 tensor), little
    endian, in C order."""
    if isinstance(words, torch.Tensor):
        words = to_numpy_u32(words)
    return hashlib.sha256(np.ascontiguousarray(words, dtype="<u4")
                          .tobytes()).hexdigest()


class _StandInLib:
    """The kernel library's key-switch entries on the CPU: each call is
    recorded and returns 0 (no error); the rule answers ``fits``."""

    def __init__(self, fits=1):
        self.calls, self.fits = [], fits

    def __getattr__(self, name):
        if name == "tfhe_key_switch_fits":
            return lambda *args: self.calls.append((name, args)) or self.fits
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args[3:8])) or 0


@pytest.fixture
def stand_in(monkeypatch):
    """A card without a card: the library, the device guard and the stream
    stand in; the rule's cache and the counts start empty."""
    lib = _StandInLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(keyswitch, "_check", lambda *args: None)
    monkeypatch.setattr(keyswitch, "_fits", {})
    monkeypatch.setattr(tracing, "first_launches", {})
    for name in tracing.key_switch_counts:
        monkeypatch.setitem(tracing.key_switch_counts, name, 0)
    for name in cuda_t.launch_counts:
        monkeypatch.setitem(cuda_t.launch_counts, name, 0)
    return lib


@pytest.fixture(autouse=True)
def counts_zeroed():
    tracing.reset()
    yield
    tracing.reset()


# ---------------------------------------------------------------------------
# On the CPU: the plain path, counted.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["test_fast", "test_pbs"])
def test_on_the_cpu_the_switch_takes_the_plain_path_and_counts_it(
        profile, monkeypatch):
    """CPU tensors never ask the kernel's rule nor launch: each call is
    the plain version's words and one more ``switches``; the launch
    counts, ``key_switch``'s among them, stay as they were."""
    p = tparams.get_params(profile)
    gen = torch.Generator().manual_seed(3)
    table = _table(gen, p.n, p.iks_t, p.basebit, p.lwe_n + 1)
    ct = _ciphertexts(gen, (2, 3), p.n, p.basebit, p.iks_t)
    monkeypatch.setattr(_build, "load_library", lambda: pytest.fail(
        "the CPU path loaded the kernel library"))
    before = dict(cuda_t.launch_counts)
    got = keyswitch.identity_key_switch(p, table, ct)
    assert tracing.key_switch_counts == {"switches": 1}
    want = keyswitch.digit_table_switch_ref(table, ct, p.basebit, p.iks_t)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    keyswitch.digit_table_switch(table, ct[0], p.basebit, p.iks_t)
    assert tracing.key_switch_counts == {"switches": 2}
    assert cuda_t.launch_counts == before


def test_reencrypt_is_counted_as_a_switch_on_the_plain_path():
    p = tparams.get_params("test_fast")
    gen = torch.Generator().manual_seed(4)
    table = _table(gen, p.lwe_n, 5, 3, p.lwe_n + 1)
    rk = proxyreenc.ProxyReencryptionKey(table=table, basebit=3, t=5)
    ct = _ciphertexts(gen, (4,), p.lwe_n, 3, 5)
    got = proxyreenc.reencrypt(rk, ct)
    assert tracing.key_switch_counts == {"switches": 1}
    want = keyswitch.digit_table_switch_ref(table, ct, 3, 5)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


def test_reset_zeroes_the_counts_and_the_snapshot_reports_them(monkeypatch):
    """tracing.reset zeroes the switches; so does cuda_t's reset of the
    launch counts, with the kernel's launches (the share's two counts)."""
    monkeypatch.setitem(tracing.key_switch_counts, "switches", 7)
    monkeypatch.setitem(cuda_t.launch_counts, "key_switch", 5)
    assert tracing.snapshot()["key_switch"] == {"switches": 7}
    assert tracing.snapshot()["launches"]["key_switch"] == 5
    tracing.reset()
    assert tracing.key_switch_counts == {"switches": 0}
    assert tracing.snapshot()["key_switch"] == {"switches": 0}
    monkeypatch.setitem(tracing.key_switch_counts, "switches", 7)
    cuda_t.reset_launch_counts()
    assert tracing.key_switch_counts == {"switches": 0}
    assert cuda_t.launch_counts["key_switch"] == 0


# ---------------------------------------------------------------------------
# A stand-in card: the rule, the dispatch and the launch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fits", [1, 0])
@pytest.mark.parametrize("profile", PROFILES)
def test_each_profiles_shape_goes_to_the_kernels_rule_once(
        stand_in, profile, fits):
    """A card's key switch asks the kernel's rule with the table's n, t,
    basebit and w and the batch over every leading axis, once a shape;
    no profile is named."""
    stand_in.fits = fits
    p = tparams.get_params(profile)
    dev = torch.device("cuda", 0)
    answers = [keyswitch.kernel_fits(dev, p.n, p.iks_t, p.basebit,
                                     p.lwe_n + 1, b) for b in (1, 33, 33,
                                                               2048)]
    assert answers == [bool(fits)] * 4
    assert stand_in.calls == [
        ("tfhe_key_switch_fits", (p.n, p.iks_t, p.basebit, p.lwe_n + 1, b))
        for b in (1, 33, 2048)]


def test_a_failed_card_query_raises_and_is_not_kept(stand_in):
    """Where the kernel's rule could not ask the card (a negative answer:
    minus the CUDA error), the switch raises and keeps no answer, so that
    the next call asks again; it never falls back to the plain path."""
    stand_in.fits = -100
    p = tparams.get_params("uint5")
    dev = torch.device("cuda", 0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="CUDA error 100"):
            keyswitch.kernel_fits(dev, p.n, p.iks_t, p.basebit, p.lwe_n + 1,
                                  1)
    assert len(stand_in.calls) == 2 and keyswitch._fits == {}
    stand_in.fits = 1
    assert keyswitch.kernel_fits(dev, p.n, p.iks_t, p.basebit, p.lwe_n + 1,
                                 1)


def test_the_rule_is_not_asked_off_a_card(stand_in):
    p = tparams.get_params("test_fast")
    table = torch.zeros((p.n, p.iks_t, p.base, p.lwe_n + 1),
                        dtype=torch.int32)
    for device in ("cpu", "meta"):
        ct = torch.zeros((3, p.n + 1), dtype=torch.int32, device=device)
        assert not keyswitch.takes_kernel(table.to(device), ct, p.basebit,
                                          p.iks_t)
    assert stand_in.calls == []


@pytest.mark.parametrize("lead", [(1,), (5,), (2, 3)])
def test_a_kernel_launch_counts_as_a_kernel_switch_not_as_a_rotation_kernel(
        stand_in, lead):
    """One ``tfhe_key_switch`` launch with the table's n, t, basebit, w
    and the batch over the leading axes; a new (..., w) tensor; counted
    under ``launch_counts["key_switch"]`` and under no rotation kernel's
    name; the transient bytes are the output's."""
    p = tparams.get_params("uint5")
    w = p.lwe_n + 1
    table = torch.empty((p.n, p.iks_t, p.base, w), dtype=torch.int32,
                        device="meta")
    ct = torch.empty(lead + (p.n + 1,), dtype=torch.int32, device="meta")
    b = ct.numel() // (p.n + 1)
    out = keyswitch.switch_kernel(table, ct, p.basebit, p.iks_t)
    assert out.shape == lead + (w,) and out.dtype == torch.int32
    assert stand_in.calls == [("tfhe_key_switch",
                               (p.n, p.iks_t, p.basebit, w, b))]
    assert tracing.key_switch_counts == {"switches": 0}
    assert cuda_t.launch_counts == dict(
        dict.fromkeys(cuda_t.launch_counts, 0), key_switch=1)
    assert tracing.snapshot()["peaks"] == {
        "key_switch.transient_bytes": 4 * b * w}


@pytest.mark.parametrize("kernel", [True, False])
def test_the_switch_runs_what_the_rule_chooses(monkeypatch, kernel):
    """Where the rule says so (forced here on the CPU) the kernel's
    launcher runs and the plain version does not; else the plain version.
    Every call counts as a switch."""
    p = tparams.get_params("test_fast")
    gen = torch.Generator().manual_seed(5)
    table = _table(gen, p.n, p.iks_t, p.basebit, p.lwe_n + 1)
    ct = _ciphertexts(gen, (3,), p.n, p.basebit, p.iks_t)
    calls = []
    plain = keyswitch.digit_table_switch_ref
    monkeypatch.setattr(keyswitch, "takes_kernel", lambda *a: kernel)
    monkeypatch.setattr(keyswitch, "switch_kernel",
                        lambda *a: calls.append("kernel") or plain(*a))
    monkeypatch.setattr(keyswitch, "digit_table_switch_ref",
                        lambda *a: calls.append("plain") or plain(*a))
    got = keyswitch.digit_table_switch(table, ct, p.basebit, p.iks_t)
    assert calls == ["kernel" if kernel else "plain"]
    assert tracing.key_switch_counts["switches"] == 1
    np.testing.assert_array_equal(
        to_numpy_u32(got), to_numpy_u32(plain(table, ct, p.basebit,
                                              p.iks_t)))


def test_plain_runs_the_plain_version_whatever_the_rule(monkeypatch):
    """``plain`` (the engine's plain path, its portable routes) runs the
    plain version and never asks the rule; the call counts as a switch."""
    p = tparams.get_params("test_fast")
    gen = torch.Generator().manual_seed(6)
    table = _table(gen, p.n, p.iks_t, p.basebit, p.lwe_n + 1)
    ct = _ciphertexts(gen, (2,), p.n, p.basebit, p.iks_t)
    monkeypatch.setattr(keyswitch, "takes_kernel", lambda *a: pytest.fail(
        "the plain switch asked the kernel's rule"))
    monkeypatch.setattr(keyswitch, "switch_kernel", lambda *a: pytest.fail(
        "the plain switch launched the kernel"))
    got = keyswitch.identity_key_switch(p, table, ct, plain=True)
    assert tracing.key_switch_counts == {"switches": 1}
    want = keyswitch.digit_table_switch_ref(table, ct, p.basebit, p.iks_t)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


@pytest.mark.parametrize("route, plain, want", [
    (None, False, False), (None, True, True),
    ("blind_rotate", False, True), ("blind_rotate_t", True, True)])
def test_the_engine_asks_for_the_plain_switch_on_plain_and_portable_paths(
        monkeypatch, route, plain, want):
    """engine._bootstrap's key switch is the plain version on its plain
    path and on the portable routes (which launch no kernel), else the
    kernel's where the rule takes the shape."""
    p = tparams.get_params("test_fast")
    gen = torch.Generator().manual_seed(8)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    ct = _ciphertexts(gen, (3,), p.lwe_n, p.basebit, p.iks_t)
    seen = []
    switch = keyswitch.identity_key_switch

    def spy(p_, ksk, lv1, plain=False):
        seen.append(plain)
        return switch(p_, ksk, lv1, plain)
    monkeypatch.setattr(engine, "identity_key_switch", spy)
    out = engine._bootstrap(ck, ct, None, True, plain=plain, route=route)
    assert seen == [want] and out.shape == (3, p.lwe_n + 1)


# ---------------------------------------------------------------------------
# The benchmark's reader.
# ---------------------------------------------------------------------------

def test_the_reader_reads_the_share_of_switches_that_took_the_kernel(
        monkeypatch):
    """100 x launch_counts["key_switch"] / switches; None where no switch
    ran."""
    reader = _reader()
    counts = tracing.key_switch_counts
    monkeypatch.setitem(counts, "switches", 0)
    assert reader.read({}) is None
    monkeypatch.setitem(counts, "switches", 40)
    monkeypatch.setitem(cuda_t.launch_counts, "key_switch", 40)
    assert reader.read({}) == 100.0
    monkeypatch.setitem(cuda_t.launch_counts, "key_switch", 10)
    assert reader.read({}) == 25.0
    monkeypatch.setitem(cuda_t.launch_counts, "key_switch", 0)
    assert reader.read({}) == 0.0


def test_the_reader_reads_nothing_from_a_program_without_the_counter(
        monkeypatch):
    """A program whose recorder keeps no key-switch counts or counts no
    key-switch launches (one whose key switch has no kernel), or whose
    recorder cannot be imported."""
    reader = _reader()
    monkeypatch.setitem(tracing.key_switch_counts, "switches", 3)
    monkeypatch.setitem(cuda_t.launch_counts, "key_switch", 3)
    assert reader.read({}) == 100.0
    monkeypatch.delitem(cuda_t.launch_counts, "key_switch")
    assert reader.read({}) is None
    monkeypatch.setitem(cuda_t.launch_counts, "key_switch", 3)
    monkeypatch.delattr(tracing, "key_switch_counts")
    assert reader.read({}) is None
    monkeypatch.setitem(sys.modules, "go_tfhe_tpu_torch.utils.tracing", None)
    assert reader.read({}) is None


# ---------------------------------------------------------------------------
# On the card: the kernel against the plain version, word for word.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


_tables: dict = {}


def _card_table(profile, device):
    """One profile's random table (zero digit-0 rows) on the card, kept
    for the cases that follow; the previous profile's is dropped."""
    if profile not in _tables:
        _tables.clear()
        p = tparams.get_params(profile)
        gen = torch.Generator(device=device).manual_seed(len(profile))
        table = torch.randint(-2 ** 31, 2 ** 31,
                              (p.n, p.iks_t, p.base, p.lwe_n + 1),
                              dtype=torch.int32, generator=gen,
                              device=device)
        table[:, :, 0, :] = 0
        _tables[profile] = table
    return _tables[profile]


def _check_against_plain(table, ct, basebit, t):
    """The switch on the card launches the kernel once and gives the
    plain version's words."""
    switches = tracing.key_switch_counts["switches"]
    launches = cuda_t.launch_counts["key_switch"]
    got = keyswitch.digit_table_switch(table, ct, basebit, t)
    torch.cuda.synchronize()
    assert tracing.key_switch_counts["switches"] == switches + 1
    assert cuda_t.launch_counts["key_switch"] == launches + 1
    want = keyswitch.digit_table_switch_ref(table, ct, basebit, t)
    assert got.shape == ct.shape[:-1] + (table.shape[-1],)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


@pytest.mark.gpu
@pytest.mark.parametrize("b", sorted(BATCHES))
@pytest.mark.parametrize("profile", PROFILES)
def test_the_kernel_equals_the_plain_path_on_gpu(cuda_device, profile, b):
    """At the profile's KSK shape, a random table with zero digit-0 rows,
    B ciphertexts over leading axes (both tilings: rows from device
    memory at small B, staged slabs at large B), the edge words among the
    inputs."""
    p = tparams.get_params(profile)
    table = _card_table(profile, cuda_device)
    gen = torch.Generator().manual_seed(b)
    ct = _ciphertexts(gen, BATCHES[b], p.n, p.basebit, p.iks_t, cuda_device)
    _check_against_plain(table, ct, p.basebit, p.iks_t)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 33, 2048])
@pytest.mark.parametrize("profile", ["test_fast", "test_pbs", "128bit",
                                     "uint5"])
def test_the_kernel_equals_the_plain_path_on_a_keygen_ksk_on_gpu(
        cuda_device, profile, b):
    """The KSK that keygen makes on the card (keys.gen_ksk) and
    ciphertexts of edge and random words."""
    p = tparams.get_params(profile)
    _tables.clear()
    gen = torch.Generator(device=cuda_device).manual_seed(b + 7)
    sk = keys.gen_secret_key(gen, p, cuda_device)
    ksk = keys.gen_ksk(gen, p, sk)
    ct = _ciphertexts(torch.Generator().manual_seed(b), (b,), p.n,
                      p.basebit, p.iks_t, cuda_device)
    _check_against_plain(ksk, ct, p.basebit, p.iks_t)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4, 4096])
def test_reencrypt_runs_the_kernel_at_its_table_shape_on_gpu(cuda_device,
                                                             b):
    """proxyreenc.reencrypt's table (n = lwe_n, w = lwe_n + 1) at
    128bit_fast's level 0, random words with zero digit-0 rows: the
    kernel's words equal the plain version's."""
    p = tparams.get_params("128bit_fast")
    _tables.clear()
    gen = torch.Generator().manual_seed(b)
    table = _table(gen, p.lwe_n, p.iks_t, p.basebit, p.lwe_n + 1,
                   cuda_device)
    rk = proxyreenc.ProxyReencryptionKey(table=table, basebit=p.basebit,
                                         t=p.iks_t)
    ct = _ciphertexts(gen, (b,), p.lwe_n, p.basebit, p.iks_t, cuda_device)
    before = cuda_t.launch_counts["key_switch"]
    got = proxyreenc.reencrypt(rk, ct)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["key_switch"] == before + 1
    want = keyswitch.digit_table_switch_ref(table, ct, p.basebit, p.iks_t)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


@pytest.mark.gpu
def test_the_kernel_sums_the_digit_0_rows_too_on_gpu(cuda_device):
    """A table whose digit-0 rows are not zero: the kernel, like the plain
    version, sums every (i, j) term it picks, digit 0 included."""
    p = tparams.get_params("test_pbs")
    _tables.clear()
    gen = torch.Generator().manual_seed(11)
    table = _words(gen, (p.n, p.iks_t, p.base, p.lwe_n + 1), cuda_device)
    for b in (1, 300):
        ct = _ciphertexts(gen, (b,), p.n, p.basebit, p.iks_t, cuda_device)
        _check_against_plain(table, ct, p.basebit, p.iks_t)


@pytest.mark.gpu
@pytest.mark.parametrize("profile", sorted(JAX_WORDS_SHA256))
def test_the_card_switch_gives_the_jax_packages_words_on_gpu(cuda_device,
                                                             profile):
    """identity_key_switch on the card, through the kernel, gives the
    words that the JAX package's identity_key_switch gives on the same KSK
    and ciphertexts (recorded as their sha256, JAX_WORDS_SHA256)."""
    p, ksk, ct = jax_case(profile)
    _tables.clear()
    before = cuda_t.launch_counts["key_switch"]
    got = keyswitch.identity_key_switch(p, from_numpy_u32(ksk, cuda_device),
                                        from_numpy_u32(ct, cuda_device))
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["key_switch"] == before + 1
    assert got.shape == (2, 3, p.lwe_n + 1)
    assert words_sha256(got) == JAX_WORDS_SHA256[profile]
