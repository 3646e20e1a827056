"""The blind rotation's fused step at small batches (ops/cuda_t.step_t_small,
csrc/step_t_small.cu: K1's rotate and decompose made inside K2's small
form, one launch a step).  Its rule, its counts, the route's choice and
the benchmark's reader of its counter
(``benchmark/metrics/rotation.fused_step_share.py``) on the CPU; the
kernel against K1 then K2 and the plain pair on the card (``gpu`` cases,
which skip without one):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_step_t_small.py
"""

import contextlib
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import params as tparams  # noqa: E402
from go_tfhe_tpu_torch.ops import _build, blindrotate, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.utils import tracing  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import to_numpy_u32  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = cuda_t.SMALL_BATCH_MAX
FUSED = cuda_t.FUSED_BATCH_MAX
# Every profile that blind_rotate_t serves (poly_extend_factor 1).
K1_PROFILES = ("128bit", "128bit_fast", "80bit_fast", "110bit_fast",
               "uint1", "uint2", "uint3", "uint4", "uint5")
_BASE = dict(lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
             lv1_alpha=1.0 / (1 << 30), nbit=8, basebit=4, iks_t=6,
             block_size=1)
# K1's three digit shapes at N 256 (tests/test_torch_kernels_t.py's).
CONFIGS = {
    "bg8_l2_lo1": tparams.TFHEParams(
        name="t_bg8_lo1", bgbit=8, l=2, kernel_limb_drop=1, key_grid_bits=8,
        centered_decomposition=True, **_BASE),
    "bg6_l3": tparams.TFHEParams(name="t_bg6", bgbit=6, l=3, **_BASE),
    "bg18_l1_nd3": tparams.TFHEParams(name="t_bg18", bgbit=18, l=1,
                                      message_modulus=8, **_BASE),
}


def _reader():
    path = os.path.join(ROOT, "benchmark", "metrics",
                        "rotation.fused_step_share.py")
    spec = importlib.util.spec_from_file_location("fused_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


def _words(gen, shape, device="cpu"):
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                         generator=gen).to(torch.int32).to(device)


def _amounts(n, b, gen, device="cpu"):
    """B amounts in [0, 2N], the first of them 0, 1, N - 1, N, N + 1,
    2N - 1 and 2N: every wrap and flip of the rotation."""
    amounts = torch.randint(0, 2 * n + 1, (b,), dtype=torch.int32,
                            generator=gen)
    edges = torch.tensor([0, 1, n - 1, n, n + 1, 2 * n - 1, 2 * n],
                         dtype=torch.int32)[:b]
    amounts[:len(edges)] = edges
    return amounts.to(device)


class _StandInLib:
    """The kernel library's entries on the CPU: each call is recorded and
    returns 0 (no error); ``tfhe_step_t_small_fits`` answers ``fits``."""

    def __init__(self, fits=1):
        self.calls, self.fits = [], fits

    def __getattr__(self, name):
        if name == "tfhe_step_t_small_fits":
            return lambda *args: self.calls.append((name, args)) or self.fits
        return lambda *args: self.calls.append((name, args[4:9])) or 0


@pytest.fixture
def stand_in(monkeypatch):
    """A card without a card: the library, the device guard and the stream
    stand in, the fit rule's cache and the launch counts start empty."""
    lib = _StandInLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_t, "_check", lambda *args: None)
    monkeypatch.setattr(cuda_t, "_fused_fits", {})
    monkeypatch.setattr(tracing, "first_launches", {})
    for name in cuda_t.launch_counts:
        monkeypatch.setitem(cuda_t.launch_counts, name, 0)
    return lib


# ---------------------------------------------------------------------------
# The rule.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,b,fits,engages", [
    ("cuda", 1, 1, True),
    ("cuda", 2, 1, True),
    ("cuda", 3, 1, True),
    ("cuda", FUSED, 1, True),
    ("cuda", FUSED + 1, 1, False),
    ("cuda", TOP, 1, False),
    ("cuda", TOP + 1, 1, False),
    ("cuda", 4096, 1, False),
    ("cuda", 1, 0, False),
    ("cuda", FUSED, 0, False),
    ("cpu", 1, 1, False),
    ("cpu", TOP + 1, 1, False),
])
def test_the_fused_step_is_chosen_on_a_card_at_small_batches(
        stand_in, device, b, fits, engages):
    """A card, B <= FUSED_BATCH_MAX (within K2's small form), and the
    kernel's own fit rule; the rule is asked once a shape, and never off a
    card or above FUSED_BATCH_MAX."""
    assert FUSED <= TOP
    stand_in.fits = fits
    p = tparams.get_params("128bit")
    dev = torch.device(device)
    for _ in range(2):
        assert cuda_t.takes_fused_step(dev, p, b) is engages
    asked = device == "cuda" and b <= FUSED
    assert stand_in.calls == ([("tfhe_step_t_small_fits",
                                (p.n, b, p.l, p.bgbit))] if asked else [])


@pytest.mark.parametrize("fits", [1, 0])
@pytest.mark.parametrize("profile", K1_PROFILES)
def test_every_k1_profile_takes_the_fused_step_or_falls_back_by_the_rule(
        stand_in, profile, fits):
    """Each profile's shapes go to the kernel's rule: the fused step where
    it takes them, K1 + K2 where it refuses; no profile is named."""
    stand_in.fits = fits
    p = tparams.get_params(profile)
    assert p.poly_extend_factor == 1 and p.l * p.bgbit <= 32
    dev = torch.device("cuda", 0)
    assert [cuda_t.takes_fused_step(dev, p, b) for b in (1, 2, FUSED)] == \
        [bool(fits)] * 3
    assert stand_in.calls == [("tfhe_step_t_small_fits",
                               (p.n, b, p.l, p.bgbit)) for b in (1, 2, FUSED)]


# ---------------------------------------------------------------------------
# The wrapper and its counts.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 5, TOP])
def test_a_fused_launch_counts_as_a_small_form_k2_and_not_as_k1(stand_in,
                                                                b):
    """One launch of ``tfhe_step_t_small`` with the profile's L, bgbit and
    decomposition offset, counted under ``step_t_small``, ``extprod_t``
    and ``extprod_t_small``, and not under ``rotate_decompose_t``; a new
    tensor of the accumulator's shape."""
    p = tparams.get_params("uint5")
    acc = torch.empty((2, p.n, b), dtype=torch.int32, device="meta")
    amounts = torch.empty((b,), dtype=torch.int32, device="meta")
    band = torch.empty((2, 2 * p.l, 2 * p.n), dtype=torch.int32,
                       device="meta")
    out = cuda_t.step_t_small(p, acc, amounts, band)
    assert out.shape == acc.shape and out is not acc
    assert stand_in.calls == [("tfhe_step_t_small",
                               (p.n, b, p.l, p.bgbit,
                                p.decomposition_offset))]
    added = {k: v for k, v in cuda_t.launch_counts.items() if v}
    assert added == {"step_t_small": 1, "extprod_t": 1, "extprod_t_small": 1}


def test_the_fused_launches_are_sub_counts():
    """``step_t_small`` is no kernel of its own in a total: it and
    ``extprod_t_small`` are the recorder's sub-counts."""
    assert set(tracing.SUB_COUNTS) == {"extprod_t_small", "step_t_small"}
    assert set(tracing.SUB_COUNTS) <= set(tracing.launch_counts)


@pytest.mark.parametrize("b", [1, 3, 7])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_the_cpu_fused_step_is_the_plain_pair_and_counts_nothing(cfg, b):
    """On CPU tensors the wrapper runs K1's plain version then K2's, with
    the edge amounts, and launches nothing; acc is left as it was."""
    p = CONFIGS[cfg]
    gen = torch.Generator().manual_seed(23)
    lo, nd = cuda_t.band_limb_drop(p), p.digit_limbs
    acc = _words(gen, (2, p.n, b))
    amounts = _amounts(p.n, b, gen)
    band = cuda_t.pack_bsk_band_t(_words(gen, (1, 2 * p.l, 2, p.n)), lo)[0]
    kept = acc.clone()
    before = dict(cuda_t.launch_counts)
    got = cuda_t.step_t_small(p, acc, amounts, band)
    want = cuda_t.extprod_t_ref(cuda_t.rotate_decompose_t_ref(p, acc,
                                                              amounts),
                                band, acc, nd, lo)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    assert torch.equal(acc, kept)
    assert cuda_t.launch_counts == before


# ---------------------------------------------------------------------------
# The route's choice.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fast_key():
    p = tparams.get_params("test_fast")
    gen = torch.Generator().manual_seed(24)
    bsk = _words(gen, (p.lwe_n, 2 * p.l, 2, p.n))
    return p, cuda_t.pack_bsk_band_t(bsk, cuda_t.band_limb_drop(p)), gen


@pytest.mark.parametrize("fused", [True, False])
def test_blind_rotate_t_runs_what_the_rule_chooses(fast_key, monkeypatch,
                                                   fused):
    """Where the rule says so (forced here on the CPU), each step is one
    call of the route's fused step and K1 and K2 are not called; else K1
    then K2 a step.  The rule is asked once a rotation, with the
    accumulator's device, the profile and the batch; both ways give the
    plain versions' words."""
    p, bands, gen = fast_key
    b = 3
    ct = _words(gen, (b, p.lwe_n + 1))
    tv = _words(gen, (2, p.n))
    want = blindrotate.blind_rotate_t(p, bands, ct, tv, plain=True)
    calls, asked = [], []
    entry = blindrotate.ROUTES["blind_rotate_t"]

    def spy(name, fn):
        def call(*args):
            calls.append(name)
            return fn(*args)
        return call

    kernels = tuple(spy(name, fn) for name, fn in
                    zip(("k1", "k2", "step"), entry.kernels))
    monkeypatch.setitem(blindrotate.ROUTES, "blind_rotate_t",
                        entry._replace(kernels=kernels))
    monkeypatch.setattr(blindrotate, "takes_fused_step",
                        lambda dev, p_, b_: asked.append((dev, p_, b_))
                        or fused)
    got = blindrotate.blind_rotate_t(p, bands, ct, tv)
    assert asked == [(torch.device("cpu"), p, b)]
    if fused:
        assert calls == ["step"] * p.lwe_n
    else:
        assert calls == ["k1", "k2"] * p.lwe_n
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


def test_the_route_holds_the_fused_step_and_its_plain_version():
    """blind_rotate_t's kernels end with the fused step, its plain
    versions with the fused step's plain version (K1's, then K2's); no
    other route has it."""
    entry = blindrotate.ROUTES["blind_rotate_t"]
    assert entry.kernels[-1] is cuda_t.step_t_small
    assert entry.plain[-1] is cuda_t.step_t_small_ref
    for name, route in blindrotate.ROUTES.items():
        if name != "blind_rotate_t":
            assert cuda_t.step_t_small not in route.kernels, name


# ---------------------------------------------------------------------------
# The benchmark's reader.
# ---------------------------------------------------------------------------

def test_the_reader_reads_the_share_of_fused_steps(monkeypatch):
    """100 x step_t_small / (step_t_small + rotate_decompose_t); None
    where neither launched."""
    reader = _reader()
    counts = cuda_t.launch_counts
    monkeypatch.setitem(counts, "step_t_small", 700)
    monkeypatch.setitem(counts, "rotate_decompose_t", 0)
    assert reader.read({}) == 100.0
    monkeypatch.setitem(counts, "rotate_decompose_t", 2100)
    assert reader.read({}) == 25.0
    monkeypatch.setitem(counts, "step_t_small", 0)
    assert reader.read({}) == 0.0
    monkeypatch.setitem(counts, "rotate_decompose_t", 0)
    assert reader.read({}) is None


def test_the_reader_reads_nothing_from_a_program_without_the_counter(
        monkeypatch):
    """A program that launches K1 apart at every batch has no
    ``step_t_small`` count; one whose module cannot be imported gives
    nothing either."""
    reader = _reader()
    monkeypatch.setitem(cuda_t.launch_counts, "rotate_decompose_t", 700)
    monkeypatch.delitem(cuda_t.launch_counts, "step_t_small")
    assert reader.read({}) is None
    monkeypatch.setitem(sys.modules, "go_tfhe_tpu_torch.ops.cuda_t", None)
    assert reader.read({}) is None


# ---------------------------------------------------------------------------
# On the card: the kernel against K1 then K2 and the plain pair.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 16, 31, 32])
@pytest.mark.parametrize("profile", ["128bit", "128bit_fast", "uint4",
                                     "uint5"])
def test_fused_step_equals_k1_k2_and_plain_on_gpu(cuda_device, profile, b):
    """At the profile's own N, L, bgbit and ND, batches that are and are
    not multiples of 4, amounts 0, 1, N - 1, N, N + 1, 2N - 1 and 2N among
    them: the fused step's words equal K1 then K2 (its small form) and the
    plain pair's, one launch counted as a small-form K2 and not as K1, and
    acc is left as it was.  The kernel takes every batch of the small
    form; the rotation takes it up to FUSED_BATCH_MAX."""
    p = tparams.get_params(profile)
    gen = torch.Generator().manual_seed(b)
    lo, nd = cuda_t.band_limb_drop(p), p.digit_limbs
    acc = _words(gen, (2, p.n, b), cuda_device)
    amounts = _amounts(p.n, b, gen, cuda_device)
    band = cuda_t.pack_bsk_band_t(
        _words(gen, (1, 2 * p.l, 2, p.n), cuda_device), lo)[0].contiguous()
    kept = acc.clone()
    assert cuda_t.takes_fused_step(cuda_device, p, b) == (b <= FUSED)
    before = dict(cuda_t.launch_counts)
    fused = cuda_t.step_t_small(p, acc, amounts, band)
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in cuda_t.launch_counts.items()
             if v != before[k]}
    assert added == {"step_t_small": 1, "extprod_t": 1, "extprod_t_small": 1}
    pair = cuda_t.extprod_t(cuda_t.rotate_decompose_t(p, acc, amounts), band,
                            acc, nd, lo)
    plain = cuda_t.step_t_small_ref(p, acc, amounts, band)
    assert torch.equal(acc, kept)
    np.testing.assert_array_equal(to_numpy_u32(fused), to_numpy_u32(pair))
    np.testing.assert_array_equal(to_numpy_u32(fused), to_numpy_u32(plain))


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_fused_step_on_a_key_of_extreme_words_on_gpu(cuda_device, cfg):
    """Band words whose every balanced limb is -128 (0x7F7F7F80) and an
    accumulator of the words 0, 2^31 and 2^32 - 1: the fused step's
    wrapping u32 products equal the plain pair's."""
    p = CONFIGS[cfg]
    b = 5
    gen = torch.Generator().manual_seed(25)
    band = torch.full((2, 2 * p.l, 2 * p.n), 0x7F7F7F80, dtype=torch.int64,
                      device=cuda_device).to(torch.int32)
    words = torch.tensor([0, -2 ** 31, -1], dtype=torch.int32)
    acc = words[torch.randint(0, 3, (2, p.n, b), generator=gen)].to(
        cuda_device)
    amounts = _amounts(p.n, b, gen, cuda_device)
    fused = cuda_t.step_t_small(p, acc, amounts, band)
    plain = cuda_t.step_t_small_ref(p, acc, amounts, band)
    np.testing.assert_array_equal(to_numpy_u32(fused), to_numpy_u32(plain))
