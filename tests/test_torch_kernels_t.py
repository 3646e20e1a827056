"""The blind-rotation step kernels (ops/cuda_t.py) against the JAX
package's Pallas kernels (ops/pallas_t.py, run in interpret mode).

On the CPU the port's wrappers run the kernels' plain versions, so the
CPU cases hold the plain versions bit for bit against the TPU kernels; the
``gpu`` cases hold the Hopper kernels against the plain versions on the
card and skip without one.  JAX is imported only by the cases that use it,
so the ``gpu`` cases also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_t.py
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, gates, keys  # noqa: E402
from go_tfhe_tpu_torch import params as tparams  # noqa: E402
from go_tfhe_tpu_torch.ops import _build, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.ops.blindrotate import blind_rotate_t  # noqa: E402
from go_tfhe_tpu_torch.utils import tracing  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

_BASE = dict(lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
             lv1_alpha=1.0 / (1 << 30), nbit=8, basebit=4, iks_t=6,
             block_size=1)
# The three digit shapes of the kernels at N = 256: the 128bit_fast gadget
# (centered, on-grid key, lowest key limb dropped), the reference 128-bit
# gadget, and wide digits split into three limbs (the Uint2-5 shape).
CONFIGS = {
    "bg8_l2_lo1": tparams.TFHEParams(
        name="t_bg8_lo1", bgbit=8, l=2, kernel_limb_drop=1, key_grid_bits=8,
        centered_decomposition=True, **_BASE),
    "bg6_l3": tparams.TFHEParams(name="t_bg6", bgbit=6, l=3, **_BASE),
    "bg18_l1_nd3": tparams.TFHEParams(name="t_bg18", bgbit=18, l=1,
                                      message_modulus=8, **_BASE),
}


# (N, 2L, ND) of K2 at the profiles on the benchmark's path.
PROFILE_SHAPES = {"128bit": (1024, 6, 1), "uint5": (2048, 2, 3)}


@pytest.fixture(scope="module")
def jx():
    """The JAX side, with the Pallas kernels in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from go_tfhe_tpu.ops import pallas_t
    pallas_t.INTERPRET = True
    import go_tfhe_tpu
    from go_tfhe_tpu.ops.blindrotate import blind_rotate_t as j_blind_rotate_t
    return types.SimpleNamespace(jax=jax, jnp=jnp, pallas_t=pallas_t,
                                 tfhe=go_tfhe_tpu,
                                 blind_rotate_t=j_blind_rotate_t)


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _inputs(p, b, seed):
    rng = np.random.default_rng(seed)
    acc = _u32(rng, (2, p.n, b))
    amounts = rng.integers(0, 2 * p.n + 1, b).astype(np.int32)
    amounts[:2] = [0, 2 * p.n][:b]
    bsk = _u32(rng, (1, 2 * p.l, 2, p.n))
    return acc, amounts, bsk


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_rotate_decompose_ref_matches_pallas(jx, cfg):
    p = CONFIGS[cfg]
    acc, amounts, _ = _inputs(p, 8, 1)
    want = np.asarray(jx.pallas_t.rotate_decompose_t(
        _jparams(jx, p), jx.jnp.asarray(acc), jx.jnp.asarray(amounts), tb=8))
    got = cuda_t.rotate_decompose_t_ref(p, from_numpy_u32(acc, "cpu"),
                                        torch.from_numpy(amounts))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("on_grid", [True, False])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_extprod_ref_matches_pallas(jx, cfg, on_grid):
    """Off the key grid the dropped limb is not zero; the band packing
    folds the drop in, so the plain K2 still equals the TPU kernel."""
    p = CONFIGS[cfg]
    acc, amounts, bsk = _inputs(p, 8, 2)
    if on_grid:
        bsk &= np.uint32(0xFFFFFF00)
    lo, nd = cuda_t.band_limb_drop(p), p.digit_limbs
    jnp, pallas_t = jx.jnp, jx.pallas_t
    digits = np.asarray(pallas_t.rotate_decompose_t(
        _jparams(jx, p), jnp.asarray(acc), jnp.asarray(amounts), tb=8))
    band_rev = pallas_t.pack_bsk_band_rev(jnp.asarray(bsk))[0]
    want = np.asarray(pallas_t.extprod_t(
        jnp.asarray(digits), band_rev, jnp.asarray(acc),
        limb_mag=min(p.half_bg, 128), tb=8, lo=lo, nd=nd))
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"), lo)[0]
    got = cuda_t.extprod_t_ref(torch.from_numpy(digits.copy()), band,
                               from_numpy_u32(acc, "cpu"), nd)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_band_limb_drop_is_identity_on_grid():
    rng = np.random.default_rng(3)
    bsk = from_numpy_u32(_u32(rng, (2, 4, 2, 64)) & np.uint32(0xFFFFFF00),
                         "cpu")
    np.testing.assert_array_equal(cuda_t.pack_bsk_band_t(bsk, 1).numpy(),
                                  cuda_t.pack_bsk_band_t(bsk, 0).numpy())


@pytest.mark.parametrize("cfg", ["bg8_l2_lo1", "bg18_l1_nd3"])
def test_blind_rotate_t_matches_jax(jx, cfg):
    """The port's blind rotation == JAX blind_rotate_t on the same key."""
    p = CONFIGS[cfg]
    jp = _jparams(jx, p)
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(5))
    sk = jx.tfhe.gen_secret_key(k1, jp)
    ck = jx.tfhe.gen_cloud_key(k2, sk, jp)
    rng = np.random.default_rng(4)
    ct = _u32(rng, (8, p.lwe_n + 1))
    want = np.asarray(jx.blind_rotate_t(jp, ck.bsk_band_rev,
                                        jx.jnp.asarray(ct), ck.testvec, tb=8))
    tck = keys.cloud_key_from_numpy(p, np.asarray(ck.testvec),
                                    np.asarray(ck.ksk), np.asarray(ck.bsk),
                                    device="cpu")
    got = blind_rotate_t(p, tck.bands, from_numpy_u32(ct, "cpu"),
                         tck.testvec)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_cpu_wrappers_run_plain_and_count_nothing():
    p = CONFIGS["bg8_l2_lo1"]
    acc, amounts, bsk = _inputs(p, 4, 6)
    acc_t, am_t = from_numpy_u32(acc, "cpu"), torch.from_numpy(amounts)
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"), 1)[0]
    cuda_t.reset_launch_counts()
    d = cuda_t.rotate_decompose_t(p, acc_t, am_t)
    np.testing.assert_array_equal(
        d.numpy(), cuda_t.rotate_decompose_t_ref(p, acc_t, am_t).numpy())
    out = cuda_t.extprod_t(d, band, acc_t)
    np.testing.assert_array_equal(
        out.numpy(), cuda_t.extprod_t_ref(d, band, acc_t).numpy())
    assert cuda_t.launch_counts == dict.fromkeys(cuda_t.launch_counts, 0)


def test_cpu_wrapper_at_batch_one_runs_plain_and_counts_nothing():
    """B 1, which takes K2's small form on a card, runs the plain version
    on the CPU and counts no launch of either form."""
    p = CONFIGS["bg18_l1_nd3"]
    acc, amounts, bsk = _inputs(p, 1, 9)
    acc_t, am_t = from_numpy_u32(acc, "cpu"), torch.from_numpy(amounts)
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"))[0]
    nd = p.digit_limbs
    assert cuda_t.takes_small_form(1)
    cuda_t.reset_launch_counts()
    d = cuda_t.rotate_decompose_t(p, acc_t, am_t)
    out = cuda_t.extprod_t(d, band, acc_t, nd)
    np.testing.assert_array_equal(
        out.numpy(), cuda_t.extprod_t_ref(d, band, acc_t, nd).numpy())
    assert cuda_t.launch_counts == dict.fromkeys(cuda_t.launch_counts, 0)


@pytest.mark.parametrize("profile", sorted(PROFILE_SHAPES))
def test_small_form_is_chosen_from_the_shapes(profile):
    """The profile's K2 calls take the small form up to
    ``SMALL_BATCH_MAX`` ciphertexts and the tile above it, whatever their
    N, 2L and ND."""
    n, l2, nd = PROFILE_SHAPES[profile]
    p = tparams.get_params(profile)
    assert (p.n, 2 * p.l, p.digit_limbs) == (n, l2, nd)
    top = cuda_t.SMALL_BATCH_MAX
    for b in (1, 2, 3, top):
        assert cuda_t.takes_small_form(b), b
    for b in (top + 1, 2048, 4096):
        assert not cuda_t.takes_small_form(b), b


class _StandInLib:
    """The kernel library's entries on the CPU: each call is recorded and
    returns 0 (no error); ``tfhe_extprod_t_small_fits`` answers ``fits``."""

    def __init__(self, fits):
        self.calls, self.fits = [], fits

    def __getattr__(self, name):
        if name == "tfhe_extprod_t_small_fits":
            return lambda *args: self.calls.append((name, args)) or self.fits
        return lambda *args: self.calls.append((name, args[4:9])) or 0


def _k2_on_stand_in(monkeypatch, lib, batches, shapes=(1024, 6, 1)):
    """K2's wrapper at ``batches`` as on a card, launching into ``lib``."""
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_t, "_check", lambda *args: None)
    monkeypatch.setattr(cuda_t, "_small_fits", {})
    monkeypatch.setattr(tracing, "first_launches", {})
    for name in ("extprod_t", "extprod_t_small"):
        monkeypatch.setitem(cuda_t.launch_counts, name, 0)
    n, l2, nd = shapes
    for b in batches:
        acc = torch.empty((2, n, b), dtype=torch.int32, device="meta")
        band = torch.empty((2, l2, 2 * n), dtype=torch.int32, device="meta")
        digits = torch.empty((nd * l2 * n, b), dtype=torch.int8,
                             device="meta")
        cuda_t.extprod_t(digits, band, acc, nd)


def test_k2_launches_the_form_its_shapes_choose(monkeypatch):
    """The wrapper on a card (a stand-in library here): the small form's
    entry at B 1 and at ``SMALL_BATCH_MAX``, the tile's above; every launch
    counts under ``extprod_t``, the small form's also under
    ``extprod_t_small``; the kernel's rule is asked once a shape, and not
    for a batch above the crossover."""
    lib = _StandInLib(1)
    top = cuda_t.SMALL_BATCH_MAX
    _k2_on_stand_in(monkeypatch, lib, (1, top, 1, top + 1))
    assert lib.calls == [
        ("tfhe_extprod_t_small_fits", (1024, 1, 6, 1)),
        ("tfhe_extprod_t_small", (1024, 1, 6, 1, 0)),
        ("tfhe_extprod_t_small_fits", (1024, top, 6, 1)),
        ("tfhe_extprod_t_small", (1024, top, 6, 1, 0)),
        ("tfhe_extprod_t_small", (1024, 1, 6, 1, 0)),
        ("tfhe_extprod_t", (1024, top + 1, 6, 1, 0))]
    assert cuda_t.launch_counts["extprod_t"] == 4
    assert cuda_t.launch_counts["extprod_t_small"] == 3


def test_small_form_needs_a_block_that_fits(monkeypatch):
    """Where the kernel's rule (``tfhe_extprod_t_small_fits``: its block's
    shared memory within the card's) refuses the shapes, batches of 1 and
    2 launch the tile, counted under ``extprod_t`` only."""
    for n, l2, nd in PROFILE_SHAPES.values():
        lib = _StandInLib(0)
        _k2_on_stand_in(monkeypatch, lib, (1, 2), (n, l2, nd))
        assert lib.calls == [
            ("tfhe_extprod_t_small_fits", (n, 1, l2, nd)),
            ("tfhe_extprod_t", (n, 1, l2, nd, 0)),
            ("tfhe_extprod_t_small_fits", (n, 2, l2, nd)),
            ("tfhe_extprod_t", (n, 2, l2, nd, 0))]
        assert cuda_t.launch_counts["extprod_t"] == 2
        assert cuda_t.launch_counts["extprod_t_small"] == 0


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU goes to the kernel route, which refuses what is
    not a CUDA tensor instead of falling back to the plain version."""
    p = CONFIGS["bg8_l2_lo1"]
    acc = torch.empty((2, p.n, 4), dtype=torch.int32, device="meta")
    amounts = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_t.rotate_decompose_t(p, acc, amounts)
    digits = torch.empty((2 * p.l * p.n, 4), dtype=torch.int8, device="meta")
    band = torch.empty((2, 2 * p.l, 2 * p.n), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_t.extprod_t(digits, band, acc)


# ---------------------------------------------------------------------------
# On the card: the Hopper kernels against their plain versions.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _batch(b):
    """A batch given as "top" / "top+1": the largest batch of K2's small
    form, and the tile's smallest."""
    top = cuda_t.SMALL_BATCH_MAX
    return {"top": top, "top+1": top + 1}.get(b, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 8, 127, 129, 200, 2, 7, "top",
                               "top+1"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_kernels_match_plain_on_gpu(cuda_device, cfg, b):
    """K1 and K2 == their plain versions, ragged batches (B % 4 != 0, one
    batch tile and a bit) included, ``lo`` passed explicitly; K2 in the
    form the shapes choose (the small form up to ``SMALL_BATCH_MAX``, the
    tile above), counted under ``extprod_t`` and the small form also
    under ``extprod_t_small``."""
    p = CONFIGS[cfg]
    b = _batch(b)
    lo, nd = cuda_t.band_limb_drop(p), p.digit_limbs
    small = cuda_t.takes_small_form(b)
    acc, amounts, bsk = _inputs(p, b, 7)
    acc_t = from_numpy_u32(acc, cuda_device)
    am_t = torch.from_numpy(amounts).to(cuda_device)
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, cuda_device),
                                  lo)[0].contiguous()
    before = dict(cuda_t.launch_counts)
    d = cuda_t.rotate_decompose_t(p, acc_t, am_t)
    out = cuda_t.extprod_t(d, band, acc_t, nd, lo)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["rotate_decompose_t"] == \
        before["rotate_decompose_t"] + 1
    assert cuda_t.launch_counts["extprod_t"] == before["extprod_t"] + 1
    assert cuda_t.launch_counts["extprod_t_small"] == \
        before["extprod_t_small"] + small
    np.testing.assert_array_equal(
        d.cpu().numpy(),
        cuda_t.rotate_decompose_t_ref(p, acc_t, am_t).cpu().numpy())
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_t.extprod_t_ref(d, band, acc_t, nd, lo)))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 130, 1, 2, 3, "top", "top+1"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_extprod_extreme_operands_on_gpu(cuda_device, cfg, b):
    """Every digit limb -128 and every balanced key limb -128 (the band
    word 0x7F7F7F80, or 0x7F7F8000 with limb 0 dropped): the largest s32
    limb-pair sums of the tensor-core tile, exact; and the same operands
    through the small form's wrapping u32 products."""
    p = CONFIGS[cfg]
    b = _batch(b)
    lo, nd = cuda_t.band_limb_drop(p), p.digit_limbs
    word = 0x7F7F8000 if lo else 0x7F7F7F80
    band = torch.full((2, 2 * p.l, 2 * p.n), word, dtype=torch.int64,
                      device=cuda_device).to(torch.int32)
    digits = torch.full((nd * 2 * p.l * p.n, b), -128, dtype=torch.int8,
                        device=cuda_device)
    acc = from_numpy_u32(_inputs(p, b, 8)[0], cuda_device)
    out = cuda_t.extprod_t(digits, band, acc, nd, lo)
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_t.extprod_t_ref(digits, band, acc, nd, lo)))


@pytest.mark.gpu
@pytest.mark.parametrize("profile", sorted(PROFILE_SHAPES))
def test_small_form_at_profile_shapes_on_gpu(cuda_device, profile):
    """At the profile's own N, 2L and ND, batch 1: K2 takes the small
    form, which equals the plain version and the tile word for word."""
    p = tparams.get_params(profile)
    lo, nd = cuda_t.band_limb_drop(p), p.digit_limbs
    acc, amounts, bsk = _inputs(p, 1, 10)
    acc_t = from_numpy_u32(acc, cuda_device)
    am_t = torch.from_numpy(amounts).to(cuda_device)
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, cuda_device),
                                  lo)[0].contiguous()
    d = cuda_t.rotate_decompose_t(p, acc_t, am_t)
    before = dict(cuda_t.launch_counts)
    out = cuda_t.extprod_t(d, band, acc_t, nd, lo)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["extprod_t"] == before["extprod_t"] + 1
    assert cuda_t.launch_counts["extprod_t_small"] == \
        before["extprod_t_small"] + 1
    want = to_numpy_u32(cuda_t.extprod_t_ref(d, band, acc_t, nd, lo))
    np.testing.assert_array_equal(to_numpy_u32(out), want)
    tile = cuda_t._extprod_t_launch(d, band, acc_t, nd, lo, small=False)
    np.testing.assert_array_equal(to_numpy_u32(tile), want)


@pytest.mark.gpu
def test_gates_on_gpu_match_cpu(cuda_device):
    """The same keys and ciphertexts through NAND on the card (kernels)
    and on the CPU (plain versions) give the same words."""
    p = CONFIGS["bg8_l2_lo1"]
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    a = torch.from_numpy(np.resize([False, True], 33))
    b = torch.from_numpy(np.resize([False, False, True, True], 33))
    ca = cipher.lwe_encrypt_bool(gen, a, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(gen, b, p.lwe_alpha, sk.lv0)
    want = gates.NAND(ck, ca, cb)
    got = gates.NAND(ck.to(cuda_device), ca.to(cuda_device),
                     cb.to(cuda_device))
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(want, sk.lv0).numpy(), ~(a & b).numpy())


# K1's staged-column tiling (csrc/rotdec_col.cuh) at its edges: N 256, 1024
# and 2048; one-limb (l 2, l 3) and multi-limb digits (nd 2, nd 3).
K1_TILE_SHAPES = {
    "n256_bg8_l2": CONFIGS["bg8_l2_lo1"],
    "n1024_bg6_l3": dataclasses.replace(CONFIGS["bg6_l3"], n=1024, nbit=10),
    "n1024_bg10_l2_nd2": tparams.TFHEParams(
        name="t_bg10", bgbit=10, l=2, **dict(_BASE, n=1024, nbit=10)),
    "n2048_bg22_l1_nd3": tparams.TFHEParams(
        name="t_bg22", bgbit=22, l=1, message_modulus=16,
        **dict(_BASE, n=2048, nbit=11)),
    "n256_bg18_l1_nd3": CONFIGS["bg18_l1_nd3"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 15, 16, 17, 2049])
@pytest.mark.parametrize("shape", sorted(K1_TILE_SHAPES))
def test_rotdec_tile_edges_on_gpu(cuda_device, shape, b):
    """K1 == its plain version at B 1, TB - 1, TB, TB + 1 (tiles of 16)
    and a ragged large B, with amounts 0, N and 2N among them."""
    p = K1_TILE_SHAPES[shape]
    rng = np.random.default_rng(b)
    acc = from_numpy_u32(_u32(rng, (2, p.n, b)), cuda_device)
    amounts = rng.integers(0, 2 * p.n + 1, b).astype(np.int32)
    amounts[:3] = [0, p.n, 2 * p.n][:b]
    am = torch.from_numpy(amounts).to(cuda_device)
    d = cuda_t.rotate_decompose_t(p, acc, am)
    np.testing.assert_array_equal(
        d.cpu().numpy(),
        cuda_t.rotate_decompose_t_ref(p, acc, am).cpu().numpy())
