"""Extended look-up tables in the port (poly_extend_factor k > 1): the mod
switch to [0, 2kN], the block rotation, the K4/K5 step kernels' plain
versions, the extended blind rotation and bootstrap, and the extended keys,
against the JAX package (Pallas kernels in interpret mode).

On the CPU the wrappers run the kernels' plain versions; the ``gpu`` cases
hold the Hopper kernels against them on the card and skip without one.
JAX is imported only by the cases that use it, so the ``gpu`` cases also
run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_ext.py

Tolerance is 0 throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, engine, keys, lut, params  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_ext_t, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.ops.blindrotate import (  # noqa: E402
    blind_rotate_extended_t, mod_switch_general)
from go_tfhe_tpu_torch.ops.rotate import monomial_mul_blocks  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

# The uint6-8 digit shape (bgbit > 8 -> three limb planes) at N = 256 with
# a non-power-of-two k (tests/test_pallas_ext.py's TEST_EXT_WIDE).
EXT_WIDE = params.TFHEParams(
    name="test_ext_wide", lwe_n=6, lwe_alpha=1.0 / (1 << 28), n=256,
    lv1_alpha=1.0 / (1 << 31), nbit=8, bgbit=18, l=1, basebit=4, iks_t=6,
    block_size=1, message_modulus=8, poly_extend_factor=3)
KERNEL_SHAPES = {"test_ext2": params.TEST_EXT2, "test_ext3": params.TEST_EXT3,
                 "test_ext_wide": EXT_WIDE}


@pytest.fixture(scope="module")
def jx():
    """The JAX side, with the transposed Pallas kernels in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from go_tfhe_tpu.ops import pallas_t
    pallas_t.INTERPRET = True
    import go_tfhe_tpu
    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import engine as jengine
    from go_tfhe_tpu import keys as jkeys
    from go_tfhe_tpu import lut as jlut
    from go_tfhe_tpu.ops import blindrotate as jbr
    from go_tfhe_tpu.ops import rotate as jrot
    return types.SimpleNamespace(jax=jax, jnp=jnp, pallas_t=pallas_t,
                                 tfhe=go_tfhe_tpu, cipher=jcipher,
                                 engine=jengine, keys=jkeys, lut=jlut,
                                 br=jbr, rot=jrot)


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _amounts(p, b, rng):
    """Amounts over [0, 2kN], with 0, kN, 2kN - 1 and 2kN among them."""
    big = 2 * p.poly_extend_factor * p.n
    t = rng.integers(0, big + 1, b).astype(np.int32)
    t[:4] = [0, big // 2, big - 1, big][:b]
    return t


def _ext_inputs(p, b, seed):
    rng = np.random.default_rng(seed)
    k, n = p.poly_extend_factor, p.n
    acc = _u32(rng, (2, k * n, b))
    bsk = _u32(rng, (1, 2 * p.l, 2, n))
    return acc, _amounts(p, b, rng), bsk


# ---------------------------------------------------------------------------
# Mod switch and block rotation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modulus", [1024, 1536, 8192, 16384, 36864, 1 << 17])
def test_mod_switch_general_matches_jax(jx, modulus):
    """Every 2kN the profiles use (test_ext2/3, uint6/7/8) and the 2^17
    bound, where the JAX package's uint32 products wrap; the inputs near
    2^32 give 2kN itself."""
    rng = np.random.default_rng(modulus)
    edges = np.asarray([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1,
                        2 ** 32 - 2 ** 15, 2 ** 32 - (2 ** 31) // modulus,
                        2 ** 32 - (2 ** 31) // modulus - 1], np.uint64)
    x = np.concatenate([edges.astype(np.uint32), _u32(rng, (500,))])
    want = np.asarray(jx.br.mod_switch_general(jx.jnp.asarray(x), modulus))
    got = mod_switch_general(_t(x), modulus)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if modulus <= 1 << 16:             # no uint32 wrap: the rounded quotient
        exact = (x.astype(np.float64) * modulus + 2 ** 31) // 2 ** 32
        np.testing.assert_array_equal(got.numpy(), exact)
        assert got.max().item() == modulus == int(got[4])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_monomial_mul_blocks_matches_jax(jx, k):
    n = 64
    rng = np.random.default_rng(k)
    acc = _u32(rng, (12, k, 2, n))
    big = 2 * k * n
    t = rng.integers(0, big + 1, 12).astype(np.int32)
    t[:5] = [0, k * n, big - 1, big, 1]
    want = np.asarray(jx.rot.monomial_mul_blocks(
        jx.jnp.asarray(acc), jx.jnp.asarray(t), k))
    got = monomial_mul_blocks(_t(acc), torch.from_numpy(t), k)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    # a shared (k, 2, N) polynomial broadcasts over the amounts
    got1 = monomial_mul_blocks(_t(acc[0]), torch.from_numpy(t), k)
    want1 = np.asarray(jx.rot.monomial_mul_blocks(
        jx.jnp.broadcast_to(jx.jnp.asarray(acc[0]), acc.shape),
        jx.jnp.asarray(t), k))
    np.testing.assert_array_equal(to_numpy_u32(got1), want1)


# ---------------------------------------------------------------------------
# K4 and K5 plain versions against the Pallas kernels (interpret mode).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(KERNEL_SHAPES))
def test_rotate_decompose_ext_ref_matches_pallas(jx, shape):
    p = KERNEL_SHAPES[shape]
    acc, amounts, _ = _ext_inputs(p, 8, 1)
    want = np.asarray(jx.pallas_t.rotate_decompose_ext_t(
        _jparams(jx, p), jx.jnp.asarray(acc), jx.jnp.asarray(amounts), tb=8))
    got = cuda_ext_t.rotate_decompose_ext_t_ref(p, _t(acc),
                                                torch.from_numpy(amounts))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", sorted(KERNEL_SHAPES))
def test_extprod_ext_ref_matches_pallas(jx, shape):
    p = KERNEL_SHAPES[shape]
    k, nd = p.poly_extend_factor, p.digit_limbs
    lo = p.kernel_limb_drop if nd == 1 else 0
    acc, amounts, bsk = _ext_inputs(p, 8, 2)
    jnp, pallas_t = jx.jnp, jx.pallas_t
    digits = np.asarray(pallas_t.rotate_decompose_ext_t(
        _jparams(jx, p), jnp.asarray(acc), jnp.asarray(amounts), tb=8))
    band_rev = pallas_t.pack_bsk_band_rev(jnp.asarray(bsk))[0]
    want = np.asarray(pallas_t.extprod_ext_t(
        jnp.asarray(digits), band_rev, jnp.asarray(acc), kblocks=k,
        limb_mag=min(p.half_bg, 128), tb=8, lo=lo, nd=nd))
    band = cuda_t.pack_bsk_band_t(_t(bsk), lo)[0]
    got = cuda_ext_t.extprod_ext_t_ref(torch.from_numpy(digits.copy()), band,
                                       _t(acc), k, nd)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_ext_t_fits_matches_jax(jx):
    for name in params.PROFILES:
        p = params.get_params(name)
        assert cuda_ext_t.ext_t_fits(p) == \
            jx.pallas_t.ext_t_fits(jx.tfhe.get_params(name)), name
    assert cuda_ext_t.ext_t_fits(params.UINT7)
    assert not cuda_ext_t.ext_t_fits(params.UINT8)


def test_cpu_ext_wrappers_run_plain_and_count_nothing():
    p = EXT_WIDE
    acc, amounts, bsk = _ext_inputs(p, 4, 6)
    acc_t, am_t = _t(acc), torch.from_numpy(amounts)
    band = cuda_t.pack_bsk_band_t(_t(bsk))[0]
    cuda_t.reset_launch_counts()
    d = cuda_ext_t.rotate_decompose_ext_t(p, acc_t, am_t)
    np.testing.assert_array_equal(
        d.numpy(), cuda_ext_t.rotate_decompose_ext_t_ref(p, acc_t,
                                                         am_t).numpy())
    out = cuda_ext_t.extprod_ext_t(d, band, acc_t, 3, 3)
    np.testing.assert_array_equal(
        out.numpy(),
        cuda_ext_t.extprod_ext_t_ref(d, band, acc_t, 3, 3).numpy())
    assert cuda_t.launch_counts == dict.fromkeys(cuda_t.launch_counts, 0)


def test_non_cpu_tensor_never_takes_the_plain_ext_path():
    """A tensor off the CPU goes to the kernel route, which refuses what is
    not a CUDA tensor instead of falling back to the plain version."""
    p = EXT_WIDE
    k, n = p.poly_extend_factor, p.n
    acc = torch.empty((2, k * n, 4), dtype=torch.int32, device="meta")
    amounts = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_ext_t.rotate_decompose_ext_t(p, acc, amounts)
    digits = torch.empty((k * 3 * 2 * n, 4), dtype=torch.int8, device="meta")
    band = torch.empty((2, 2, 2 * n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_ext_t.extprod_ext_t(digits, band, acc, k, 3)


# ---------------------------------------------------------------------------
# Blind rotation and bootstrap against the JAX engine.
# ---------------------------------------------------------------------------

def test_blind_rotate_extended_t_matches_jax(jx):
    """The port's extended blind rotation == JAX blind_rotate_extended_t
    (Pallas, interpret mode) at the nd = 3 wide shape, per-ciphertext
    tables."""
    p = EXT_WIDE
    jp = _jparams(jx, p)
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(23))
    sk = jx.tfhe.gen_secret_key(k1, jp)
    ck = jx.tfhe.gen_cloud_key(k2, sk, jp)
    rng = np.random.default_rng(4)
    b = 8
    ct = _u32(rng, (b, p.lwe_n + 1))
    ct[0, :] = 0                                   # every amount 0 or 2kN
    tables = _u32(rng, (b, p.poly_extend_factor, 2, p.n))
    want = np.asarray(jx.br.blind_rotate_extended_t(
        jp, ck.bsk_band_rev, jx.jnp.asarray(ct), jx.jnp.asarray(tables),
        tb=8))
    tck = keys.cloud_key_from_numpy(p, np.asarray(ck.testvec),
                                    np.asarray(ck.ksk), np.asarray(ck.bsk),
                                    device="cpu")
    got = blind_rotate_extended_t(p, tck.bands, _t(ct), _t(tables))
    assert got.shape == (b, p.poly_extend_factor, 2, p.n)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.fixture(scope="module")
def ext_keys(jx):
    """JAX keys at TEST_EXT2 and TEST_EXT3, 8 encrypted messages each, and
    the port's cloud keys built from the same arrays."""
    out = {}
    for i, name in enumerate(("test_ext2", "test_ext3")):
        jp = jx.tfhe.get_params(name)
        k1, k2, k3 = jx.jax.random.split(jx.jax.random.PRNGKey(50 + i), 3)
        sk = jx.tfhe.gen_secret_key(k1, jp)
        ck = jx.tfhe.gen_cloud_key(k2, sk, jp)
        m = jp.message_modulus
        msgs = np.arange(8) * 5 % m
        ct = jx.cipher.lwe_encrypt_message(k3, msgs, m, jp.lwe_alpha, sk.lv0)
        tck = keys.cloud_key_from_numpy(
            name, np.asarray(ck.testvec), np.asarray(ck.ksk),
            np.asarray(ck.bsk), device="cpu")
        out[name] = (sk, ck, tck, msgs, ct)
    return out


@pytest.mark.parametrize("per_ct", [False, True])
@pytest.mark.parametrize("name", ["test_ext2", "test_ext3"])
def test_bootstrap_lut_extended_matches_jax(jx, ext_keys, name, per_ct):
    sk, ck, tck, msgs, ct = ext_keys[name]
    m = ck.params.message_modulus
    gen = jx.lut.Generator(ck.params)
    if per_ct:
        tables = np.stack([np.asarray(gen.gen_lut(
            lambda x, s=s: (x * s + 1) % m)) for s in range(8)])
        expect = (msgs * np.arange(8) + 1) % m
    else:
        tables = np.asarray(gen.gen_lut(lambda x: (3 * x + 1) % m))
        expect = (3 * msgs + 1) % m
    want = np.asarray(jx.lut.bootstrap_lut(ck, ct, jx.jnp.asarray(tables)))
    got = lut.bootstrap_lut(tck, _t(ct), _t(tables))
    assert got.shape == (8, ck.params.lwe_n + 1)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(got, m, _t(sk.lv0)).numpy(), expect)


def test_extended_bootstrap_default_testvec_and_batch_axes(jx, ext_keys):
    sk, ck, tck, _, ct = ext_keys["test_ext2"]
    want = np.asarray(jx.engine.bootstrap_without_key_switch(ck, ct))
    got = engine.bootstrap_without_key_switch(tck, _t(ct))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    flat = engine.bootstrap(tck, _t(ct))
    nested = engine.bootstrap(tck, _t(ct).reshape(2, 4, -1))
    assert nested.shape == (2, 4, ck.params.lwe_n + 1)
    np.testing.assert_array_equal(nested.reshape(8, -1).numpy(),
                                  flat.numpy())
    np.testing.assert_array_equal(to_numpy_u32(flat),
                                  np.asarray(jx.engine.bootstrap(ck, ct)))


# ---------------------------------------------------------------------------
# Keys of extended profiles.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["test_ext3", "uint6", "uint7_centered"])
def test_gen_testvec_extended_matches_jax(jx, name):
    got = keys.gen_testvec(params.get_params(name), "cpu")
    want = np.asarray(jx.keys.gen_testvec(jx.tfhe.get_params(name)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_extended_cloud_key_npz_round_trips(jx, ext_keys, tmp_path):
    sk, ck, tck, _, _ = ext_keys["test_ext3"]
    path = str(tmp_path / "jax.npz")
    jx.keys.save_cloud_key(path, ck)
    loaded = keys.load_cloud_key(path, device="cpu")
    assert loaded.params == params.TEST_EXT3
    for field in ("testvec", "ksk", "bsk", "bands"):
        np.testing.assert_array_equal(getattr(loaded, field).numpy(),
                                      getattr(tck, field).numpy())
    path = str(tmp_path / "port.npz")
    keys.save_cloud_key(path, tck)
    back = jx.keys.load_cloud_key(path)
    assert back.params == ck.params
    for field in ("testvec", "ksk", "bsk"):
        np.testing.assert_array_equal(np.asarray(getattr(back, field)),
                                      np.asarray(getattr(ck, field)))


def test_marginal_profile_warns_at_keygen():
    for name, warns in [("uint7", True), ("uint8", True),
                        ("uint7_centered", False), ("uint6", False)]:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            keys._warn_marginal_profile(params.get_params(name))
        assert bool(caught) == warns, name
        if warns:
            assert f"{name}_centered" in str(caught[0].message)


def test_native_keygen_extended_pbs():
    """Port keygen at TEST_EXT3 (extended test vector, bands) and a PBS
    over the whole message space decrypting right."""
    p = params.TEST_EXT3
    gen = torch.Generator().manual_seed(9)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    assert ck.testvec.shape == (3, 2, p.n)
    m = p.message_modulus
    msgs = np.arange(2 * m) % m
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    out = lut.bootstrap_func(ck, ct, lambda x: (m - 1 - x), m)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(out, m, sk.lv0).numpy(), m - 1 - msgs)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_uint8_raises_naming_k6_k8(device):
    """uint8 fails ext_t_fits and reaches the row-major kernels in the JAX
    package; the port routes it to K6/K8 on every device.  On the CPU a
    uint8-shaped bootstrap (k 9, N 2048, nd 3; one step) runs the plain
    versions; on a tensor that is neither on the CPU nor on a card the
    K6 wrapper raises instead of falling back to its plain version."""
    for name in ("uint8", "uint8_centered"):
        p = params.get_params(name)
        if device == "cpu":
            p = dataclasses.replace(p, lwe_n=1)
        k = p.poly_extend_factor
        tv = torch.zeros((k, 2, p.n), dtype=torch.int32, device=device)
        ksk = torch.zeros((p.n, p.iks_t, p.base, p.lwe_n + 1),
                          dtype=torch.int32, device=device)
        bands = torch.zeros((p.lwe_n, 2, 2 * p.l, 2 * p.n), dtype=torch.int32,
                            device=device)
        ck = keys.CloudKey(testvec=tv, ksk=ksk, bsk=None, bands=bands,
                           params=p)
        assert engine._route(ck) == "blind_rotate_extended_rm"
        ct = torch.zeros((2, p.lwe_n + 1), dtype=torch.int32, device=device)
        if device == "cpu":
            out = engine.bootstrap(ck, ct)
            assert out.shape == (2, p.lwe_n + 1) and not out.any()
        else:
            with pytest.raises(ValueError, match="expected a tensor on"):
                engine.bootstrap(ck, ct)
            with pytest.raises(ValueError, match="expected a tensor on"):
                lut.bootstrap_lut(ck, ct, tv)


# ---------------------------------------------------------------------------
# On the card: K4/K5 against their plain versions, and a bootstrap.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 200])
@pytest.mark.parametrize("shape", sorted(KERNEL_SHAPES))
def test_ext_kernels_match_plain_on_gpu(cuda_device, shape, b):
    p = KERNEL_SHAPES[shape]
    k, nd = p.poly_extend_factor, p.digit_limbs
    acc, amounts, bsk = _ext_inputs(p, b, 7)
    acc_t = from_numpy_u32(acc, cuda_device)
    am_t = torch.from_numpy(amounts).to(cuda_device)
    lo = p.kernel_limb_drop if nd == 1 else 0
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, cuda_device),
                                  lo)[0].contiguous()
    before = dict(cuda_t.launch_counts)
    d = cuda_ext_t.rotate_decompose_ext_t(p, acc_t, am_t)
    out = cuda_ext_t.extprod_ext_t(d, band, acc_t, k, nd)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["rotate_decompose_ext_t"] == \
        before["rotate_decompose_ext_t"] + 1
    assert cuda_t.launch_counts["extprod_ext_t"] == \
        before["extprod_ext_t"] + 1
    np.testing.assert_array_equal(
        d.cpu().numpy(),
        cuda_ext_t.rotate_decompose_ext_t_ref(p, acc_t, am_t).cpu().numpy())
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_ext_t.extprod_ext_t_ref(d, band, acc_t, k, nd)))


@pytest.mark.gpu
def test_extended_bootstrap_on_gpu_matches_cpu(cuda_device):
    """The same keys and ciphertexts through an extended PBS on the card
    (K4/K5) and on the CPU (plain versions) give the same words."""
    p = EXT_WIDE
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    m = p.message_modulus
    msgs = np.arange(33) % m
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    table = lut.Generator(p, device="cpu").gen_lut(
        lambda x: (5 * x + 2) % m)
    want = lut.bootstrap_lut(ck, ct, table)
    cuda_t.reset_launch_counts()
    got = lut.bootstrap_lut(ck.to(cuda_device), ct.to(cuda_device),
                            table.to(cuda_device))
    assert cuda_t.launch_counts["rotate_decompose_ext_t"] == p.lwe_n
    assert cuda_t.launch_counts["extprod_ext_t"] == p.lwe_n
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(want, m, sk.lv0).numpy(),
        (5 * msgs + 2) % m)
