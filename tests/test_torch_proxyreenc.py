"""The port's proxy re-encryption against the JAX package.

``reencrypt`` is deterministic: on a re-encryption key carried across
from the JAX package it must give JAX's words (tolerance 0).  Keygen and
public-key encryption draw from torch's RNG and are held by decryption
(every bit right; the reference's own tests ask for 90-95%,
proxyreenc/proxyreenc_test.go:27-167).  The ``.npz`` files cross between
the packages in both directions.  The ``gpu`` case runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_proxyreenc.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, keys, params, proxyreenc  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

P = params.TEST_FAST


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import go_tfhe_tpu as jtfhe
    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import proxyreenc as jproxy
    ks = jax.random.split(jax.random.PRNGKey(70), 3)
    users = [jtfhe.gen_secret_key(k, jtfhe.TEST_FAST) for k in ks]
    return types.SimpleNamespace(jax=jax, jnp=jnp, tfhe=jtfhe,
                                 cipher=jcipher, proxy=jproxy, users=users)


@pytest.fixture(scope="module")
def users():
    """Three users' port secret keys (level 0), made on the CPU."""
    gen = torch.Generator().manual_seed(71)
    return [keys.gen_secret_key(gen, P, "cpu").lv0 for _ in range(3)]


def _bits(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(bool)


# ---------------------------------------------------------------------------
# reencrypt on carried JAX keys: word for word.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_reencrypt_matches_jax_on_carried_key(jx, kind):
    alice, bob, _ = jx.users
    k1, k2, k3 = jx.jax.random.split(jx.jax.random.PRNGKey(72), 3)
    if kind == "symmetric":
        rk = jx.proxy.gen_reencryption_key_symmetric(k1, alice.lv0, bob.lv0,
                                                     jx.tfhe.TEST_FAST)
    else:
        pk = jx.proxy.gen_public_key(k1, bob.lv0, jx.tfhe.TEST_FAST)
        rk = jx.proxy.gen_reencryption_key_asymmetric(k2, alice.lv0, pk,
                                                      jx.tfhe.TEST_FAST)
    trk = proxyreenc.reencryption_key_from_numpy(
        np.asarray(rk.table), rk.basebit, rk.t, device="cpu")
    assert trk.table.device.type == "cpu" and trk.base == rk.base
    bits = _bits(6, 72).reshape(2, 3)
    ct = jx.cipher.lwe_encrypt_bool(k3, bits, P.lwe_alpha, alice.lv0)
    want = np.asarray(jx.proxy.reencrypt(rk, ct))
    got = proxyreenc.reencrypt(trk, _t(ct))
    assert got.shape == (2, 3, P.lwe_n + 1)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(bob.lv0)).numpy(), bits)


def test_reencrypt_on_a_non_default_digit_table_matches_jax(jx):
    """A table with its own basebit and t (not the KSK's)."""
    alice, bob, _ = jx.users
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(73))
    rk = jx.proxy.gen_reencryption_key_symmetric(
        k1, alice.lv0, bob.lv0, jx.tfhe.TEST_FAST, basebit=3, t=7)
    trk = proxyreenc.reencryption_key_from_numpy(
        np.asarray(rk.table), 3, 7, device="cpu")
    ct = jx.cipher.lwe_encrypt_bool(k2, _bits(8, 73), P.lwe_alpha, alice.lv0)
    np.testing.assert_array_equal(
        to_numpy_u32(proxyreenc.reencrypt(trk, _t(ct))),
        np.asarray(jx.proxy.reencrypt(rk, ct)))


# ---------------------------------------------------------------------------
# The port's own keys: held by decryption.
# ---------------------------------------------------------------------------

def test_public_key_encrypt_decrypts(users):
    gen = torch.Generator().manual_seed(74)
    pk = proxyreenc.gen_public_key(gen, users[0], P)
    assert pk.encryptions.shape == (2 * P.lwe_n, P.lwe_n + 1)
    zero = to_numpy_u32(cipher.lwe_phase(pk.encryptions, users[0]))
    assert np.abs(zero.view(np.int32)).max() < 2 ** 24
    bits = _bits(100, 74)
    ct = proxyreenc.pk_encrypt_bool(gen, pk, bits, P.lwe_alpha)
    assert ct.shape == (100, P.lwe_n + 1) and ct.dtype == torch.int32
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(ct, users[0]).numpy(), bits)
    mu = np.asarray([0, 2 ** 29, 2 ** 31, 3 * 2 ** 30], np.uint32)
    ct = proxyreenc.pk_encrypt_torus(gen, pk, mu, P.lwe_alpha)
    dev = (to_numpy_u32(cipher.lwe_phase(ct, users[0])).astype(np.int64)
           - mu + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.abs(dev).max() < 2 ** 24


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_reencryption_keys_decrypt(users, kind):
    alice, bob, _ = users
    gen = torch.Generator().manual_seed(75)
    if kind == "symmetric":
        rk = proxyreenc.gen_reencryption_key_symmetric(gen, alice, bob, P)
    else:
        pk = proxyreenc.gen_public_key(gen, bob, P)
        rk = proxyreenc.gen_reencryption_key_asymmetric(gen, alice, pk, P)
    assert rk.table.shape == (P.lwe_n, P.iks_t, P.base, P.lwe_n + 1)
    assert not rk.table[:, :, 0].any()
    bits = _bits(100, 75)
    ct = cipher.lwe_encrypt_bool(gen, bits, P.lwe_alpha, alice)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(proxyreenc.reencrypt(rk, ct), bob).numpy(),
        bits)


def test_three_hop_chain(users):
    """alice -> bob -> carol (proxyreenc_test.go:140-167), the middle hop
    through an asymmetric key."""
    alice, bob, carol = users
    gen = torch.Generator().manual_seed(76)
    rk_ab = proxyreenc.gen_reencryption_key_symmetric(gen, alice, bob, P)
    rk_bc = proxyreenc.gen_reencryption_key_asymmetric(
        gen, bob, proxyreenc.gen_public_key(gen, carol, P), P)
    rk_ca = proxyreenc.gen_reencryption_key_symmetric(gen, carol, alice, P)
    bits = _bits(100, 76)
    ct = cipher.lwe_encrypt_bool(gen, bits, P.lwe_alpha, alice)
    ct2 = proxyreenc.reencrypt(rk_bc, proxyreenc.reencrypt(rk_ab, ct))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(ct2, carol).numpy(), bits)
    ct3 = proxyreenc.reencrypt(rk_ca, ct2)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(ct3, alice).numpy(), bits)


# ---------------------------------------------------------------------------
# .npz files across the packages.
# ---------------------------------------------------------------------------

def test_npz_jax_to_port(jx, tmp_path):
    alice, bob, _ = jx.users
    k1, k2, k3 = jx.jax.random.split(jx.jax.random.PRNGKey(77), 3)
    rk = jx.proxy.gen_reencryption_key_symmetric(k1, alice.lv0, bob.lv0,
                                                 jx.tfhe.TEST_FAST)
    pk = jx.proxy.gen_public_key(k2, bob.lv0, jx.tfhe.TEST_FAST)
    jx.proxy.save_reencryption_key(str(tmp_path / "rk.npz"), rk)
    jx.proxy.save_public_key(str(tmp_path / "pk.npz"), pk)
    trk = proxyreenc.load_reencryption_key(str(tmp_path / "rk.npz"),
                                           device="cpu")
    tpk = proxyreenc.load_public_key(str(tmp_path / "pk.npz"), device="cpu")
    assert (trk.basebit, trk.t) == (rk.basebit, rk.t)
    np.testing.assert_array_equal(to_numpy_u32(trk.table),
                                  np.asarray(rk.table))
    np.testing.assert_array_equal(to_numpy_u32(tpk.encryptions),
                                  np.asarray(pk.encryptions))
    ct = jx.cipher.lwe_encrypt_bool(k3, _bits(5, 77), P.lwe_alpha, alice.lv0)
    np.testing.assert_array_equal(
        to_numpy_u32(proxyreenc.reencrypt(trk, _t(ct))),
        np.asarray(jx.proxy.reencrypt(rk, ct)))


def test_npz_port_to_jax(jx, users, tmp_path):
    alice, bob, _ = users
    gen = torch.Generator().manual_seed(78)
    rk = proxyreenc.gen_reencryption_key_symmetric(gen, alice, bob, P)
    pk = proxyreenc.gen_public_key(gen, bob, P)
    proxyreenc.save_reencryption_key(str(tmp_path / "rk.npz"), rk)
    proxyreenc.save_public_key(str(tmp_path / "pk.npz"), pk)
    with np.load(str(tmp_path / "rk.npz")) as z:
        assert z["table"].dtype == np.uint32
        assert z["basebit"].shape == () and z["t"].shape == ()
    jrk = jx.proxy.load_reencryption_key(str(tmp_path / "rk.npz"))
    jpk = jx.proxy.load_public_key(str(tmp_path / "pk.npz"))
    assert (jrk.basebit, jrk.t) == (rk.basebit, rk.t)
    np.testing.assert_array_equal(np.asarray(jpk.encryptions),
                                  to_numpy_u32(pk.encryptions))
    bits = _bits(5, 78)
    ct = cipher.lwe_encrypt_bool(gen, bits, P.lwe_alpha, alice)
    want = np.asarray(jx.proxy.reencrypt(jrk, jx.jnp.asarray(
        to_numpy_u32(ct))))
    got = proxyreenc.reencrypt(rk, ct)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, bob).numpy(), bits)


# ---------------------------------------------------------------------------
# On the card: reencrypt on CUDA tensors equals the CPU's words.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_reencrypt_on_gpu_matches_cpu(cuda_device, users):
    alice, bob, _ = users
    gen = torch.Generator().manual_seed(79)
    rk = proxyreenc.gen_reencryption_key_asymmetric(
        gen, alice, proxyreenc.gen_public_key(gen, bob, P), P)
    ct = cipher.lwe_encrypt_bool(gen, _bits(300, 79), P.lwe_alpha, alice)
    want = proxyreenc.reencrypt(rk, ct)
    got = proxyreenc.reencrypt(
        proxyreenc.ProxyReencryptionKey(rk.table.to(cuda_device), rk.basebit,
                                        rk.t), ct.to(cuda_device))
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
