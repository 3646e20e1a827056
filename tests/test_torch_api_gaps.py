"""The port's smaller API functions against the JAX package: the linear
ciphertext operations, the TRLWE phase and boolean encryption,
``params.security_info``, ``utils.torus.f64_to_torus_vec``,
``keys.gen_cloud_key_no_ksk`` and ``bitutils``.

Deterministic functions must give the JAX package's words (tolerance 0);
encryption, which draws from torch's RNG, is held by decryption.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import go_tfhe_tpu as jtfhe  # noqa: E402
from go_tfhe_tpu import bitutils as jbitutils  # noqa: E402
from go_tfhe_tpu import cipher as jcipher  # noqa: E402
from go_tfhe_tpu import engine as jengine  # noqa: E402
from go_tfhe_tpu import keys as jkeys  # noqa: E402
from go_tfhe_tpu import params as jparams  # noqa: E402
from go_tfhe_tpu.utils import torus as jtorus  # noqa: E402
from go_tfhe_tpu_torch import (bitutils, cipher, engine, keys,  # noqa: E402
                               params)
from go_tfhe_tpu_torch.utils import torus  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# cipher: linear operations and TRLWE.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multiplier", [3, 2 ** 31 + 5, 2 ** 32 - 1])
def test_lwe_linear_ops_match_jax(multiplier):
    """Words on both sides of 2^31, multipliers below and above it."""
    rng = np.random.default_rng(multiplier % 1000)
    a, b = _words(rng, (2, 5, 17))
    a[0, :4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    cases = [(cipher.lwe_add(ta, tb), jcipher.lwe_add(ja, jb)),
             (cipher.lwe_sub(ta, tb), jcipher.lwe_sub(ja, jb)),
             (cipher.lwe_neg(ta), jcipher.lwe_neg(ja)),
             (cipher.lwe_add_mul(ta, tb, multiplier),
              jcipher.lwe_add_mul(ja, jb, multiplier)),
             (cipher.lwe_sub_mul(ta, tb, multiplier),
              jcipher.lwe_sub_mul(ja, jb, multiplier))]
    for got, want in cases:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


def test_trlwe_phase_and_decrypt_match_jax():
    rng = np.random.default_rng(3)
    n = 64
    ct = _words(rng, (3, 2, n))
    key = rng.integers(0, 2, n).astype(np.uint32)
    want = np.asarray(jcipher.trlwe_phase(jnp.asarray(ct), jnp.asarray(key)))
    got = cipher.trlwe_phase(_t(ct), _t(key))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.trlwe_decrypt_bool(_t(ct), _t(key)).numpy(),
        np.asarray(jcipher.trlwe_decrypt_bool(jnp.asarray(ct),
                                              jnp.asarray(key))))


def test_trlwe_encrypt_bool_decrypts():
    """The port's TRLWE boolean encryption decrypts under its own key and
    under the JAX package's decryption of the same words."""
    p = params.TEST_PBS
    gen = torch.Generator().manual_seed(4)
    sk = keys.gen_secret_key(gen, p, "cpu")
    bits = np.random.default_rng(4).integers(0, 2, (2, p.n)).astype(bool)
    ct = cipher.trlwe_encrypt_bool(gen, bits, p.lv1_alpha, sk.lv1)
    assert ct.shape == (2, 2, p.n) and ct.dtype == torch.int32
    np.testing.assert_array_equal(
        cipher.trlwe_decrypt_bool(ct, sk.lv1).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(jcipher.trlwe_decrypt_bool(
            jnp.asarray(to_numpy_u32(ct)), jnp.asarray(to_numpy_u32(sk.lv1)))),
        bits)


# ---------------------------------------------------------------------------
# params.security_info, utils.torus.f64_to_torus_vec.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(set(params.PROFILES)))
def test_security_info_matches_jax(name):
    assert (params.security_info(params.get_params(name))
            == jparams.security_info(jparams.get_params(name)))


def test_security_info_custom_profile_matches_jax():
    tp = dataclasses.replace(params.TEST_FAST, name="my_profile")
    jp = dataclasses.replace(jtfhe.TEST_FAST, name="my_profile")
    assert params.security_info(tp) == jparams.security_info(jp) == \
        "my_profile (custom profile)"


def test_f64_to_torus_vec_matches_jax():
    d = np.concatenate([[0.0, 0.125, -0.125, 0.5, -0.5, 1.0, -1.0, 1.75,
                         -3.25, 1e-12, 0.9999999999],
                        np.random.default_rng(5).normal(0, 3, 64)])
    got = torus.f64_to_torus_vec(d)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jtorus.f64_to_torus_vec(d))
    np.testing.assert_array_equal(torus.f64_to_torus_vec(list(d[:3])),
                                  jtorus.f64_to_torus_vec(list(d[:3])))


# ---------------------------------------------------------------------------
# keys.gen_cloud_key_no_ksk.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["test_fast", "test_pbs"])
def test_gen_cloud_key_no_ksk_bootstraps_like_jax(name):
    """The zero keys' fields, and a bootstrap through them, equal the JAX
    fixture's words."""
    jck = jkeys.gen_cloud_key_no_ksk(jtfhe.get_params(name))
    tck = keys.gen_cloud_key_no_ksk(params.get_params(name), device="cpu")
    for field in ("testvec", "ksk", "bsk"):
        got = getattr(tck, field)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(to_numpy_u32(got),
                                      np.asarray(getattr(jck, field)))
    full = keys.cloud_key_from_numpy(name, np.asarray(jck.testvec),
                                     np.asarray(jck.ksk), np.asarray(jck.bsk),
                                     device="cpu")
    np.testing.assert_array_equal(tck.bands.numpy(), full.bands.numpy())
    ct = _words(np.random.default_rng(6), (4, tck.params.lwe_n + 1))
    want = np.asarray(jengine.bootstrap(jck, jnp.asarray(ct)))
    np.testing.assert_array_equal(
        to_numpy_u32(engine.bootstrap(tck, _t(ct))), want)


# ---------------------------------------------------------------------------
# bitutils.
# ---------------------------------------------------------------------------

def test_bitutils_integer_helpers_match_jax():
    for v in [0, 1, 0x55, 0xAA, 0xFF, 42, 0xBEEF, 0xDEADBEEF,
              0x0123456789ABCDEF, 2 ** 64 - 1]:
        for size in (3, 8, 16, 32, 64):
            np.testing.assert_array_equal(bitutils.to_bits(v, size),
                                          jbitutils.to_bits(v, size))
        for f in ("u8_to_bits", "u16_to_bits", "u32_to_bits", "u64_to_bits"):
            bits = getattr(bitutils, f)(v)
            np.testing.assert_array_equal(bits, getattr(jbitutils, f)(v))
            for g in ("bits_to_u8", "bits_to_u16", "bits_to_u32",
                      "bits_to_u64"):
                assert getattr(bitutils, g)(bits) == getattr(jbitutils, g)(
                    bits)
    assert bitutils.from_bits([True, False, True]) == 5
    assert bitutils.bits_to_u8(bitutils.u8_to_bits(0b10000000)) == 128
    assert bitutils.bits_to_u64(bitutils.u64_to_bits(0x0123456789ABCDEF)) \
        == 0x0123456789ABCDEF


def test_bitutils_encryption_round_trips():
    """encrypt_bits / encrypt_bits_messages decrypt to their bits, also
    under the JAX package's decryption of the same words."""
    p = params.TEST_FAST
    gen = torch.Generator().manual_seed(7)
    sk = keys.gen_secret_key(gen, p, "cpu")
    bits = np.stack([bitutils.u8_to_bits(0xA7), bitutils.u8_to_bits(0x3C)])
    ct = bitutils.encrypt_bits(gen, bits, p.lwe_alpha, sk.lv0)
    assert ct.shape == (2, 8, p.lwe_n + 1) and ct.device.type == "cpu"
    dec = bitutils.decrypt_bits(ct, sk.lv0).numpy()
    assert [bitutils.bits_to_u8(r) for r in dec] == [0xA7, 0x3C]
    key = jnp.asarray(to_numpy_u32(sk.lv0))
    np.testing.assert_array_equal(
        np.asarray(jbitutils.decrypt_bits(jnp.asarray(to_numpy_u32(ct)),
                                          key)), bits)
    msg = bitutils.encrypt_bits_messages(gen, bits, p.lwe_alpha, sk.lv0)
    np.testing.assert_array_equal(
        bitutils.decrypt_bits_messages(msg, sk.lv0).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(jbitutils.decrypt_bits_messages(
            jnp.asarray(to_numpy_u32(msg)), key)), bits)


def test_bitutils_decrypt_matches_jax_on_jax_ciphertexts(fast_keys):
    """The decryptions of JAX ciphertexts equal JAX's, message 2 (a carry
    out of the many-LUT adder) and 3 included."""
    p, sk, _ = fast_keys
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    bits = np.asarray([True, False, True, True, False])
    ct = jbitutils.encrypt_bits(k1, bits, p.lwe_alpha, sk.lv0)
    np.testing.assert_array_equal(
        bitutils.decrypt_bits(_t(ct), _t(sk.lv0)).numpy(),
        np.asarray(jbitutils.decrypt_bits(ct, sk.lv0)))
    msgs = np.asarray([0, 1, 2, 3, 7])
    mct = jcipher.lwe_encrypt_message(k2, msgs, 8, p.lwe_alpha, sk.lv0)
    got = bitutils.decrypt_bits_messages(_t(mct), _t(sk.lv0)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbitutils.decrypt_bits_messages(mct, sk.lv0)))
    np.testing.assert_array_equal(got, (msgs & 1) > 0)
