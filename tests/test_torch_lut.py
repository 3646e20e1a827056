"""The port's look-up tables, message encoding, programmable bootstrap,
many-LUT bootstrap and AND_OR against the JAX package.

Tables are host numpy on both sides and must be equal word for word; the
bootstraps run JAX keys and ciphertexts through both engines (the port's
on the CPU runs the kernels' plain versions) and must agree bit for bit.
Tolerance is 0 throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import go_tfhe_tpu as jtfhe  # noqa: E402
from go_tfhe_tpu import cipher as jcipher  # noqa: E402
from go_tfhe_tpu import engine as jengine  # noqa: E402
from go_tfhe_tpu import gates as jgates  # noqa: E402
from go_tfhe_tpu import lut as jlut  # noqa: E402
from go_tfhe_tpu_torch import cipher, engine, gates, keys, lut, params  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

TABLE_PROFILES = ["test_pbs", "test_nibble", "test_ext2", "test_ext3",
                  "uint6", "uint7"]


def _port_ck(ck):
    return keys.cloud_key_from_numpy(
        params.TFHEParams(**dataclasses.asdict(ck.params)),
        np.asarray(ck.testvec), np.asarray(ck.ksk), np.asarray(ck.bsk),
        ck.block_binary, device="cpu")


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


# ---------------------------------------------------------------------------
# Tables (host numpy).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TABLE_PROFILES)
def test_generator_tables_match_jax(name):
    jp, tp = jtfhe.get_params(name), params.get_params(name)
    m = tp.message_modulus
    jgen, tgen = jlut.Generator(jp), lut.Generator(tp, device="cpu")
    f = lambda x: (3 * x + 1) % m                          # noqa: E731
    cases = [
        (jgen.gen_lut(f), tgen.gen_lut(f)),
        (jgen.gen_lut_full(lambda x: x * 0x01234567 % 2 ** 32),
         tgen.gen_lut_full(lambda x: x * 0x01234567 % 2 ** 32)),
        (jgen.gen_lut_custom(f, m, 1.0 / (4 * m)),
         tgen.gen_lut_custom(f, m, 1.0 / (4 * m))),
    ]
    k = tp.poly_extend_factor
    for want, got in cases:
        assert got.dtype == torch.int32
        assert tuple(got.shape) == ((2, tp.n) if k == 1 else (k, 2, tp.n))
        np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


@pytest.mark.parametrize("theta", [1, 2])
def test_gen_multi_lut_matches_jax(theta):
    jp, tp = jtfhe.TEST_PBS, params.TEST_PBS
    m = tp.message_modulus
    fns = [lambda x: x, lambda x: (x + 3) % m, lambda x: (5 * x) % m,
           lambda x: 7 - x][:1 << theta]
    encs = [jlut.Encoder(m, 1.0 / (4 * m))] * len(fns)
    tencs = [lut.Encoder(m, 1.0 / (4 * m))] * len(fns)
    want = jlut.Generator(jp).gen_multi_lut(fns, theta, encoders=encs)
    got = lut.Generator(tp, device="cpu").gen_multi_lut(fns, theta,
                                                         encoders=tencs)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))
    want = jlut.Generator(jp).gen_multi_lut(fns[:1], theta)
    got = lut.Generator(tp, device="cpu").gen_multi_lut(fns[:1], theta)
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(want))


@pytest.mark.parametrize("name", ["test_pbs", "test_ext2", "uint7"])
def test_generator_mod_switch_rounds_halves_away_from_zero(name):
    """Exact halves x/2^32*size = j + 1/2 round up (Go's math.Round), as
    in the JAX package; so do the other inputs."""
    tp = params.get_params(name)
    tgen = lut.Generator(tp, device="cpu")
    jgen = jlut.Generator(jtfhe.get_params(name))
    size = tp.lut_size
    halves = [(2 * j + 1) * (1 << 32) // (2 * size) for j in (0, 5, size - 1)]
    for x, j in zip(halves, (0, 5, size - 1)):
        assert (2 * j + 1) * (1 << 32) % (2 * size) == 0   # exactly a half
        assert tgen.mod_switch(x) == (j + 1) % size == jgen.mod_switch(x)
    rng = np.random.default_rng(1)
    for x in rng.integers(0, 2 ** 32, 64, dtype=np.uint64):
        assert tgen.mod_switch(int(x)) == jgen.mod_switch(int(x))


def test_encoder_matches_jax():
    rng = np.random.default_rng(2)
    for m, scale in [(8, None), (64, None), (8, 1.0 / 8), (12, 1.0 / 48)]:
        te, je = lut.Encoder(m, scale), jlut.Encoder(m, scale)
        for x in range(-3, 2 * m):
            assert te.encode(x) == je.encode(x)
            assert te.encode_with_custom_scale(x, 0.01) == \
                je.encode_with_custom_scale(x, 0.01)
        for v in rng.integers(0, 2 ** 32, 64, dtype=np.uint64):
            assert te.decode(v) == je.decode(v)
            assert te.decode_bool(v) == je.decode_bool(v)


# ---------------------------------------------------------------------------
# Message encode/decode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modulus", [8, 12, 64, 128])
def test_message_encode_decode_matches_jax(modulus):
    """Decode reads the uint32 phase: phases on both sides of 2^31 (and at
    0, 2^31 - 1, 2^31, 2^32 - 1) decode as in the JAX package."""
    msgs = np.arange(-2, 2 * modulus)
    np.testing.assert_array_equal(cipher.encode_message(msgs, modulus),
                                  np.asarray(jcipher.encode_message(
                                      msgs, modulus)))
    rng = np.random.default_rng(modulus)
    n = 16
    key = rng.integers(0, 2, n).astype(np.uint32)
    edges = np.asarray([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                        2 ** 32 - 1], np.uint64)
    phases = np.concatenate([edges, rng.integers(0, 2 ** 32, 200,
                                                 dtype=np.uint64)])
    phases = np.concatenate([phases, (2 ** 31 + rng.integers(
        -2 ** 26, 2 ** 26, 50)).astype(np.uint64)]).astype(np.uint32)
    ct = np.zeros((len(phases), n + 1), np.uint32)
    ct[:, n] = phases                                  # a = 0: phase = b
    ct_rand = rng.integers(0, 2 ** 32, (64, n + 1),
                           dtype=np.uint64).astype(np.uint32)
    for c in (ct, ct_rand):
        want = np.asarray(jcipher.lwe_decrypt_message(
            jax.numpy.asarray(c), modulus, jax.numpy.asarray(key)))
        got = cipher.lwe_decrypt_message(_t(c), modulus, _t(key))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_native_encrypt_message_decrypts():
    p = params.TEST_PBS
    gen = torch.Generator().manual_seed(5)
    sk = keys.gen_secret_key(gen, p, "cpu")
    msgs = np.arange(64) % 8
    ct = cipher.lwe_encrypt_message(gen, msgs, 8, p.lwe_alpha, sk.lv0)
    assert ct.shape == (64, p.lwe_n + 1)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(ct, 8, sk.lv0).numpy(), msgs)
    one = cipher.lwe_encrypt_message(gen, 3, 8, p.lwe_alpha, sk.lv0)
    assert one.shape == (p.lwe_n + 1,)


# ---------------------------------------------------------------------------
# Bootstraps on a plain profile: PBS, many-LUT, AND_OR.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pbs(pbs_keys):
    """TEST_PBS keys of both packages and 8 encrypted messages."""
    p, sk, ck = pbs_keys
    m = p.message_modulus
    msgs = np.arange(8) % m
    ct = jcipher.lwe_encrypt_message(jax.random.PRNGKey(31), msgs, m,
                                     p.lwe_alpha, sk.lv0)
    return sk, ck, _port_ck(ck), msgs, ct


def test_bootstrap_lut_plain_profile_matches_jax(pbs):
    """Shared and per-ciphertext tables, bootstrap_func, batch axes."""
    sk, ck, tck, msgs, ct = pbs
    m = ck.params.message_modulus
    f = lambda x: (3 * x + 1) % m                          # noqa: E731
    shared = jlut.Generator(ck.params).gen_lut(f)
    want = np.asarray(jlut.bootstrap_lut(ck, ct, shared))
    got = lut.bootstrap_lut(tck, _t(ct), _t(shared))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(got, m, _t(sk.lv0)).numpy(), f(msgs))
    np.testing.assert_array_equal(
        to_numpy_u32(lut.bootstrap_func(tck, _t(ct), f, m)), want)

    tables = np.stack([np.asarray(jlut.Generator(ck.params).gen_lut(
        lambda x, s=s: (x + s) % m)) for s in range(8)])
    want = np.asarray(jlut.bootstrap_lut(ck, ct, tables))
    got = lut.bootstrap_lut(tck, _t(ct).reshape(2, 4, -1),
                            _t(tables).reshape(2, 4, 2, -1))
    assert got.shape == (2, 4, ck.params.lwe_n + 1)
    np.testing.assert_array_equal(to_numpy_u32(got).reshape(8, -1), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(got.reshape(8, -1), m, _t(sk.lv0)).numpy(),
        (msgs + np.arange(8)) % m)


@pytest.mark.parametrize("per_ct", [False, True])
def test_bootstrap_many_matches_jax(pbs, per_ct):
    sk, ck, tck, msgs, ct = pbs
    m = ck.params.message_modulus
    gen = jlut.Generator(ck.params)
    fns = [lambda x: x, lambda x: (x + 1) % m]
    mlut = np.asarray(gen.gen_multi_lut(fns, theta=1))
    if per_ct:
        mlut = np.stack([np.asarray(gen.gen_multi_lut(
            [lambda x, s=s: (x + s) % m, lambda x: (2 * x) % m], theta=1))
            for s in range(8)])
    want = np.asarray(jengine.bootstrap_many(ck, ct, jax.numpy.asarray(mlut),
                                             k=2, theta=1))
    got = engine.bootstrap_many(tck, _t(ct), _t(mlut), k=2, theta=1)
    assert got.shape == (2, 8, ck.params.lwe_n + 1)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    raw = engine.bootstrap_many(tck, _t(ct), _t(mlut), k=2, theta=1,
                                key_switch=False)
    want_raw = np.asarray(jengine.bootstrap_many(
        ck, ct, jax.numpy.asarray(mlut), k=2, theta=1, key_switch=False))
    np.testing.assert_array_equal(to_numpy_u32(raw), want_raw)
    if not per_ct:
        dec = [cipher.lwe_decrypt_message(got[t], m, _t(sk.lv0)).numpy()
               for t in range(2)]
        np.testing.assert_array_equal(dec[0], msgs)
        np.testing.assert_array_equal(dec[1], (msgs + 1) % m)


def test_bootstrap_many_checks_its_arguments(pbs):
    _, ck, tck, _, ct = pbs
    tv = tck.testvec
    with pytest.raises(ValueError, match="2\\^theta"):
        engine.bootstrap_many(tck, _t(ct), tv, k=3, theta=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine.bootstrap_many(tck, _t(ct)[:1], tv, k=1, theta=2)
    assert any("theta=2" in str(w.message) for w in caught)
    ext = dataclasses.replace(tck, params=params.TEST_EXT2)
    with pytest.raises(ValueError, match="plain"):
        engine.bootstrap_many(ext, _t(ct), tv, k=2)


def test_and_or_matches_jax(fast_keys):
    p, sk, ck = fast_keys
    a = np.resize([False, False, True, True], 8)
    b = np.resize([False, True, False, True], 8)
    ka, kb = jax.random.split(jax.random.PRNGKey(41))
    ca = jcipher.lwe_encrypt_bool(ka, a, p.lwe_alpha, sk.lv0)
    cb = jcipher.lwe_encrypt_bool(kb, b, p.lwe_alpha, sk.lv0)
    want_and, want_or = jgates.AND_OR(ck, ca, cb)
    got_and, got_or = gates.AND_OR(_port_ck(ck), _t(ca), _t(cb))
    np.testing.assert_array_equal(to_numpy_u32(got_and), np.asarray(want_and))
    np.testing.assert_array_equal(to_numpy_u32(got_or), np.asarray(want_or))
    key = _t(sk.lv0)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got_and, key).numpy(), a & b)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got_or, key).numpy(), a | b)
