"""The port's bootstrap engine, gates and keys against the JAX package.

JAX keys and ciphertexts go through ``keys.cloud_key_from_numpy``; every
two-input gate must then equal the JAX engine's output bit for bit.  The
port's own keygen is held by decryption, by the key grid and by the phase
margin, since torch's generator draws other numbers than ``jax.random``.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import go_tfhe_tpu as jtfhe  # noqa: E402
from go_tfhe_tpu import cipher as jcipher  # noqa: E402
from go_tfhe_tpu import engine as jengine  # noqa: E402
from go_tfhe_tpu import gates as jgates  # noqa: E402
from go_tfhe_tpu import keys as jkeys  # noqa: E402
from go_tfhe_tpu_torch import cipher, engine, gates, keys, params  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

A = np.resize([False, False, True, True], 8)
B = np.resize([False, True, False, True], 8)
TRUTH = {
    "NAND": ~(A & B), "AND": A & B, "OR": A | B, "XOR": A ^ B,
    "XNOR": ~(A ^ B), "NOR": ~(A | B), "ANDNY": ~A & B, "ANDYN": A & ~B,
    "ORNY": ~A | B, "ORYN": A | ~B,
}

# N = 256 with the 128bit_fast knobs: bgbit 8 / l 2 gadget, centered
# decomposition, on-grid key, lowest key limb dropped.
BG8_LO1 = jtfhe.TFHEParams(
    name="t_engine_bg8_lo1", lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
    lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=8, l=2, basebit=4, iks_t=6,
    block_size=1, kernel_limb_drop=1, key_grid_bits=8,
    centered_decomposition=True)

# TEST_FAST's sizes with BG8_LO1's knobs, for the port's native keygen.
GRID_FAST = dataclasses.replace(
    params.TEST_FAST, name="t_grid_fast", kernel_limb_drop=1,
    key_grid_bits=8, centered_decomposition=True)


def _port_params(p):
    return params.TFHEParams(**dataclasses.asdict(p))


def _port_ck(ck):
    return keys.cloud_key_from_numpy(
        _port_params(ck.params), np.asarray(ck.testvec), np.asarray(ck.ksk),
        np.asarray(ck.bsk), ck.block_binary, device="cpu")


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


@pytest.fixture(scope="module")
def shared(fast_keys):
    """JAX keys and ciphertexts at both profiles, and the port's keys."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(23))
    sk = jtfhe.gen_secret_key(k1, BG8_LO1)
    out = {"test_fast": fast_keys[1:],
           "bg8_lo1": (sk, jtfhe.gen_cloud_key(k2, sk, BG8_LO1))}
    for i, (name, (sk, ck)) in enumerate(sorted(out.items())):
        ka, kb = jax.random.split(jax.random.PRNGKey(100 + i))
        p = ck.params
        ca = jcipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
        cb = jcipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
        out[name] = (sk, ck, _port_ck(ck), ca, cb)
    return out


@pytest.mark.parametrize("gate", sorted(TRUTH))
@pytest.mark.parametrize("profile", ["test_fast", "bg8_lo1"])
def test_gate_matches_jax(shared, profile, gate):
    sk, ck, tck, ca, cb = shared[profile]
    want = np.asarray(getattr(jgates, gate)(ck, ca, cb))
    got = getattr(gates, gate)(tck, _t(ca), _t(cb))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    dec = cipher.lwe_decrypt_bool(got, _t(sk.lv0))
    np.testing.assert_array_equal(dec.numpy(), TRUTH[gate])


def test_bootstrap_without_key_switch_and_batch_axes(shared):
    sk, ck, tck, ca, _ = shared["test_fast"]
    want = np.asarray(jengine.bootstrap_without_key_switch(ck, ca))
    got = engine.bootstrap_without_key_switch(tck, _t(ca))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    flat = engine.bootstrap(tck, _t(ca))
    nested = engine.bootstrap(tck, _t(ca).reshape(2, 4, -1))
    assert nested.shape == (2, 4, ck.params.lwe_n + 1)
    np.testing.assert_array_equal(nested.reshape(8, -1).numpy(),
                                  flat.numpy())


def test_cloud_key_npz_written_by_jax_loads(shared, tmp_path):
    sk, ck, tck, _, _ = shared["test_fast"]
    path = str(tmp_path / "ck.npz")
    jkeys.save_cloud_key(path, ck)
    loaded = keys.load_cloud_key(path, device="cpu")
    assert loaded.params == params.TEST_FAST
    for field in ("testvec", "ksk", "bsk", "bands"):
        np.testing.assert_array_equal(getattr(loaded, field).numpy(),
                                      getattr(tck, field).numpy())
    spath = str(tmp_path / "sk.npz")
    jkeys.save_secret_key(spath, sk)
    tsk = keys.load_secret_key(spath, device="cpu")
    np.testing.assert_array_equal(to_numpy_u32(tsk.lv0), np.asarray(sk.lv0))


def test_cloud_key_npz_written_by_port_loads_in_jax(shared, tmp_path):
    sk, ck, tck, _, _ = shared["test_fast"]
    path = str(tmp_path / "ck.npz")
    keys.save_cloud_key(path, tck)
    back = jkeys.load_cloud_key(path)
    assert back.params == ck.params
    for field in ("testvec", "ksk", "bsk"):
        np.testing.assert_array_equal(np.asarray(getattr(back, field)),
                                      np.asarray(getattr(ck, field)))


@pytest.fixture(scope="module")
def native():
    """Port keygen at TEST_FAST and at its on-grid variant."""
    out = {}
    for i, p in enumerate((params.TEST_FAST, GRID_FAST)):
        gen = torch.Generator().manual_seed(7 + i)
        sk = keys.gen_secret_key(gen, p, "cpu")
        out[p.name] = (gen, sk, keys.gen_cloud_key(gen, sk, p))
    return out


@pytest.mark.parametrize("name", ["test_fast", "t_grid_fast"])
def test_native_keygen_nand(native, name):
    """NAND over a 64-wide truth table decrypts right with >= 8 sigma of
    phase margin (the 2^29 decision margin over the phase deviation)."""
    gen, sk, ck = native[name]
    p = ck.params
    a, b = np.resize(A, 64), np.resize(B, 64)
    ca = cipher.lwe_encrypt_bool(gen, torch.from_numpy(a), p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(gen, torch.from_numpy(b), p.lwe_alpha, sk.lv0)
    out = gates.NAND(ck, ca, cb)
    want = ~(a & b)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(out, sk.lv0).numpy(), want)
    phase = cipher.lwe_phase(out, sk.lv0).numpy().astype(np.int64)
    ideal = np.where(want, 1 << 29, -(1 << 29))
    dev = (phase - ideal + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert (1 << 29) / dev.std() >= 8.0


def test_native_keygen_layout(native):
    """KSK rows with digit 0 stay zero; the BSK honours key_grid_bits."""
    _, sk, ck = native["t_grid_fast"]
    p = ck.params
    assert ck.ksk.shape == (p.n, p.iks_t, p.base, p.lwe_n + 1)
    assert ck.bsk.shape == (p.lwe_n, 2 * p.l, 2, p.n)
    assert not ck.ksk[:, :, 0, :].any()
    assert not (ck.bsk & 0xFF).any()
    assert (native["test_fast"][2].bsk & 0xFF).any()
    assert set(sk.lv0.unique().tolist()) == {0, 1}


def test_native_encrypt_noise_statistics():
    """Fresh LWE noise has the profile's standard deviation (the JAX
    package draws other numbers; the distribution is what must match)."""
    p = params.TEST_FAST
    gen = torch.Generator().manual_seed(11)
    sk = keys.gen_secret_key(gen, p, "cpu")
    bits = torch.zeros(4096, dtype=torch.bool)
    ct = cipher.lwe_encrypt_bool(gen, bits, p.lwe_alpha, sk.lv0)
    err = cipher.lwe_phase(ct, sk.lv0).to(torch.int64) - cipher.BOOL_FALSE_MU
    sigma = err.double().std().item() / 2 ** 32
    assert math.isclose(sigma, p.lwe_alpha, rel_tol=0.05)


def test_unported_features_raise(shared):
    """What earlier slices refused is served now, and what the JAX package
    refuses the port refuses too: block-binary keys on a profile with
    block_size 1 ride the per-bit path (equal to the uniform route, as in
    the JAX dispatch), uint8's extended tables route to the row-major
    kernels (K6/K8), and block-binary keygen at block_size 1 raises
    ValueError (go_tfhe_tpu/keys.py:110-113)."""
    _, _, tck, ca, _ = shared["test_fast"]
    blk = dataclasses.replace(tck, block_binary=True)
    assert engine._route(blk) == "blind_rotate_t"
    np.testing.assert_array_equal(engine.bootstrap(blk, _t(ca)).numpy(),
                                  engine.bootstrap(tck, _t(ca)).numpy())
    np.testing.assert_array_equal(
        engine.bootstrap_many(blk, _t(ca), tck.testvec, k=2).numpy(),
        engine.bootstrap_many(tck, _t(ca), tck.testvec, k=2).numpy())
    for name in ("uint8", "uint8_centered"):
        ck_ext = dataclasses.replace(tck, params=params.get_params(name))
        assert engine._route(ck_ext) == "blind_rotate_extended_rm"
    with pytest.raises(ValueError, match="block_size"):
        keys.gen_secret_key(torch.Generator(), params.TEST_FAST, "cpu",
                            block_binary=True)
