"""The port's ops against the JAX package's, bit for bit.

Inputs come from ``np.random.default_rng`` and go identically to the JAX
function and its port; integer outputs compare with tolerance 0.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from go_tfhe_tpu import params as jparams  # noqa: E402
from go_tfhe_tpu.ops import blindrotate as jbr  # noqa: E402
from go_tfhe_tpu.ops import decompose as jdec  # noqa: E402
from go_tfhe_tpu.ops import keyswitch as jks  # noqa: E402
from go_tfhe_tpu.ops import polymul as jpm  # noqa: E402
from go_tfhe_tpu.ops import rotate as jrot  # noqa: E402
from go_tfhe_tpu.ops.sample_extract import sample_extract as j_extract  # noqa: E402
from go_tfhe_tpu_torch import params as tparams  # noqa: E402
from go_tfhe_tpu_torch.ops import blindrotate as tbr  # noqa: E402
from go_tfhe_tpu_torch.ops import decompose as tdec  # noqa: E402
from go_tfhe_tpu_torch.ops import keyswitch as tks  # noqa: E402
from go_tfhe_tpu_torch.ops import polymul as tpm  # noqa: E402
from go_tfhe_tpu_torch.ops import rotate as trot  # noqa: E402
from go_tfhe_tpu_torch.ops.sample_extract import sample_extract as t_extract  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

V = np.load(os.path.join(os.path.dirname(__file__), "vectors",
                         "parity_vectors.npz"))
VECTOR_PROFILES = ("80bit", "110bit", "128bit", "uint5")


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return from_numpy_u32(x, "cpu")


def _np(x):
    """A port result as numpy: int32 words as uint32, other ints as is."""
    return to_numpy_u32(x) if x.dtype == torch.int32 else x.numpy()


@pytest.mark.parametrize("name", ["test_fast", "128bit_fast"])
@pytest.mark.parametrize("theta", [0, 1])
def test_mod_switch_2n_matches_jax(name, theta):
    rng = np.random.default_rng(10 + theta)
    x = _u32(rng, (64,))
    x[:4] = [0, 2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1]
    want = np.asarray(jbr.mod_switch_2n(jnp.asarray(x),
                                        jparams.get_params(name), theta))
    got = tbr.mod_switch_2n(_t(x), tparams.get_params(name), theta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", VECTOR_PROFILES)
def test_mod_switch_vectors(name):
    p = tparams.get_params(name)
    got = tbr.mod_switch_2n(_t(V[f"{name}/ms_in"]), p).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), V[f"{name}/ms_a"])


@pytest.mark.parametrize("fn", ["monomial_mul", "monomial_mul_log"])
def test_monomial_mul_matches_jax(fn):
    rng = np.random.default_rng(11)
    n = 64
    poly = _u32(rng, (2, 9, n))
    k = rng.integers(0, 2 * n + 1, (2, 9)).astype(np.int32)
    k[0, :3] = [0, n, 2 * n]
    want = np.asarray(getattr(jrot, fn)(jnp.asarray(poly), jnp.asarray(k)))
    got = getattr(trot, fn)(_t(poly), torch.from_numpy(k))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("name", VECTOR_PROFILES)
def test_rotation_vectors(name):
    a = _t(V[f"{name}/rot_in"])
    ks = torch.from_numpy(V[f"{name}/rot_ks"])
    polys = a.expand(len(ks), a.shape[0])
    for fn in (trot.monomial_mul, trot.monomial_mul_log):
        np.testing.assert_array_equal(_np(fn(polys, ks)),
                                      V[f"{name}/rot_out"])


@pytest.mark.parametrize("name", ["128bit", "128bit_fast", "uint5"])
def test_gadget_decompose_matches_jax(name):
    """Floor (128bit, uint5) and centered (128bit_fast) decompositions."""
    rng = np.random.default_rng(12)
    jp, tp = jparams.get_params(name), tparams.get_params(name)
    x = _u32(rng, (3, 2, 32))
    want = np.asarray(jdec.gadget_decompose(jnp.asarray(x), jp))
    got = tdec.gadget_decompose(_t(x), tp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", VECTOR_PROFILES)
def test_gadget_decompose_vectors(name):
    p = tparams.get_params(name)
    got = tdec.gadget_decompose(_t(V[f"{name}/dec_in"])[None, :], p)
    np.testing.assert_array_equal(got.numpy(), V[f"{name}/dec_out"])


@pytest.mark.parametrize("k", [0, 5, 63])
def test_sample_extract_matches_jax(k):
    rng = np.random.default_rng(13 + k)
    trlwe = _u32(rng, (4, 2, 64))
    want = np.asarray(j_extract(jnp.asarray(trlwe), k))
    np.testing.assert_array_equal(_np(t_extract(_t(trlwe), k)),
                                  want)


@pytest.mark.parametrize("name", VECTOR_PROFILES)
def test_sample_extract_vectors(name):
    trlwe = torch.stack([_t(V[f"{name}/se_a"]), _t(V[f"{name}/se_b"])])
    for k, want in zip(V[f"{name}/se_ks"], V[f"{name}/se_out"]):
        np.testing.assert_array_equal(_np(t_extract(trlwe, int(k))),
                                      want, err_msg=f"k={k}")


def test_split_signed_limbs_matches_jax():
    rng = np.random.default_rng(14)
    x = rng.integers(-(2 ** 22), 2 ** 22, (5, 40)).astype(np.int32)
    want = np.asarray(jpm.split_signed_limbs_i8(jnp.asarray(x), 3))
    got = tpm.split_signed_limbs_i8(torch.from_numpy(x), 3)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_balanced_limbs_matches_jax():
    rng = np.random.default_rng(15)
    x = _u32(rng, (5, 40)).view(np.int32)
    want = np.asarray(jpm.split_balanced_limbs_i8(jnp.asarray(x), 4))
    got = tpm.split_balanced_limbs_i8(torch.from_numpy(x.copy()), 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_negacyclic_mul_binary_matches_jax():
    rng = np.random.default_rng(16)
    a = _u32(rng, (3, 5, 128))
    key = rng.integers(0, 2, 128).astype(np.uint32)
    want = np.asarray(jpm.negacyclic_mul_binary(jnp.asarray(a),
                                                jnp.asarray(key)))
    np.testing.assert_array_equal(
        _np(tpm.negacyclic_mul_binary(_t(a), _t(key))), want)


def test_toeplitz_extprod_matches_jax():
    rng = np.random.default_rng(17)
    n, l2 = 32, 4
    trgsw = _u32(rng, (l2, 2, n))
    digits = rng.integers(-128, 128, (3, l2, n)).astype(np.int32)
    band_j = jpm.ext_band_from_trgsw(jnp.asarray(trgsw))
    band_t = tpm.ext_band_from_trgsw(_t(trgsw))
    np.testing.assert_array_equal(_np(band_t),
                                  np.asarray(band_j).view(np.uint32))
    np.testing.assert_array_equal(
        _np(tpm.toeplitz_from_band(band_t)),
        np.asarray(jpm.toeplitz_from_band(band_j)).view(np.uint32))
    want = np.asarray(jpm.negacyclic_extprod_toeplitz(jnp.asarray(digits),
                                                      band_j))
    got = tpm.negacyclic_extprod_toeplitz(torch.from_numpy(digits), band_t)
    np.testing.assert_array_equal(_np(got), want)


def test_matmul_mod32_exact():
    rng = np.random.default_rng(18)
    a = _u32(rng, (7, 300)).view(np.int32)
    b = _u32(rng, (300, 5)).view(np.int32)
    want = (a.astype(np.int64) @ b.astype(np.int64)) % 2 ** 32
    got = tpm.matmul_mod32(torch.from_numpy(a.copy()),
                           torch.from_numpy(b.copy()))
    np.testing.assert_array_equal(_np(got), want.astype(np.uint32))


def test_ks_digits_matches_jax():
    rng = np.random.default_rng(19)
    jp, tp = jparams.P128_FAST, tparams.P128_FAST
    a = _u32(rng, (3, 64))
    want = np.asarray(jks.ks_digits(jp, jnp.asarray(a)))
    np.testing.assert_array_equal(tks.ks_digits(tp, _t(a)).numpy(), want)


def test_identity_key_switch_matches_jax(fast_keys):
    """On the JAX package's TEST_FAST KSK, with leading batch axes."""
    p, _, ck = fast_keys
    rng = np.random.default_rng(20)
    ct = _u32(rng, (2, 3, p.n + 1))
    want = np.asarray(jks.identity_key_switch(p, ck.ksk, jnp.asarray(ct)))
    got = tks.identity_key_switch(tparams.TEST_FAST, _t(np.asarray(ck.ksk)),
                                  _t(ct))
    np.testing.assert_array_equal(_np(got), want)
