"""The port's Nussbaumer transform (``experimental/nussbaumer.py``) against
the JAX package's, word for word, at N <= 256: the cheap cases of
tests/test_nussbaumer.py, each held to the JAX function and to the port's
dense product.  Exact mod 2^32 whenever the fixed operand K is divisible
by m (on-grid keys).  The ``gpu`` case runs the external product on the
card against the CPU; JAX is imported only by the cases that use it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_nussbaumer.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch.experimental import nussbaumer  # noqa: E402
from go_tfhe_tpu_torch.ops import polymul  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

EDGE_I32 = np.array([0, 1, 2 ** 31 - 1, -2 ** 31, -1], np.int32)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    from go_tfhe_tpu.experimental import nussbaumer as jnuss
    from go_tfhe_tpu.ops import polymul as jpolymul
    # Jitted, as the JAX package's callers would run them: eagerly, each
    # of the transform's small ops compiles on its own (18 s on the CPU
    # at N 256).
    return types.SimpleNamespace(
        nuss=jnuss, polymul=jpolymul,
        ntt=jax.jit(jnuss.ntt_slots, static_argnums=(1, 2)),
        twist=jax.jit(jnuss._twist, static_argnums=(1, 2)),
        forward=jax.jit(jnuss.forward),
        inverse=jax.jit(jnuss.inverse_unnormalized, static_argnums=1),
        hat=jax.jit(jnuss.bsk_nuss_hat, static_argnums=1),
        mul=jax.jit(jnuss.negacyclic_mul_nuss_ref),
        extprod=jax.jit(jnuss.extprod_nuss_ref),
        mul_fixed=jax.jit(jpolymul.negacyclic_mul_fixed))


def _i32(rng, shape, lo=-(1 << 31), hi=1 << 31):
    """Signed words in [lo, hi) with the int32 edge words written in."""
    a = rng.integers(lo, hi, shape, np.int64).astype(np.int32)
    a.reshape(-1)[:len(EDGE_I32)] = EDGE_I32
    return a


def _on_grid(rng, shape, top=False):
    """uint32 words on the 2^8 grid (divisible by every m for N <= 2048);
    ``top`` sets bit 31 of every word (wrapping transform sums)."""
    k = (rng.integers(0, 1 << 24, shape, np.int64) << 8).astype(np.uint32)
    k.reshape(-1)[:3] = [0, 0xFFFFFF00, 0x80000000]
    return k | np.uint32(0x80000000) if top else k


def _t(x):
    return from_numpy_u32(np.asarray(x).view(np.uint32), "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy_u32(got),
                                  np.asarray(want).astype(np.uint32))


@pytest.mark.parametrize("n", [4, 16, 64, 128, 256, 512, 1024, 2048])
def test_nuss_shape(jx, n):
    assert nussbaumer.nuss_shape(n) == jx.nuss.nuss_shape(n)


def test_nuss_shape_values_and_refusal():
    assert nussbaumer.nuss_shape(1024) == (32, 32, 2)
    assert nussbaumer.nuss_shape(2048) == (64, 32, 1)
    assert nussbaumer.nuss_shape(512) == (32, 16, 1)
    assert nussbaumer.nuss_shape(128) == (16, 8, 1)
    for n in (2, 96):
        with pytest.raises(ValueError):
            nussbaumer.nuss_shape(n)


@pytest.mark.parametrize("k", [0, 1, 5, 15, 16, 17, 31, -3, 40])
def test_neg_rot(jx, k):
    """Z^k in Z[Z]/(Z^16+1): arithmetic negation on the wrap (-(-2^31)
    wraps to itself)."""
    v = _i32(np.random.default_rng(k + 100), (3, 16))
    _eq(nussbaumer.neg_rot(_t(v), k), jx.nuss.neg_rot(v, k))


@pytest.mark.parametrize("m", [2, 8, 16, 32])
def test_bitrev_and_twist(jx, m):
    assert nussbaumer._bitrev(m) == jx.nuss._bitrev(m)
    c = _i32(np.random.default_rng(m), (2, m, 8))
    for e, sign in ((1, 1), (2, -1)):
        _eq(nussbaumer._twist(_t(c), e, sign), jx.twist(c, e, sign))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [8, 16])
def test_ntt_slots(jx, m, inverse):
    x = _i32(np.random.default_rng(m + inverse), (3, m, 16))
    _eq(nussbaumer.ntt_slots(_t(x), 2, inverse), jx.ntt(x, 2, inverse))


@pytest.mark.parametrize("n", [64, 128, 256])
def test_forward_and_inverse(jx, n):
    rng = np.random.default_rng(n)
    a = _i32(rng, (3, n))
    _eq(nussbaumer.forward(_t(a)), jx.forward(a))
    m, r, _ = nussbaumer.nuss_shape(n)
    c = _i32(rng, (2, m, 2 * r))
    _eq(nussbaumer.inverse_unnormalized(_t(c), n),
        jx.inverse(c, n))


def test_forward_inverse_roundtrip(jx):
    """inverse'(forward(a)) == m * a (mod 2^32), as the JAX package's."""
    n = 64
    m, _, _ = nussbaumer.nuss_shape(n)
    a = _i32(np.random.default_rng(1), (3, n))
    back = nussbaumer.inverse_unnormalized(nussbaumer.forward(_t(a)), n)
    assert torch.equal(back, _t(a) * m)
    _eq(back, jx.inverse(jx.forward(a), n))


@pytest.mark.parametrize("n", [64, 256])
def test_bsk_nuss_hat(jx, n):
    """K/m is the logical shift of the uint32 words (top-bit keys)."""
    k = _on_grid(np.random.default_rng(n), (2, n), top=True)
    _eq(nussbaumer.bsk_nuss_hat(_t(k), n), jx.hat(k, n))


@pytest.mark.parametrize("n", [64, 128])
def test_single_mul_matches_dense(jx, n):
    rng = np.random.default_rng(2)
    k = _on_grid(rng, (n,))
    a = _i32(rng, (4, n), -(1 << 20), 1 << 20)
    got = nussbaumer.negacyclic_mul_nuss_ref(_t(a), _t(k))
    _eq(got, jx.mul(a, k))
    _eq(got, jx.mul_fixed(a.view(np.uint32), k))
    assert torch.equal(got, polymul.negacyclic_mul_fixed(_t(a), _t(k)))


@pytest.mark.parametrize("n,l2,top", [(128, 4, False), (256, 2, False),
                                      (256, 4, True)])
def test_extprod_matches_dense(jx, n, l2, top):
    """The external product through the transform == the JAX one and the
    dense Toeplitz product; ``top``: keys with bit 31 set."""
    rng = np.random.default_rng(3)
    bsk = _on_grid(rng, (l2, 2, n), top)
    digits = rng.integers(-128, 128, (5, l2, n)).astype(np.int32)
    got = nussbaumer.extprod_nuss_ref(_t(digits), _t(bsk))
    assert got.shape == (5, 2, n)
    _eq(got, jx.extprod(digits, bsk))
    want = polymul.negacyclic_extprod_toeplitz(
        _t(digits), polymul.ext_band_from_trgsw(_t(bsk)))
    assert torch.equal(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this case runs the card's forms")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 1024])
def test_extprod_on_gpu_matches_cpu(cuda_device, n):
    rng = np.random.default_rng(n)
    bsk = _t(_on_grid(rng, (4, 2, n), top=True))
    digits = _t(rng.integers(-128, 128, (9, 4, n)).astype(np.int32))
    want = nussbaumer.extprod_nuss_ref(digits, bsk)
    got = nussbaumer.extprod_nuss_ref(digits.to(cuda_device),
                                      bsk.to(cuda_device))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
