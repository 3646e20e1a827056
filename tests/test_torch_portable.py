"""The port's portable path against the JAX package's: the external product
and CMUX, the three portable blind rotations, the extended log rotation,
the five conv-form polymul functions, ``keys.prepare_bootstrap_kernels``
and the portable engine routes (``_bootstrap_core``, ``_ext``, ``_block``,
``_many``), word for word (tolerance 0: everything is exact mod 2^32).
Inputs are uniform words from ``np.random.default_rng`` with the edge
words 0, 1, 2^31 - 1, 2^31 and 2^32 - 1 written in; where no decryption
is checked, keys are uniform words too.  The portable words also equal
the kernels' plain path.  The ``gpu`` cases run the portable routes and
the ``_int_mm`` product on the card against the CPU; JAX is imported only
by the cases that use it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_portable.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import engine, keys, params  # noqa: E402
from go_tfhe_tpu_torch.ops import (blindrotate, cuda_t, extprod,  # noqa: E402
                                   polymul, rotate)
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

EDGE = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)


def _words(rng, shape):
    """Uniform uint32 words with the edge words written in first."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    flat = w.reshape(-1)
    flat[:min(len(EDGE), flat.size)] = EDGE[:flat.size]
    return w


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _eq(got, want):
    """A port tensor and a JAX array hold the same 32-bit words."""
    np.testing.assert_array_equal(to_numpy_u32(got),
                                  np.asarray(want).astype(np.uint32))


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from go_tfhe_tpu import engine as jengine
    from go_tfhe_tpu import keys as jkeys
    from go_tfhe_tpu import params as jparams
    from go_tfhe_tpu.ops import blindrotate as jblindrotate
    from go_tfhe_tpu.ops import extprod as jextprod
    from go_tfhe_tpu.ops import polymul as jpolymul
    from go_tfhe_tpu.ops import rotate as jrotate
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, engine=jengine, keys=jkeys, params=jparams,
        blindrotate=jblindrotate, extprod=jextprod, polymul=jpolymul,
        rotate=jrotate)


def _port_ck(ck):
    return keys.cloud_key_from_numpy(
        ck.params.name, np.asarray(ck.testvec), np.asarray(ck.ksk),
        np.asarray(ck.bsk), ck.block_binary, device="cpu")


def _random_key(p, seed, device="cpu"):
    """Uniform-word key arrays at p (bsk, ksk), the profile's test vector,
    and the port's CloudKey of the three."""
    rng = np.random.default_rng(seed)
    bsk = _words(rng, (p.lwe_n, 2 * p.l, 2, p.n))
    ksk = _words(rng, (p.n, p.iks_t, p.base, p.lwe_n + 1))
    ksk[:, :, 0, :] = 0
    tv = to_numpy_u32(keys.gen_testvec(p, "cpu"))
    return bsk, ksk, tv, keys.cloud_key_from_numpy(
        p, tv, ksk, bsk, p.block_size > 1, device=device)


# ---------------------------------------------------------------------------
# The external product, CMUX and the bands.
# ---------------------------------------------------------------------------

def test_prepare_bootstrap_kernels(jx, fast_keys):
    p, _, ck = fast_keys
    got = keys.prepare_bootstrap_kernels(_t(ck.bsk), params.TEST_FAST)
    assert got.shape == (p.lwe_n, 2 * p.l, 2, 2 * p.n)
    assert got.dtype == torch.int32
    _eq(got, ck.bsk_kernel)
    _eq(got, jx.keys.prepare_bootstrap_kernels(ck.bsk, p))


@pytest.mark.parametrize("fn", ["external_product", "cmux"])
def test_external_product_and_cmux(jx, fast_keys, fn):
    p, _, ck = fast_keys
    tck = _port_ck(ck)
    bands = keys.prepare_bootstrap_kernels(tck.bsk, tck.params)
    rng = np.random.default_rng(11)
    ct0, ct1 = _words(rng, (2, 7, 2, p.n))
    for i in (0, 5, p.lwe_n - 1):
        if fn == "cmux":
            want = jx.extprod.cmux(p, ck.bsk_kernel[i], ct0, ct1)
            got = extprod.cmux(tck.params, bands[i], _t(ct0), _t(ct1))
        else:
            want = jx.extprod.external_product(p, ck.bsk_kernel[i], ct1)
            got = extprod.external_product(tck.params, bands[i], _t(ct1))
        _eq(got, want)


# ---------------------------------------------------------------------------
# The rotations.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 9])
def test_monomial_mul_blocks_log(jx, k):
    n = 16
    big = 2 * k * n
    rng = np.random.default_rng(20 + k)
    ts = np.concatenate([[0, k * n - 1, k * n, big - 1],
                         rng.integers(0, big, 8)]).astype(np.int32)
    acc = _words(rng, (len(ts), k, 2, n))
    want = jx.jax.jit(jx.rotate.monomial_mul_blocks_log,
                      static_argnums=2)(acc, ts, k)
    got = rotate.monomial_mul_blocks_log(_t(acc), torch.from_numpy(ts), k)
    _eq(got, want)
    _eq(rotate.monomial_mul_blocks(_t(acc), torch.from_numpy(ts), k), want)


@pytest.mark.parametrize("theta", [0, 1])
def test_blind_rotate(jx, fast_keys, theta):
    p, _, ck = fast_keys
    tck = _port_ck(ck)
    rng = np.random.default_rng(30 + theta)
    ct = _words(rng, (6, p.lwe_n + 1))
    tv = _words(rng, (2, p.n) if theta == 0 else (6, 2, p.n))
    want = jx.blindrotate.blind_rotate(p, ck.bsk_kernel, ct, tv, theta=theta)
    got = blindrotate.blind_rotate(
        tck.params, keys.prepare_bootstrap_kernels(tck.bsk, tck.params),
        _t(ct), _t(tv), theta=theta)
    _eq(got, want)


@pytest.mark.parametrize("name", ["test_ext2", "test_ext3"])
def test_blind_rotate_extended(jx, name):
    p, jp = params.get_params(name), jx.params.get_params(name)
    k = p.poly_extend_factor
    bsk, _, _, _ = _random_key(p, 40 + k)
    rng = np.random.default_rng(41 + k)
    ct = _words(rng, (5, p.lwe_n + 1))
    lut = _words(rng, (k, 2, p.n))
    want = jx.blindrotate.blind_rotate_extended(
        jp, jx.keys.prepare_bootstrap_kernels(bsk, jp), ct, lut)
    got = blindrotate.blind_rotate_extended(
        p, keys.prepare_bootstrap_kernels(_t(bsk), p), _t(ct), _t(lut))
    assert got.shape == (5, k, 2, p.n)
    _eq(got, want)


def test_blind_rotate_block_portable(jx):
    p, jp = params.TEST_BLOCK, jx.params.TEST_BLOCK
    assert p.lwe_n % p.block_size                  # a ragged tail too
    bsk, _, _, _ = _random_key(p, 50)
    rng = np.random.default_rng(51)
    ct = _words(rng, (5, p.lwe_n + 1))
    tv = _words(rng, (5, 2, p.n))
    want = jx.blindrotate.blind_rotate_block(
        jp, jx.keys.prepare_bootstrap_kernels(bsk, jp), ct, tv)
    got = blindrotate.blind_rotate_block_portable(
        p, keys.prepare_bootstrap_kernels(_t(bsk), p), _t(ct), _t(tv))
    _eq(got, want)


# ---------------------------------------------------------------------------
# The conv-form polymul functions.
# ---------------------------------------------------------------------------

POLYMUL = ["conv_kernel_from_poly", "extprod_kernel_from_trgsw",
           "negacyclic_extprod_i32", "negacyclic_extprod_i8",
           "negacyclic_mul_fixed"]


def _polymul_case(jx, fn, n, l2, rng):
    """(the JAX result, the port's) of ``fn`` on the same inputs."""
    jp, tp = jx.polymul, polymul
    trgsw = _words(rng, (l2, 2, n))
    if fn == "conv_kernel_from_poly":
        return (jp.conv_kernel_from_poly(trgsw),
                tp.conv_kernel_from_poly(_t(trgsw)))
    if fn == "extprod_kernel_from_trgsw":
        return (jp.extprod_kernel_from_trgsw(trgsw),
                tp.extprod_kernel_from_trgsw(_t(trgsw)))
    if fn == "negacyclic_mul_fixed":
        a = _words(rng, (l2, n))
        return (jp.negacyclic_mul_fixed(a, trgsw[0, 0]),
                tp.negacyclic_mul_fixed(_t(a), _t(trgsw[0, 0])))
    kern = jp.extprod_kernel_from_trgsw(trgsw)
    if fn == "negacyclic_extprod_i32":
        digits = _words(rng, (5, l2, n)).view(np.int32)
        return (jp.negacyclic_extprod_i32(digits, kern),
                tp.negacyclic_extprod_i32(torch.from_numpy(digits),
                                          torch.from_numpy(np.array(kern))))
    digits = rng.integers(-128, 128, (5, l2, n)).astype(np.int8)
    digits.reshape(-1)[:4] = [-128, 127, 0, -1]
    kern_i8 = np.array(jp.split_balanced_limbs_i8(kern, 4))
    return (jp.negacyclic_extprod_i8(digits, kern_i8),
            tp.negacyclic_extprod_i8(torch.from_numpy(digits),
                                     torch.from_numpy(kern_i8)))


@pytest.mark.parametrize("l2", [4, 6])
@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("fn", POLYMUL)
def test_polymul_forms(jx, fn, n, l2):
    want, got = _polymul_case(jx, fn, n, l2, np.random.default_rng(n + l2))
    assert got.shape == np.asarray(want).shape
    assert got.dtype == torch.int32
    _eq(got, want)


def test_conv_forms_equal_the_toeplitz_form():
    """The i32 and i8 conv forms give the band's Toeplitz product."""
    rng = np.random.default_rng(60)
    n, l2 = 128, 4
    trgsw = _t(_words(rng, (l2, 2, n)))
    digits = torch.from_numpy(rng.integers(-128, 128, (3, l2, n)))
    want = polymul.negacyclic_extprod_toeplitz(
        digits.to(torch.int32), polymul.ext_band_from_trgsw(trgsw))
    kern = polymul.extprod_kernel_from_trgsw(trgsw)
    assert torch.equal(polymul.negacyclic_extprod_i32(
        digits.to(torch.int32), kern), want)
    assert torch.equal(polymul.negacyclic_extprod_i8(
        digits.to(torch.int8), polymul.split_balanced_limbs_i8(kern, 4)),
        want)


# ---------------------------------------------------------------------------
# The engine's portable routes.
# ---------------------------------------------------------------------------

ROUTES = ["blind_rotate", "blind_rotate_extended",
          "blind_rotate_block_portable", "many"]


def _route_inputs(p, seed, batch=5):
    rng = np.random.default_rng(seed)
    k = p.poly_extend_factor
    ct = _words(rng, (batch, p.lwe_n + 1))
    tv = _words(rng, (2, p.n) if k == 1 else (k, 2, p.n))
    return ct, tv


def _route_profile(route):
    return {"blind_rotate": "test_fast", "many": "test_fast",
            "blind_rotate_extended": "test_ext2",
            "blind_rotate_block_portable": "test_block"}[route]


def _port_route(ck, route, ct, tv):
    if route == "many":
        return engine.bootstrap_many(ck, ct, tv, k=2, theta=1,
                                     route="blind_rotate")
    return engine._bootstrap(ck, ct, tv, True, plain=False, route=route)


@pytest.mark.parametrize("route", ROUTES)
def test_engine_route_matches_jax_core(jx, fast_keys, route):
    name = _route_profile(route)
    p, jp = params.get_params(name), jx.params.get_params(name)
    if name == "test_fast":
        _, _, jck = fast_keys
        bsk, ksk = np.asarray(jck.bsk), np.asarray(jck.ksk)
        tck = _port_ck(jck)
    else:
        bsk, ksk, _, tck = _random_key(p, 70)
    d = jx.keys.prepare_bootstrap_kernels(bsk, jp)
    ct, tv = _route_inputs(p, 71)
    core = {"blind_rotate": jx.engine._bootstrap_core,
            "blind_rotate_extended": jx.engine._bootstrap_core_ext,
            "blind_rotate_block_portable": jx.engine._bootstrap_core_block}
    if route == "many":
        want = jx.engine._bootstrap_core_many(jp, True, 2, 1, d, ksk, ct, tv)
    else:
        want = core[route](jp, True, d, ksk, ct, tv)
    cuda_t.reset_launch_counts()
    got = _port_route(tck, route, _t(ct), _t(tv))
    assert not any(cuda_t.launch_counts.values())
    _eq(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_portable_route_equals_kernels_plain_path(route):
    """The portable words equal the kernels' plain path on the same key:
    blind_rotate_t, blind_rotate_extended_t and blind_rotate_block (no key
    limb is dropped at these profiles)."""
    p = params.get_params(_route_profile(route))
    *_, ck = _random_key(p, 80)
    ct, tv = map(_t, _route_inputs(p, 81))
    if route == "many":
        want = engine.bootstrap_many(ck, ct, tv, k=2, theta=1, plain=True)
    else:
        kernel_route = {"blind_rotate": "blind_rotate_t",
                        "blind_rotate_extended": "blind_rotate_extended_t",
                        "blind_rotate_block_portable": "blind_rotate_block"}
        want = engine._bootstrap(ck, ct, tv, True, plain=True,
                                 route=kernel_route[route])
    assert torch.equal(_port_route(ck, route, ct, tv), want)


def test_route_choice_unchanged():
    """No key takes a portable route unless asked: _route still names a
    kernel rotation, and bootstrap_many refuses an unknown route."""
    for name in ("test_fast", "test_ext2", "test_block"):
        *_, ck = _random_key(params.get_params(name), 90)
        assert not blindrotate.ROUTES[engine._route(ck)].portable
    *_, ck = _random_key(params.TEST_FAST, 91)
    ct, tv = map(_t, _route_inputs(params.TEST_FAST, 92))
    with pytest.raises(ValueError, match="no route"):
        engine.bootstrap_many(ck, ct, tv, k=2, route="blind_rotate_block")


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's forms have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_portable_route_on_gpu_matches_cpu_plain(cuda_device, route):
    """A portable route on the card == the kernels' plain path on the
    CPU, and no kernel is launched."""
    p = params.get_params(_route_profile(route))
    *_, ck = _random_key(p, 100)
    ct, tv = map(_t, _route_inputs(p, 101, batch=33))
    if route == "many":
        want = engine.bootstrap_many(ck, ct, tv, k=2, theta=1, plain=True)
    else:
        kernel_route = {"blind_rotate": "blind_rotate_t",
                        "blind_rotate_extended": "blind_rotate_extended_t",
                        "blind_rotate_block_portable": "blind_rotate_block"}
        want = engine._bootstrap(ck, ct, tv, True, plain=True,
                                 route=kernel_route[route])
    cuda_t.reset_launch_counts()
    got = _port_route(ck.to(cuda_device), route, ct.to(cuda_device),
                      tv.to(cuda_device))
    assert not any(cuda_t.launch_counts.values())
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 5, 17, 33, 4096])
def test_extprod_i8_on_gpu_matches_cpu(cuda_device, batch):
    """negacyclic_extprod_i8's _int_mm form on the card == its CPU form, at
    128bit_fast's N 1024 and 2L 4, batches below and above the card's
    16-row minimum."""
    rng = np.random.default_rng(batch)
    n, l2 = 1024, 4
    kern = polymul.extprod_kernel_from_trgsw(_t(_words(rng, (l2, 2, n))))
    kern_i8 = polymul.split_balanced_limbs_i8(kern, 4)
    digits = torch.from_numpy(
        rng.integers(-128, 128, (batch, l2, n)).astype(np.int8))
    want = polymul.negacyclic_extprod_i8(digits, kern_i8)
    got = polymul.negacyclic_extprod_i8(digits.to(cuda_device),
                                        kern_i8.to(cuda_device))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
