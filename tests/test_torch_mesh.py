"""The port's batch-sharded bootstrap (go_tfhe_tpu_torch/parallel/mesh.py)
against the JAX package's (go_tfhe_tpu/parallel/mesh.py) on the same keys
and ciphertexts, word for word.

JAX shards over the 8 virtual CPU devices of tests/conftest.py, with its
Pallas kernels in interpret mode (as tests/test_sharding_pallas.py runs
them); the port's mesh names the one ``cpu`` device s times.  The ``gpu``
cases run the mesh and the kernels on the card (K1/K2 on the last card
while card 0 is current needs two cards and skips on one); JAX is imported
only by the cases that use it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_mesh.py

Tolerance is 0 throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, engine, keys, params  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_t  # noqa: E402
from go_tfhe_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

BATCH = 16
A = np.resize([False, True], BATCH)
B = np.resize([False, False, True, True], BATCH)

# tests/test_sharding_pallas.py's P_PALLAS: N 256 tiles the Pallas kernels,
# lwe_n 8 keeps the interpreted loop short.
P_PALLAS = params.TFHEParams(
    name="test_shard_pallas", lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
    lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=8, l=2, basebit=4, iks_t=6,
    block_size=1)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: its mesh over the 8 virtual CPU devices, the Pallas
    kernels in interpret mode."""
    pytest.importorskip("jax")
    import jax

    from go_tfhe_tpu.ops import (pallas_extprod, pallas_pipe, pallas_rotate,
                                 pallas_step, pallas_t)
    for mod in (pallas_extprod, pallas_pipe, pallas_rotate, pallas_step,
                pallas_t):
        mod.INTERPRET = True
    import go_tfhe_tpu
    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import engine as jengine
    from go_tfhe_tpu import lut as jlut
    from go_tfhe_tpu.parallel import mesh as jmesh
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return types.SimpleNamespace(
        jax=jax, tfhe=go_tfhe_tpu, cipher=jcipher, engine=jengine, lut=jlut,
        mesh=jmesh, mesh8=jmesh.make_mesh())


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _port_ck(ck):
    return keys.cloud_key_from_numpy(
        params.TFHEParams(**dataclasses.asdict(ck.params)),
        np.asarray(ck.testvec), np.asarray(ck.ksk), np.asarray(ck.bsk),
        ck.block_binary, device="cpu")


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _cpu_mesh(s):
    return meshlib.make_mesh(["cpu"] * s)


@pytest.fixture(scope="module")
def fast(jx, fast_keys):
    """TEST_FAST keys, a NAND batch and a batch of messages with one table
    per ciphertext (f_i(x) = x xor (i mod 2)); JAX's sharded outputs of
    both on its 8-device mesh."""
    p, sk, ck = fast_keys
    ka, kb, km = jx.jax.random.split(jx.jax.random.PRNGKey(5), 3)
    ca = jx.cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = jx.cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    nand = jx.engine.prepare_nand(ca, cb)
    m = p.message_modulus
    msgs = np.arange(BATCH) % m
    cm = jx.cipher.lwe_encrypt_message(km, msgs, m, p.lwe_alpha, sk.lv0)
    gen = jx.lut.Generator(p, m)
    tables = np.stack([np.asarray(gen.gen_lut(lambda x, i=i: x ^ (i % 2)))
                       for i in range(BATCH)])
    want = {
        "nand": np.asarray(jx.mesh.sharded_bootstrap(jx.mesh8, ck, nand)),
        "per_ct_table": np.asarray(jx.mesh.sharded_bootstrap(
            jx.mesh8, ck, cm, jx.jax.numpy.asarray(tables))),
    }
    inputs = {"nand": (_t(nand), None),
              "per_ct_table": (_t(cm), _t(tables))}
    truth = {"nand": ~(A & B), "per_ct_table": msgs ^ (np.arange(BATCH) % 2)}
    return types.SimpleNamespace(p=p, sk=sk, tck=_port_ck(ck), want=want,
                                 inputs=inputs, truth=truth)


@pytest.mark.parametrize("case", ["nand", "per_ct_table"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_bootstrap_matches_jax(fast, shards, case):
    """The port's sharded_bootstrap over ``["cpu"] * shards`` equals JAX's
    sharded_bootstrap on its 8 devices, and the outputs decrypt to the
    truth."""
    ct, tv = fast.inputs[case]
    got = meshlib.sharded_bootstrap(_cpu_mesh(shards), fast.tck, ct, tv)
    np.testing.assert_array_equal(to_numpy_u32(got), fast.want[case])
    key = _t(fast.sk.lv0)
    dec = (cipher.lwe_decrypt_bool(got, key) if case == "nand" else
           cipher.lwe_decrypt_message(got, fast.p.message_modulus, key))
    np.testing.assert_array_equal(dec.numpy(), fast.truth[case])


@pytest.fixture(scope="module")
def pallas(jx):
    """P_PALLAS keys with both bands, and a NAND batch."""
    jax = jx.jax
    p = _jparams(jx, P_PALLAS)
    k1, k2, ka, kb = jax.random.split(jax.random.PRNGKey(17), 4)
    sk = jx.tfhe.gen_secret_key(k1, p)
    ck = jx.tfhe.gen_cloud_key(k2, sk, p, bands="all")
    ca = jx.cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = jx.cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    return sk, ck, jx.engine.prepare_nand(ca, cb)


@pytest.mark.parametrize("key_switch", [True, False])
def test_sharded_bootstrap_cuda_matches_pallas(jx, pallas, key_switch):
    """sharded_bootstrap_cuda (K1/K2's plain versions on the CPU) equals
    JAX's sharded_bootstrap_pallas (the transposed Pallas core per shard),
    with and without the key switch."""
    sk, ck, prepared = pallas
    want = np.asarray(jx.mesh.sharded_bootstrap_pallas(
        jx.mesh8, ck, prepared, key_switch=key_switch))
    tck = _port_ck(ck)
    assert engine._route(tck) == "blind_rotate_t"
    got = meshlib.sharded_bootstrap_cuda(_cpu_mesh(4), tck, _t(prepared),
                                         key_switch=key_switch)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    key = sk.lv0 if key_switch else sk.lv1
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(key)).numpy(), ~(A & B))


@pytest.fixture(scope="module")
def block_pallas(jx):
    """A block-binary key at P_PALLAS with block_size 2 (N 256, lwe_n 8),
    with the bands JAX's keygen builds for it (row-major and reversed),
    and a NAND batch."""
    jax = jx.jax
    p = _jparams(jx, dataclasses.replace(P_PALLAS, name="test_shard_block",
                                         block_size=2))
    k1, k2, ka, kb = jax.random.split(jax.random.PRNGKey(23), 4)
    sk = jx.tfhe.gen_secret_key(k1, p, block_binary=True)
    ck = jx.tfhe.gen_cloud_key(k2, sk, p)
    assert ck.bsk_band is not None and ck.bsk_band_rev is not None
    ca = jx.cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = jx.cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    return sk, ck, jx.engine.prepare_nand(ca, cb)


@pytest.mark.parametrize("key_switch", [True, False])
def test_sharded_bootstrap_cuda_never_takes_the_block_core(
        jx, block_pallas, monkeypatch, key_switch):
    """With PREFER_BLOCK_ROTATION set in both packages, a block-binary key
    at N 256 takes the block rotation through engine.bootstrap, but
    sharded_bootstrap_cuda runs the per-bit core that JAX's
    sharded_bootstrap_pallas runs (``_bootstrap_core_t``; it never takes
    the block core) and equals it word for word, with and without the key
    switch."""
    monkeypatch.setattr(jx.engine, "PREFER_BLOCK_ROTATION", True)
    monkeypatch.setattr(engine, "PREFER_BLOCK_ROTATION", True)
    sk, ck, prepared = block_pallas
    want = np.asarray(jx.mesh.sharded_bootstrap_pallas(
        jx.mesh8, ck, prepared, key_switch=key_switch))
    tck = _port_ck(ck)
    assert engine._route(tck) == "blind_rotate_block"
    got = meshlib.sharded_bootstrap_cuda(_cpu_mesh(4), tck, _t(prepared),
                                         key_switch=key_switch)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    key = sk.lv0 if key_switch else sk.lv1
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(key)).numpy(), ~(A & B))


def test_sharded_bootstrap_cuda_row_major_block_key(jx, block_pallas):
    """The same key with ``transposed=False`` (a JAX key with only the
    row-major band): sharded_bootstrap_cuda runs ``blind_rotate_tpu``, the
    counterpart of JAX's row-band core ``_bootstrap_core_tpu``, and equals
    sharded_bootstrap_pallas word for word."""
    sk, ck, prepared = block_pallas
    jck = dataclasses.replace(ck, bsk_band_rev=None)
    want = np.asarray(jx.mesh.sharded_bootstrap_pallas(jx.mesh8, jck,
                                                       prepared))
    tck = dataclasses.replace(_port_ck(ck), transposed=False)
    assert engine._route(tck) == "blind_rotate_block"
    got = meshlib.sharded_bootstrap_cuda(_cpu_mesh(2), tck, _t(prepared))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(sk.lv0)).numpy(), ~(A & B))


def test_sharded_bootstrap_cuda_block_key(jx):
    """A block-binary TEST_BLOCK key (N 128): JAX's
    sharded_bootstrap_pallas refuses it (no Pallas band at N % 256 != 0)
    and so does the port's sharded_bootstrap_cuda; the port's
    sharded_bootstrap runs the route engine._route gives it, the block
    rotation, and equals JAX's sharded_bootstrap (its portable block core)
    word for word."""
    jax = jx.jax
    p = jx.tfhe.TEST_BLOCK
    k1, k2, ka, kb = jax.random.split(jax.random.PRNGKey(29), 4)
    sk = jx.tfhe.gen_secret_key(k1, p, block_binary=True)
    ck = jx.tfhe.gen_cloud_key(k2, sk, p)
    ca = jx.cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = jx.cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    prepared = jx.engine.prepare_nand(ca, cb)
    with pytest.raises(AssertionError, match="not Pallas-eligible"):
        jx.mesh.sharded_bootstrap_pallas(jx.mesh8, ck, prepared)
    tck = _port_ck(ck)
    with pytest.raises(ValueError, match="not Pallas-eligible"):
        meshlib.sharded_bootstrap_cuda(_cpu_mesh(2), tck, _t(prepared))
    want = np.asarray(jx.mesh.sharded_bootstrap(jx.mesh8, ck, prepared))
    assert engine._route(tck) == "blind_rotate_block"
    got = meshlib.sharded_bootstrap(_cpu_mesh(2), tck, _t(prepared))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_refusals(jx, fast, pallas):
    """A batch the shards do not divide (sharded_bootstrap_cuda on an N 256
    key: it refuses TEST_FAST's N 128 first, as the JAX function asserts
    on it), and an extended profile in sharded_bootstrap_cuda (the JAX
    function asserts on it), raise."""
    ct, _ = fast.inputs["nand"]
    for fn, tck in ((meshlib.sharded_bootstrap, fast.tck),
                    (meshlib.sharded_bootstrap_cuda, _port_ck(pallas[1]))):
        with pytest.raises(ValueError, match="not divisible"):
            fn(_cpu_mesh(4), tck, ct[:6])
    p = _jparams(jx, params.TEST_EXT2)
    jck = jx.tfhe.gen_cloud_key_no_ksk(p)
    jct = jx.jax.numpy.zeros((4, p.lwe_n + 1), jx.jax.numpy.uint32)
    with pytest.raises(AssertionError, match="extended profiles"):
        jx.mesh.sharded_bootstrap_pallas(jx.mesh8, jck, jct)
    tck = keys.gen_cloud_key_no_ksk(params.TEST_EXT2, device="cpu")
    with pytest.raises(ValueError, match="extended profiles"):
        meshlib.sharded_bootstrap_cuda(_cpu_mesh(2), tck, _t(jct))


def test_extended_profile_through_sharded_bootstrap():
    """sharded_bootstrap serves an extended profile (TEST_EXT2, k 2; K4/K5
    on the card): a shared (k, 2, N) table is not split, a per-ciphertext
    one is, and the words equal engine.bootstrap's."""
    p = params.TEST_EXT2
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    ct = cipher.lwe_encrypt_message(gen, np.arange(4) % p.message_modulus,
                                    p.message_modulus, p.lwe_alpha, sk.lv0)
    tv = torch.stack([ck.testvec, ck.testvec.roll(1, -1), ck.testvec,
                      ck.testvec.roll(3, -1)])
    for table in (None, ck.testvec, tv):
        np.testing.assert_array_equal(
            meshlib.sharded_bootstrap(_cpu_mesh(2), ck, ct, table).numpy(),
            engine.bootstrap(ck, ct, table).numpy())


def test_mesh_shards_and_keys():
    """make_mesh keeps repeats and order; shard_batch splits the leading
    axis into equal contiguous shards; replicate_keys gives one key per
    distinct device; make_mesh() takes the CUDA devices and raises
    without one."""
    mesh = meshlib.make_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert mesh == (torch.device("cpu"),) * 3
    x = torch.arange(12).reshape(6, 2)
    shards = meshlib.shard_batch(mesh, x)
    assert [s.tolist() for s in shards] == [x[:2].tolist(), x[2:4].tolist(),
                                            x[4:].tolist()]
    ck = keys.gen_cloud_key_no_ksk(params.TEST_FAST, device="cpu")
    assert list(meshlib.replicate_keys(mesh, ck)) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.shard_batch(mesh, x[:4])
    if torch.cuda.is_available():
        assert meshlib.make_mesh() == tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshlib.make_mesh()


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_mesh_on_gpu_matches_unsharded(cuda_device):
    """A mesh naming the card twice, and a mesh of every card, equal the
    unsharded bootstrap on the card, with 2 x lwe_n K1/K2 launches on the
    first; sharded_bootstrap_cuda refuses that TEST_FAST key (N 128, as
    the JAX function does), and on a P_PALLAS key (N 256) without the key
    switch equals bootstrap_without_key_switch."""
    p = params.TEST_FAST
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    sk = keys.gen_secret_key(gen, p, cuda_device)
    ck = keys.gen_cloud_key(gen, sk, p)
    ca = cipher.lwe_encrypt_bool(gen, A, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(gen, B, p.lwe_alpha, sk.lv0)
    prepared = engine.prepare_nand(ca, cb)
    want = engine.bootstrap(ck, prepared)
    cuda_t.reset_launch_counts()
    got = meshlib.sharded_bootstrap(
        meshlib.make_mesh([cuda_device] * 2), ck, prepared)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["rotate_decompose_t"] == 2 * p.lwe_n
    assert cuda_t.launch_counts["extprod_t"] == 2 * p.lwe_n
    assert torch.equal(got, want)
    assert torch.equal(meshlib.sharded_bootstrap(meshlib.make_mesh(), ck,
                                                 prepared), want)
    mesh4 = meshlib.make_mesh([cuda_device] * 4)
    with pytest.raises(ValueError, match="not Pallas-eligible"):
        meshlib.sharded_bootstrap_cuda(mesh4, ck, prepared)
    sk = keys.gen_secret_key(gen, P_PALLAS, cuda_device)
    ck = keys.gen_cloud_key(gen, sk, P_PALLAS)
    prepared = engine.prepare_nand(
        cipher.lwe_encrypt_bool(gen, A, P_PALLAS.lwe_alpha, sk.lv0),
        cipher.lwe_encrypt_bool(gen, B, P_PALLAS.lwe_alpha, sk.lv0))
    assert torch.equal(
        meshlib.sharded_bootstrap_cuda(mesh4, ck, prepared, key_switch=False),
        engine.bootstrap_without_key_switch(ck, prepared))


@pytest.mark.gpu
def test_kernels_launch_on_the_inputs_card():
    """K1 and K2 on tensors of the last card, with card 0 current, equal
    their plain versions: the wrappers launch on the inputs' card
    (ops/cuda_t.launch).  Needs two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a launch on a card that is not "
                    "current")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    p, b = params.P128_FAST, 129
    nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
    gen = torch.Generator().manual_seed(6)
    acc = torch.randint(-2 ** 31, 2 ** 31, (2, p.n, b), dtype=torch.int32,
                        generator=gen)
    amounts = torch.randint(0, 2 * p.n + 1, (b,), dtype=torch.int32,
                            generator=gen)
    bsk = torch.randint(-2 ** 31, 2 ** 31, (1, 2 * p.l, 2, p.n),
                        dtype=torch.int32, generator=gen)
    bsk &= ~((1 << p.key_grid_bits) - 1)
    band = cuda_t.pack_bsk_band_t(bsk, lo)[0].contiguous()
    want_d = cuda_t.rotate_decompose_t_ref(p, acc, amounts)
    want_o = cuda_t.extprod_t_ref(want_d, band, acc, nd, lo)
    with torch.cuda.device(0):
        d = cuda_t.rotate_decompose_t(p, acc.to(dev), amounts.to(dev))
        o = cuda_t.extprod_t(d, band.to(dev), acc.to(dev), nd, lo)
    torch.cuda.synchronize(dev)
    assert d.device == dev and o.device == dev
    assert torch.equal(d.cpu(), want_d)
    assert torch.equal(o.cpu(), want_o)
