"""Block-binary keys and the block blind rotation in the port, the engine's
routing, and the engine's row-major extended route, against the JAX
package (Pallas kernels in interpret mode).

The port routes as the JAX package's TPU dispatch does
(``engine._tpu_core_choice``): block-binary keys take the block rotation
(K7 + K8) only with ``engine.PREFER_BLOCK_ROTATION``, else the per-bit
path (K1 + K2).  (The JAX package's CPU backend always runs them through
its portable block rotation.)  So each test names the JAX core it compares
with: ``_bootstrap_core_block`` / ``blind_rotate_block[_tpu]`` with the
flag on, ``_bootstrap_core`` with it off.  Tolerance is 0 throughout.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, engine, gates, keys, lut, params  # noqa: E402
from go_tfhe_tpu_torch.ops.blindrotate import blind_rotate_block  # noqa: E402
from go_tfhe_tpu_torch.ops.cuda_ext_t import ext_t_fits  # noqa: E402
from go_tfhe_tpu_torch.utils.rng import block_binary_key  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

A = np.resize([False, False, True, True], 8)
B = np.resize([False, True, False, True], 8)
TRUTH = {
    "NAND": ~(A & B), "AND": A & B, "OR": A | B, "XOR": A ^ B,
    "XNOR": ~(A ^ B), "NOR": ~(A | B), "ANDNY": ~A & B, "ANDYN": A & ~B,
    "ORNY": ~A | B, "ORYN": A | ~B,
}

_BASE = dict(lwe_alpha=1.0 / (1 << 24), n=256, lv1_alpha=1.0 / (1 << 30),
             nbit=8, basebit=4, iks_t=6)
# N = 256 block profiles the Pallas block kernel tiles: bs 2 with a ragged
# tail (9 = 4*2 + 1), and the 128bit_fast knobs (on-grid key, lowest key
# limb dropped) at bs 3 (7 = 2*3 + 1).
BLOCK2 = params.TFHEParams(name="t_block2", lwe_n=9, bgbit=8, l=2,
                           block_size=2, **_BASE)
BLOCK3_LO1 = params.TFHEParams(
    name="t_block3_lo1", lwe_n=7, bgbit=8, l=2, block_size=3,
    kernel_limb_drop=1, key_grid_bits=8, centered_decomposition=True,
    **_BASE)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, with the row-major Pallas kernels in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from go_tfhe_tpu.ops import pallas_ext, pallas_extprod, pallas_rotate
    for mod in (pallas_ext, pallas_extprod, pallas_rotate):
        mod.INTERPRET = True
    import go_tfhe_tpu
    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import engine as jengine
    from go_tfhe_tpu import keys as jkeys
    from go_tfhe_tpu import lut as jlut
    from go_tfhe_tpu.ops import blindrotate as jbr
    return types.SimpleNamespace(jax=jax, jnp=jnp, tfhe=go_tfhe_tpu,
                                 cipher=jcipher, engine=jengine, keys=jkeys,
                                 lut=jlut, br=jbr)


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _port_ck(p, ck):
    return keys.cloud_key_from_numpy(p, np.asarray(ck.testvec),
                                     np.asarray(ck.ksk), np.asarray(ck.bsk),
                                     ck.block_binary, device="cpu")


def _jax_block_keys(jx, p, seed, bands="auto"):
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(seed))
    jp = _jparams(jx, p)
    sk = jx.tfhe.gen_secret_key(k1, jp, block_binary=True)
    ck = jx.tfhe.gen_cloud_key(k2, sk, jp, bands=bands)
    assert ck.block_binary
    return sk, ck, _port_ck(p, ck)


# ---------------------------------------------------------------------------
# Keygen.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs,seed", [(17, 2, 0), (700, 3, 1), (1071, 7, 2)])
def test_block_binary_key_weight(n, bs, seed):
    """Every block, the ragged tail included, has Hamming weight <= 1;
    nonzero blocks occur, and so do empty ones."""
    bits = block_binary_key(torch.Generator().manual_seed(seed), n, bs,
                            "cpu")
    assert bits.shape == (n,) and bits.dtype == torch.int32
    assert set(bits.unique().tolist()) <= {0, 1}
    full = n // bs
    weights = bits[:full * bs].reshape(full, bs).sum(dim=1)
    assert weights.max().item() == 1 and weights.min().item() == 0
    assert bits[full * bs:].sum().item() <= 1


def test_block_binary_key_patterns_uniform():
    """Each block is uniform over its bs + 1 patterns (bs 3: empty or one
    of three positions), within 5 standard deviations."""
    bits = block_binary_key(torch.Generator().manual_seed(4), 3 * 20000, 3,
                            "cpu").reshape(-1, 3)
    counts = np.asarray([int((bits.sum(1) == 0).sum())]
                        + [int(bits[:, j].sum()) for j in range(3)])
    expect, sd = 20000 / 4, np.sqrt(20000 * 0.25 * 0.75)
    assert np.abs(counts - expect).max() < 5 * sd, counts


def test_gen_secret_key_block_binary():
    gen = torch.Generator().manual_seed(0)
    assert not keys.gen_secret_key(gen, params.TEST_BLOCK, "cpu").block_binary
    sk = keys.gen_secret_key(gen, params.P128, "cpu", block_binary=True)
    assert sk.block_binary and sk.lv0.shape == (700,)
    assert sk.lv0[:699].reshape(-1, 3).sum(1).max().item() <= 1
    assert set(sk.lv1.unique().tolist()) == {0, 1}      # ring key: uniform
    with pytest.raises(ValueError, match="block_size"):
        keys.gen_secret_key(gen, params.TEST_FAST, "cpu", block_binary=True)


# ---------------------------------------------------------------------------
# Rotation parity.
# ---------------------------------------------------------------------------

def test_blind_rotate_block_matches_jax_portable(jx):
    """== JAX blind_rotate_block at TEST_BLOCK (8 block steps + 1 tail bit),
    per-ciphertext test vectors."""
    p = params.TEST_BLOCK
    _, ck, tck = _jax_block_keys(jx, p, 11)
    rng = np.random.default_rng(1)
    ct = _u32(rng, (8, p.lwe_n + 1))
    tv = _u32(rng, (8, 2, p.n))
    want = np.asarray(jx.br.blind_rotate_block(
        _jparams(jx, p), ck.bsk_kernel, jx.jnp.asarray(ct),
        jx.jnp.asarray(tv)))
    got = blind_rotate_block(p, tck.bands, _t(ct), _t(tv))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("p", [BLOCK2, BLOCK3_LO1], ids=lambda p: p.name)
def test_blind_rotate_block_matches_tpu_kernels(jx, p):
    """== JAX blind_rotate_block_tpu (K7 + K8 in interpret mode), shared
    test vector: bs 2, and bs 3 with the lowest key limb dropped."""
    _, ck, tck = _jax_block_keys(jx, p, 12, bands="all")
    ct = _u32(np.random.default_rng(2), (8, p.lwe_n + 1))
    want = np.asarray(jx.br.blind_rotate_block_tpu(
        _jparams(jx, p), ck.bsk_band, jx.jnp.asarray(ct), ck.testvec,
        tb=8))
    got = blind_rotate_block(p, tck.bands, _t(ct), tck.testvec)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


# ---------------------------------------------------------------------------
# The engine with block-binary keys.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_engine(jx):
    """JAX block-binary keys at TEST_BLOCK, the port's key from the same
    arrays, and 8 encrypted bit pairs."""
    p = params.TEST_BLOCK
    sk, ck, tck = _jax_block_keys(jx, p, 13)
    ka, kb = jx.jax.random.split(jx.jax.random.PRNGKey(14))
    ca = jx.cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = jx.cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    return sk, ck, tck, ca, cb


@pytest.mark.parametrize("gate", sorted(TRUTH))
def test_block_gates_match_jax_block_core(jx, block_engine, monkeypatch,
                                          gate):
    """Flag on: each gate == JAX ``_bootstrap_core_block`` on its prepared
    input, and decrypts to the truth table."""
    sk, ck, tck, ca, cb = block_engine
    monkeypatch.setattr(engine, "PREFER_BLOCK_ROTATION", True)
    assert engine._route(tck) == "blind_rotate_block"
    prep = getattr(jx.engine, "prepare_" + gate.lower())(ca, cb)
    want = np.asarray(jx.engine._bootstrap_core_block(
        ck.params, True, ck.bsk_kernel, ck.ksk, prep, ck.testvec))
    got = getattr(gates, gate)(tck, _t(ca), _t(cb))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(sk.lv0)).numpy(), TRUTH[gate])


def test_block_keys_flag_off_match_jax_per_bit_core(jx, block_engine):
    """Flag off (the default): the same keys ride the per-bit path, bit
    for bit the JAX ``_bootstrap_core``."""
    sk, ck, tck, ca, cb = block_engine
    assert not engine.PREFER_BLOCK_ROTATION
    assert engine._route(tck) == "blind_rotate_t"
    prep = jx.engine.prepare_nand(ca, cb)
    want = np.asarray(jx.engine._bootstrap_core(
        ck.params, True, ck.bsk_kernel, ck.ksk, prep, ck.testvec))
    got = gates.NAND(tck, _t(ca), _t(cb))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(sk.lv0)).numpy(), TRUTH["NAND"])


def test_block_pbs_native_keys(monkeypatch):
    """Flag on, the port's own block-binary keygen: a PBS with a look-up
    table (x -> 1 - x over 2 messages, as test_block_rotation.py:114) and
    bootstrap_many, which stays on the per-bit path."""
    p = params.TEST_BLOCK
    gen = torch.Generator().manual_seed(21)
    sk = keys.gen_secret_key(gen, p, "cpu", block_binary=True)
    ck = keys.gen_cloud_key(gen, sk, p)
    assert ck.block_binary
    monkeypatch.setattr(engine, "PREFER_BLOCK_ROTATION", True)
    msgs = np.resize([0, 1], 16)
    ct = cipher.lwe_encrypt_message(gen, msgs, 2, p.lwe_alpha, sk.lv0)
    out = lut.bootstrap_func(ck, ct, lambda x: 1 - x, 2)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(out, 2, sk.lv0).numpy(), 1 - msgs)
    a = torch.from_numpy(np.resize(A, 16))
    b = torch.from_numpy(np.resize(B, 16))
    ca = cipher.lwe_encrypt_bool(gen, a, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(gen, b, p.lwe_alpha, sk.lv0)
    out_and, out_or = gates.AND_OR(ck, ca, cb)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(out_and, sk.lv0).numpy(), (a & b).numpy())
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(out_or, sk.lv0).numpy(), (a | b).numpy())


def test_block_key_npz_both_ways(jx, block_engine, tmp_path):
    """``.npz`` keys written by either package load in the other with
    ``block_binary`` kept."""
    sk, ck, tck, _, _ = block_engine
    path = str(tmp_path / "jax_ck.npz")
    jx.keys.save_cloud_key(path, ck)
    loaded = keys.load_cloud_key(path, device="cpu")
    assert loaded.block_binary and loaded.params == params.TEST_BLOCK
    np.testing.assert_array_equal(loaded.bands.numpy(), tck.bands.numpy())
    spath = str(tmp_path / "jax_sk.npz")
    jx.keys.save_secret_key(spath, sk)
    tsk = keys.load_secret_key(spath, device="cpu")
    assert tsk.block_binary
    np.testing.assert_array_equal(to_numpy_u32(tsk.lv0), np.asarray(sk.lv0))
    path = str(tmp_path / "port_ck.npz")
    keys.save_cloud_key(path, tck)
    back = jx.keys.load_cloud_key(path)
    assert back.block_binary
    np.testing.assert_array_equal(np.asarray(back.bsk), np.asarray(ck.bsk))
    spath = str(tmp_path / "port_sk.npz")
    keys.save_secret_key(spath, tsk)
    assert jx.keys.load_secret_key(spath).block_binary


# ---------------------------------------------------------------------------
# Routing: every registered profile x {uniform, block-binary} x flag.
# ---------------------------------------------------------------------------

_JAX_CORE_ROUTE = {
    "_bootstrap_core_t": "blind_rotate_t",
    "_bootstrap_core_ext_t": "blind_rotate_extended_t",
    "_bootstrap_core_ext_tpu": "blind_rotate_extended_rm",
    "_bootstrap_core_block_tpu": "blind_rotate_block",
    "_bootstrap_core_tpu": "blind_rotate_tpu",
    "_bootstrap_core_pipe": "blind_rotate_pipe",
}


@pytest.mark.parametrize("prefer_block", [False, True])
def test_route_matches_tpu_core_choice(jx, monkeypatch, prefer_block):
    """The port's ``_route`` names the counterpart of the core that the JAX
    package's TPU dispatch picks, for every profile, key kind and flag
    (``PREFER_BLOCK_ROTATION``, ``PREFER_PIPE``): JAX keys with the band
    layouts its keygen builds (``_band_selection``) against transposed port
    keys, and JAX keys with only the row-major band against port keys with
    ``transposed=False``.  Profiles whose N the Pallas kernels do not tile
    (N 128) are asked at N 256, where the JAX dispatch has a core."""
    from go_tfhe_tpu.keys import CloudKey as JCloudKey
    from go_tfhe_tpu.keys import _band_selection
    monkeypatch.setattr(jx.engine, "_use_tpu_path", lambda p: True)
    monkeypatch.setattr(jx.engine, "PREFER_BLOCK_ROTATION", prefer_block)
    monkeypatch.setattr(engine, "PREFER_BLOCK_ROTATION", prefer_block)
    seen = set()
    for prefer_pipe in (False, True):
        monkeypatch.setattr(jx.engine, "PREFER_PIPE", prefer_pipe)
        monkeypatch.setattr(engine, "PREFER_PIPE", prefer_pipe)
        for p in sorted(set(params.PROFILES.values()), key=lambda p: p.name):
            jp = _jparams(jx, p)
            if jp.n % 256:
                jp = dataclasses.replace(jp, n=256, nbit=8)
            for block_binary in (False, True):
                for transposed in (True, False):
                    row, rev = (_band_selection(jp, block_binary, "auto")
                                if transposed else (True, False))
                    jck = JCloudKey(
                        testvec=None, ksk=None, bsk=None, bsk_kernel=None,
                        bsk_band=object() if row else None,
                        bsk_band_rev=object() if rev else None, params=jp,
                        block_binary=block_binary)
                    core, _ = jx.engine._tpu_core_choice(jck)
                    tck = keys.CloudKey(testvec=None, ksk=None, bsk=None,
                                        bands=None, params=p,
                                        block_binary=block_binary,
                                        transposed=transposed)
                    route = engine._route(tck)
                    assert route == _JAX_CORE_ROUTE[core.__name__], (
                        p.name, block_binary, transposed, prefer_pipe)
                    seen.add((p.name, block_binary, transposed, prefer_pipe,
                              route))
    for pipe in (False, True):
        assert ("uint8", False, True, pipe, "blind_rotate_extended_rm") in seen
        assert ("uint8_centered", True, True, pipe,
                "blind_rotate_extended_rm") in seen
        for name in ("uint6", "uint7", "uint6_centered", "uint7_centered"):
            assert (name, False, True, pipe, "blind_rotate_extended_t") in seen
            # ext_t_fits holds, but a key without the reversed band takes
            # the row-major extended kernels
            assert (name, False, False, pipe,
                    "blind_rotate_extended_rm") in seen
        # a per-bit key that is not transposed: the row-major per-bit path
        assert ("128bit_fast", False, False, pipe, "blind_rotate_tpu") in seen
        # a block-binary int8-digit key that is not transposed takes the
        # block rotation whatever PREFER_BLOCK_ROTATION says
        assert ("128bit_fast", True, False, pipe,
                "blind_rotate_block") in seen
        # wide-digit profiles (nd > 1) keep block-binary keys per bit, and
        # never take the pipelined path
        assert ("uint5", True, True, pipe, "blind_rotate_t") in seen
        assert ("uint1", True, True, pipe, "blind_rotate_t") in seen
        assert ("uint5", True, False, pipe, "blind_rotate_tpu") in seen
    assert ("128bit_fast", True, True, False, "blind_rotate_block"
            if prefer_block else "blind_rotate_t") in seen
    assert ("128bit_fast", False, True, True, "blind_rotate_pipe") in seen
    assert ("128bit", False, True, True, "blind_rotate_pipe") in seen
    assert ("128bit_fast", True, True, True, "blind_rotate_block"
            if prefer_block else "blind_rotate_pipe") in seen


# ---------------------------------------------------------------------------
# The engine's row-major extended route (uint8's, forced at TEST_EXT3).
# ---------------------------------------------------------------------------

def test_engine_row_major_extended_route_matches_jax(jx, monkeypatch):
    """With ``ext_t_fits`` forced False, ``engine.bootstrap`` at TEST_EXT3
    runs the row-major route (K6 + K8) and equals JAX
    ``_bootstrap_core_ext_tpu`` (interpret) bit for bit, with a LUT."""
    p = params.TEST_EXT3
    jp = jx.tfhe.get_params(p.name)
    k1, k2, k3 = jx.jax.random.split(jx.jax.random.PRNGKey(61), 3)
    sk = jx.tfhe.gen_secret_key(k1, jp)
    ck = jx.tfhe.gen_cloud_key(k2, sk, jp, bands="all")
    m = p.message_modulus
    msgs = np.arange(8) * 5 % m
    ct = jx.cipher.lwe_encrypt_message(k3, msgs, m, jp.lwe_alpha, sk.lv0)
    table = np.asarray(jx.lut.Generator(jp).gen_lut(
        lambda x: (2 * x + 3) % m))
    want = np.asarray(jx.engine._bootstrap_core_ext_tpu(
        jp, True, ck.bsk_band, ck.ksk, ct, jx.jnp.asarray(table)))
    tck = _port_ck(p, ck)
    assert ext_t_fits(p) and engine._route(tck) == "blind_rotate_extended_t"
    monkeypatch.setattr(engine, "ext_t_fits", lambda p: False)
    assert engine._route(tck) == "blind_rotate_extended_rm"
    got = engine.bootstrap(tck, _t(ct), testvec=_t(table))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_message(got, m, _t(sk.lv0)).numpy(),
        (2 * msgs + 3) % m)
