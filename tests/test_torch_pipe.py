"""The half-batch pipelined step K9 (ops/cuda_pipe.py), the blind rotation
``blind_rotate_pipe`` that drives it and the engine's route to it
(``engine.PREFER_PIPE``), against the JAX package (Pallas kernels in
interpret mode, as tests/test_pallas_pipe.py runs them).

On the CPU the wrappers run the kernels' plain versions; the ``gpu`` cases
hold the Hopper kernel against its plain version on the card and skip
without one.  JAX is imported only by the cases that use it, so the
``gpu`` cases also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_pipe.py

Tolerance is 0 throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, engine, gates, keys, params  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_pipe, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.ops.blindrotate import blind_rotate_t  # noqa: E402
from go_tfhe_tpu_torch.ops.cuda_pipe import blind_rotate_pipe  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

A = np.resize([False, False, True, True], 8)
B = np.resize([False, True, False, True], 8)
TRUTH = {
    "NAND": ~(A & B), "AND": A & B, "OR": A | B, "XOR": A ^ B,
    "XNOR": ~(A ^ B), "NOR": ~(A | B), "ANDNY": ~A & B, "ANDYN": A & ~B,
    "ORNY": ~A | B, "ORYN": A | ~B,
}

# tests/test_pallas_pipe.py's TEST_PALLAS, and its on-grid variant with
# the lowest key limb dropped.
TEST_PALLAS = params.TFHEParams(
    name="test_pallas", lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
    lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=8, l=3, basebit=4, iks_t=6,
    block_size=1)
PALLAS_GRID = dataclasses.replace(
    TEST_PALLAS, name="test_pallas_pipe_grid", key_grid_bits=8,
    kernel_limb_drop=1, centered_decomposition=True)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, with the Pallas kernels in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from go_tfhe_tpu.ops import pallas_pipe, pallas_t
    for mod in (pallas_pipe, pallas_t):
        mod.INTERPRET = True
    import go_tfhe_tpu
    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import engine as jengine
    from go_tfhe_tpu.ops import blindrotate as jbr
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, tfhe=go_tfhe_tpu, cipher=jcipher, engine=jengine,
        br=jbr, pallas_pipe=pallas_pipe, pallas_t=pallas_t)


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(x, device="cpu"):
    return from_numpy_u32(np.asarray(x), device)


def _pipe_inputs(p, bx, by, seed, device="cpu"):
    """K9's inputs: half X's digits (plain K1 of a random accumulator),
    one bit's band, both halves' accumulators and half Y's amounts (0, N,
    2N - 1 and 2N among them).  Returns (args for pipe_step, raw BSK)."""
    rng = np.random.default_rng(seed)
    acc_x, acc_y = _u32(rng, (2, p.n, bx)), _u32(rng, (2, p.n, by))
    amt_x = rng.integers(0, 2 * p.n + 1, bx).astype(np.int32)
    amt_y = rng.integers(0, 2 * p.n + 1, by).astype(np.int32)
    amt_y[:4] = [0, p.n, 2 * p.n - 1, 2 * p.n][:by]
    bsk = _u32(rng, (1, 2 * p.l, 2, p.n))
    if p.key_grid_bits:
        bsk &= np.uint32(0xFFFFFFFF ^ ((1 << p.key_grid_bits) - 1))
    acc_x, acc_y = _t(acc_x, device), _t(acc_y, device)
    digits_x = cuda_t.rotate_decompose_t_ref(
        p, acc_x, torch.from_numpy(amt_x).to(device))
    band = cuda_t.pack_bsk_band_t(_t(bsk, device), p.kernel_limb_drop)[0]
    args = (digits_x, band.contiguous(), acc_x, acc_y,
            torch.from_numpy(amt_y).to(device))
    return args, bsk


# ---------------------------------------------------------------------------
# Plain K9 against the Pallas kernel.
# ---------------------------------------------------------------------------

def test_pipe_step_ref_matches_pallas(jx):
    """One call == JAX pipe_step (interpret) at N 256, B2 8, against its
    reversed band."""
    p = TEST_PALLAS
    (digits_x, band, acc_x, acc_y, amt_y), bsk = _pipe_inputs(p, 8, 8, 1)
    jnp = jx.jnp
    want_x, want_y = jx.pallas_pipe.pipe_step(
        _jparams(jx, p), jnp.asarray(digits_x.numpy()),
        jx.pallas_t.pack_bsk_band_rev(jnp.asarray(bsk))[0],
        jnp.asarray(to_numpy_u32(acc_x)), jnp.asarray(to_numpy_u32(acc_y)),
        jnp.asarray(amt_y.numpy()))
    got_x, got_y = cuda_pipe.pipe_step_ref(p, digits_x, band, acc_x, acc_y,
                                           amt_y)
    np.testing.assert_array_equal(to_numpy_u32(got_x), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    wx, wy = cuda_pipe.pipe_step(p, digits_x, band, acc_x, acc_y, amt_y)
    assert torch.equal(wx, got_x) and torch.equal(wy, got_y)


def test_pipe_step_refuses_wide_digits():
    p = dataclasses.replace(TEST_PALLAS, name="t_pipe_bg18", bgbit=18, l=1,
                            message_modulus=8)
    acc = torch.zeros((2, p.n, 4), dtype=torch.int32)
    digits = torch.zeros((3 * 2 * p.n, 4), dtype=torch.int8)
    band = torch.zeros((2, 2, 2 * p.n), dtype=torch.int32)
    amt = torch.zeros((4,), dtype=torch.int32)
    for fn in (cuda_pipe.pipe_step_ref, cuda_pipe.pipe_step):
        with pytest.raises(ValueError, match="single-limb"):
            fn(p, digits, band, acc, acc, amt)


def test_non_cpu_tensor_never_takes_the_plain_pipe_step():
    p = TEST_PALLAS
    acc = torch.empty((2, p.n, 4), dtype=torch.int32, device="meta")
    digits = torch.empty((6 * p.n, 4), dtype=torch.int8, device="meta")
    band = torch.empty((2, 6, 2 * p.n), dtype=torch.int32, device="meta")
    amt = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_pipe.pipe_step(p, digits, band, acc, acc, amt)


# ---------------------------------------------------------------------------
# blind_rotate_pipe.
# ---------------------------------------------------------------------------

def _jax_keys(jx, p, seed):
    jp = _jparams(jx, p)
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(seed))
    sk = jx.tfhe.gen_secret_key(k1, jp)
    ck = jx.tfhe.gen_cloud_key(k2, sk, jp)
    tck = keys.cloud_key_from_numpy(p, np.asarray(ck.testvec),
                                    np.asarray(ck.ksk), np.asarray(ck.bsk),
                                    device="cpu")
    return sk, ck, tck


@pytest.mark.parametrize("p,b", [(TEST_PALLAS, 16), (TEST_PALLAS, 15),
                                 (PALLAS_GRID, 16)],
                         ids=["b16", "b15_odd", "grid_lo1_b16"])
def test_blind_rotate_pipe_matches_jax_portable(jx, p, b):
    """== JAX portable blind_rotate (tests/test_pallas_pipe.py's check),
    an even and an odd batch (halves of 8 and 7), the shared test vector;
    one K1 and 2 lwe_n K9 calls, here all plain."""
    _, ck, tck = _jax_keys(jx, p, 3)
    ct = _u32(np.random.default_rng(31), (b, p.lwe_n + 1))
    want = np.asarray(jx.br.blind_rotate(_jparams(jx, p), ck.bsk_kernel,
                                         jx.jnp.asarray(ct), ck.testvec))
    cuda_t.reset_launch_counts()
    got = blind_rotate_pipe(p, tck.bands, _t(ct), tck.testvec)
    assert got.shape == (b, 2, p.n)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    assert cuda_t.launch_counts == dict.fromkeys(cuda_t.launch_counts, 0)


def test_blind_rotate_pipe_one_ciphertext():
    """B 1: half B is empty, and per-ciphertext test vectors split with
    the batch; the result is blind_rotate_t's."""
    p = TEST_PALLAS
    gen = torch.Generator().manual_seed(5)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    for b in (1, 3):
        ct = torch.randint(-2 ** 31, 2 ** 31, (b, p.lwe_n + 1),
                           dtype=torch.int32, generator=gen)
        tv = torch.randint(-2 ** 31, 2 ** 31, (b, 2, p.n), dtype=torch.int32,
                           generator=gen)
        np.testing.assert_array_equal(
            blind_rotate_pipe(p, ck.bands, ct, tv).numpy(),
            blind_rotate_t(p, ck.bands, ct, tv).numpy())


# ---------------------------------------------------------------------------
# The engine with PREFER_PIPE.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe_engine(jx):
    sk, ck, tck = _jax_keys(jx, params.TEST_FAST, 51)
    ka, kb = jx.jax.random.split(jx.jax.random.PRNGKey(52))
    p = ck.params
    ca = jx.cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = jx.cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    return sk, ck, tck, ca, cb


@pytest.mark.parametrize("gate", sorted(TRUTH))
def test_pipe_gates_match_jax_core(jx, pipe_engine, monkeypatch, gate):
    """Each gate through ``blind_rotate_pipe`` == JAX ``_bootstrap_core``
    on its prepared input (the value of the JAX ``_bootstrap_core_pipe``),
    and decrypts to the truth table."""
    sk, ck, tck, ca, cb = pipe_engine
    monkeypatch.setattr(engine, "PREFER_PIPE", True)
    assert engine._route(tck) == "blind_rotate_pipe"
    prep = getattr(jx.engine, "prepare_" + gate.lower())(ca, cb)
    want = np.asarray(jx.engine._bootstrap_core(
        ck.params, True, ck.bsk_kernel, ck.ksk, prep, ck.testvec))
    got = getattr(gates, gate)(tck, _t(ca), _t(cb))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(sk.lv0)).numpy(), TRUTH[gate])


# ---------------------------------------------------------------------------
# On the card: K9 against its plain version, and a blind rotation.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _misaligned(x):
    """x's values in a contiguous view 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("name,bx,by,misaligned", [
    ("128bit_fast", 256, 256, False), ("128bit_fast", 255, 256, False),
    ("128bit_fast", 256, 255, False), ("128bit_fast", 1, 0, False),
    ("128bit_fast", 0, 3, False), ("128bit", 200, 199, False),
    ("128bit_fast", 2048, 2047, False), ("128bit_fast", 2047, 2048, False),
    ("128bit_fast", 17, 33, False), ("128bit", 2048, 2048, False),
    ("128bit", 129, 127, False), ("128bit_fast", 256, 256, True),
    ("128bit", 64, 61, True), ("test_pbs", 100, 99, False),
    ("128bit", 200, 199, True), ("test_fast", 9, 7, False)])
def test_k9_matches_plain_on_gpu(cuda_device, name, bx, by, misaligned):
    """Full width (N 1024; 128bit_fast's dropped limb, 128bit's l 3), N
    512 and N 128, ragged and unequal halves, an empty half, and acc_y in
    a view 4 bytes off a 16-byte boundary (the Y blocks stage it in 4-byte
    copies)."""
    p = params.get_params(name)
    args, _ = _pipe_inputs(p, bx, by, 7, cuda_device)
    if misaligned:
        args = args[:3] + (_misaligned(args[3]),) + args[4:]
        assert args[3].data_ptr() % 16
    before = cuda_t.launch_counts["pipe_step"]
    out_x, dig_y = cuda_pipe.pipe_step(p, *args)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["pipe_step"] == before + 1
    want_x, want_y = cuda_pipe.pipe_step_ref(p, *args)
    np.testing.assert_array_equal(to_numpy_u32(out_x), to_numpy_u32(want_x))
    np.testing.assert_array_equal(dig_y.cpu().numpy(), want_y.cpu().numpy())


@pytest.mark.gpu
def test_blind_rotate_pipe_on_gpu_matches_cpu(cuda_device):
    """An odd batch through the pipelined rotation on the card: one K1 and
    2 lwe_n K9 launches, the CPU's words."""
    p = PALLAS_GRID
    gen = torch.Generator().manual_seed(9)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    ct = torch.randint(-2 ** 31, 2 ** 31, (33, p.lwe_n + 1),
                       dtype=torch.int32, generator=gen)
    want = blind_rotate_pipe(p, ck.bands, ct, ck.testvec)
    cuda_t.reset_launch_counts()
    got = blind_rotate_pipe(p, ck.bands.to(cuda_device), ct.to(cuda_device),
                            ck.testvec.to(cuda_device))
    torch.cuda.synchronize()
    for name, count in cuda_t.launch_counts.items():
        want_count = {"rotate_decompose_t": 1,
                      "pipe_step": 2 * p.lwe_n}.get(name, 0)
        assert count == want_count, name
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
