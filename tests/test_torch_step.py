"""The fused step K3 (ops/cuda_step.py), the row-major per-bit blind
rotation ``blind_rotate_tpu`` and the engine's route to it (keys with
``transposed=False``), against the JAX package (Pallas kernels in
interpret mode, as tests/test_pallas_step.py runs them).

On the CPU the wrappers run the kernels' plain versions; the ``gpu`` cases
hold the Hopper kernel against its plain version on the card and skip
without one.  JAX is imported only by the cases that use it, so the
``gpu`` cases also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_step.py

Tolerance is 0 throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, engine, gates, keys, params  # noqa: E402
from go_tfhe_tpu_torch.ops import (blindrotate, cuda_extprod,  # noqa: E402
                                   cuda_rotate, cuda_step, cuda_t)
from go_tfhe_tpu_torch.ops.blindrotate import (blind_rotate_t,  # noqa: E402
                                               blind_rotate_tpu)
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

A = np.resize([False, False, True, True], 8)
B = np.resize([False, True, False, True], 8)
TRUTH = {
    "NAND": ~(A & B), "AND": A & B, "OR": A | B, "XOR": A ^ B,
    "XNOR": ~(A ^ B), "NOR": ~(A | B), "ANDNY": ~A & B, "ANDYN": A & ~B,
    "ORNY": ~A | B, "ORYN": A | ~B,
}

# tests/test_pallas_step.py's BASE and its three variants.
BASE = params.TFHEParams(
    name="test_step", lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
    lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=8, l=2, basebit=4, iks_t=6,
    block_size=1)
VARIANTS = {
    "centered": dataclasses.replace(BASE, name="test_step_centered",
                                    centered_decomposition=True),
    "drop": dataclasses.replace(BASE, name="test_step_drop", key_grid_bits=8,
                                centered_decomposition=True,
                                kernel_limb_drop=1),
    "l3": dataclasses.replace(BASE, name="test_step_l3", bgbit=6, l=3),
}
# Blind-rotation profiles: TEST_FAST, the 128bit_fast knobs at N 256
# (on-grid key, lowest key limb dropped), and wide digits in three limbs
# (the unfused branch with K7/K8's nd limbs even when FUSED_STEP is set).
ROTATION = {
    "test_fast": params.TEST_FAST,
    "bg8_lo1": dataclasses.replace(VARIANTS["drop"], name="t_step_bg8_lo1"),
    "bg18_nd3": params.TFHEParams(
        name="t_step_bg18", lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
        lv1_alpha=1.0 / (1 << 30), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=1, message_modulus=8),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX side, with the Pallas kernels in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from go_tfhe_tpu.ops import (pallas_extprod, pallas_pipe, pallas_rotate,
                                 pallas_step, pallas_t)
    for mod in (pallas_step, pallas_pipe, pallas_rotate, pallas_extprod,
                pallas_t):
        mod.INTERPRET = True
    import go_tfhe_tpu
    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import engine as jengine
    from go_tfhe_tpu.ops import blindrotate as jbr
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, tfhe=go_tfhe_tpu, cipher=jcipher, engine=jengine,
        br=jbr, pallas_extprod=pallas_extprod, pallas_step=pallas_step)


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(x, device="cpu"):
    return from_numpy_u32(np.asarray(x), device)


def _step_inputs(p, b, seed):
    """acc (2, B, N), amounts over [0, 2N] with 0, N, 2N - 1 and 2N among
    them, and one bit's raw BSK (1, 2L, 2, N), on the key grid where the
    profile has one."""
    rng = np.random.default_rng(seed)
    acc = _u32(rng, (2, b, p.n))
    amounts = rng.integers(0, 2 * p.n + 1, b).astype(np.int32)
    amounts[:4] = [0, p.n, 2 * p.n - 1, 2 * p.n][:b]
    bsk = _u32(rng, (1, 2 * p.l, 2, p.n))
    if p.key_grid_bits:
        bsk &= np.uint32(0xFFFFFFFF ^ ((1 << p.key_grid_bits) - 1))
    return acc, amounts, bsk


def _band(p, bsk, device="cpu"):
    return cuda_t.pack_bsk_band_t(_t(bsk, device), p.kernel_limb_drop)[0]


# ---------------------------------------------------------------------------
# Plain K3 against the Pallas kernel and the two-kernel composition.
# ---------------------------------------------------------------------------

def test_fused_step_ref_matches_pallas(jx):
    """== JAX fused_rotate_step (interpret) at test_pallas_step.py's BASE,
    B 8, against its prepended-pad band."""
    p = BASE
    acc, amounts, bsk = _step_inputs(p, 8, 1)
    jnp = jx.jnp
    want = np.asarray(jx.pallas_step.fused_rotate_step(
        _jparams(jx, p), jnp.asarray(acc), jnp.asarray(amounts),
        jx.pallas_extprod.pack_bsk_band(jnp.asarray(bsk))[0], tb=8))
    got = cuda_step.fused_rotate_step_ref(p, _t(acc), torch.from_numpy(amounts),
                                          _band(p, bsk))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_step_ref_matches_two_kernels(variant):
    """The centered, limb-drop and l = 3 gadgets (off the interpreter, as
    the JAX side keeps them in its slow tier): plain K3 and its wrapper on
    CPU tensors == plain K7 at bs = 1 + plain K8, and == the same step in
    the transposed layout through plain K1 + K2."""
    p = VARIANTS[variant]
    acc, amounts, bsk = _step_inputs(p, 8, 2)
    acc_t, am_t, band = _t(acc), torch.from_numpy(amounts), _band(p, bsk)
    got = cuda_step.fused_rotate_step_ref(p, acc_t, am_t, band)
    two = cuda_extprod.extprod_ref(
        cuda_rotate.rotate_decompose_ref(p, acc_t, am_t), band, acc_t)
    acc_tr = acc_t.transpose(1, 2).contiguous()
    transposed = cuda_t.extprod_t_ref(
        cuda_t.rotate_decompose_t_ref(p, acc_tr, am_t), band, acc_tr)
    np.testing.assert_array_equal(got.numpy(), two.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  transposed.transpose(1, 2).numpy())
    np.testing.assert_array_equal(
        cuda_step.fused_rotate_step(p, acc_t, am_t, band).numpy(),
        got.numpy())


def test_fused_step_refuses_wide_digits():
    """Digits above int8 (bgbit 18, three limbs) are not K3's: the plain
    version and the wrapper raise, as the TPU kernel asserts."""
    p = ROTATION["bg18_nd3"]
    acc, amounts, bsk = _step_inputs(p, 4, 3)
    for fn in (cuda_step.fused_rotate_step_ref, cuda_step.fused_rotate_step):
        with pytest.raises(ValueError, match="int8"):
            fn(p, _t(acc), torch.from_numpy(amounts),
               cuda_t.pack_bsk_band_t(_t(bsk))[0])


def test_non_cpu_tensor_never_takes_the_plain_step():
    p = BASE
    acc = torch.empty((2, 4, p.n), dtype=torch.int32, device="meta")
    amounts = torch.empty((4,), dtype=torch.int32, device="meta")
    band = torch.empty((2, 4, 2 * p.n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_step.fused_rotate_step(p, acc, amounts, band)


# ---------------------------------------------------------------------------
# blind_rotate_tpu, fused and unfused.
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


@pytest.mark.parametrize("name,fused", [
    ("test_fast", False), ("test_fast", True), ("bg8_lo1", False),
    ("bg8_lo1", True), ("bg18_nd3", True)])
def test_blind_rotate_tpu_matches_jax_portable(jx, monkeypatch, name, fused):
    """== JAX portable blind_rotate, per-ciphertext test vectors; every
    step through K3 (fused, int8 digits), else K7 + K8."""
    p = ROTATION[name]
    _, ck, tck = _jax_keys(jx, p, 5)
    rng = np.random.default_rng(6)
    ct = _u32(rng, (8, p.lwe_n + 1))
    tv = _u32(rng, (8, 2, p.n))
    want = np.asarray(jx.br.blind_rotate(
        _jparams(jx, p), ck.bsk_kernel, jx.jnp.asarray(ct),
        jx.jnp.asarray(tv)))
    monkeypatch.setattr(blindrotate, "FUSED_STEP", fused)
    cuda_t.reset_launch_counts()
    got = blind_rotate_tpu(p, tck.bands, _t(ct), _t(tv))
    assert got.shape == (8, 2, p.n)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    assert cuda_t.launch_counts == dict.fromkeys(cuda_t.launch_counts, 0)
    np.testing.assert_array_equal(
        blind_rotate_tpu(p, tck.bands, _t(ct), _t(tv), plain=True).numpy(),
        got.numpy())


# ---------------------------------------------------------------------------
# The engine with keys that are not transposed.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def row_engine(jx):
    """JAX keys at TEST_FAST, the port's key from the same arrays with
    ``transposed=False``, and 8 encrypted bit pairs."""
    sk, ck, tck = _jax_keys(jx, params.TEST_FAST, 41)
    ka, kb = jx.jax.random.split(jx.jax.random.PRNGKey(42))
    p = ck.params
    ca = jx.cipher.lwe_encrypt_bool(ka, A, p.lwe_alpha, sk.lv0)
    cb = jx.cipher.lwe_encrypt_bool(kb, B, p.lwe_alpha, sk.lv0)
    return sk, ck, dataclasses.replace(tck, transposed=False), ca, cb


@pytest.mark.parametrize("fused", [False, True], ids=["k7k8", "k3"])
@pytest.mark.parametrize("gate", sorted(TRUTH))
def test_row_major_gates_match_jax_core(jx, row_engine, monkeypatch, gate,
                                        fused):
    """Each gate through ``blind_rotate_tpu`` == JAX ``_bootstrap_core`` on
    its prepared input (the value of the JAX ``_bootstrap_core_tpu``), and
    decrypts to the truth table."""
    sk, ck, tck, ca, cb = row_engine
    monkeypatch.setattr(blindrotate, "FUSED_STEP", fused)
    assert engine._route(tck) == "blind_rotate_tpu"
    prep = getattr(jx.engine, "prepare_" + gate.lower())(ca, cb)
    want = np.asarray(jx.engine._bootstrap_core(
        ck.params, True, ck.bsk_kernel, ck.ksk, prep, ck.testvec))
    got = getattr(gates, gate)(tck, _t(ca), _t(cb))
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, _t(sk.lv0)).numpy(), TRUTH[gate])


def test_transposed_flag_kept_by_to_and_not_saved(row_engine, tmp_path):
    """``CloudKey.to`` keeps the flag; ``.npz`` files do not carry it (the
    JAX file carries no band either), so a loaded key is transposed."""
    _, _, tck, _, _ = row_engine
    assert not tck.to("cpu").transposed
    path = str(tmp_path / "ck.npz")
    keys.save_cloud_key(path, tck)
    assert keys.load_cloud_key(path, device="cpu").transposed


# ---------------------------------------------------------------------------
# On the card: K3 against its plain version, and a bootstrap.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 130, 1024])
@pytest.mark.parametrize("name", ["128bit_fast", "128bit"])
def test_k3_matches_plain_on_gpu(cuda_device, name, b):
    """Full width (N 1024; 128bit_fast's dropped limb, 128bit's l 3),
    ragged batches, amounts 0, N, 2N - 1 and 2N."""
    p = params.get_params(name)
    acc, amounts, bsk = _step_inputs(p, b, 7)
    acc_t = _t(acc, cuda_device)
    am_t = torch.from_numpy(amounts).to(cuda_device)
    band = _band(p, bsk, cuda_device).contiguous()
    before = cuda_t.launch_counts["fused_rotate_step"]
    out = cuda_step.fused_rotate_step(p, acc_t, am_t, band)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["fused_rotate_step"] == before + 1
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_step.fused_rotate_step_ref(p, acc_t, am_t, band)))
    np.testing.assert_array_equal(to_numpy_u32(acc_t), acc)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["k7k8", "k3"])
def test_row_major_gates_on_gpu_match_cpu(cuda_device, monkeypatch, fused):
    """The same keys and ciphertexts through NAND with a key that is not
    transposed, on the card (kernels) and on the CPU (plain versions)."""
    p = ROTATION["bg8_lo1"]
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = dataclasses.replace(keys.gen_cloud_key(gen, sk, p), transposed=False)
    a = torch.from_numpy(np.resize([False, True], 33))
    b = torch.from_numpy(np.resize([False, False, True, True], 33))
    ca = cipher.lwe_encrypt_bool(gen, a, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(gen, b, p.lwe_alpha, sk.lv0)
    monkeypatch.setattr(blindrotate, "FUSED_STEP", fused)
    want = gates.NAND(ck, ca, cb)
    cuda_t.reset_launch_counts()
    got = gates.NAND(ck.to(cuda_device), ca.to(cuda_device),
                     cb.to(cuda_device))
    kernels = (("fused_rotate_step",) if fused
               else ("rotate_decompose", "extprod"))
    # and the gate's one key switch, through the key switch's kernel
    for name, count in cuda_t.launch_counts.items():
        want_count = p.lwe_n if name in kernels else int(name == "key_switch")
        assert count == want_count, name
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(want, sk.lv0).numpy(), ~(a & b).numpy())
    assert torch.equal(blind_rotate_t(p, ck.bands, ca, ck.testvec),
                       blind_rotate_tpu(p, ck.bands, ca, ck.testvec))
