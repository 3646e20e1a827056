"""The blind-rotation step kernels (ops/cuda_t.py) against the JAX
package's Pallas kernels (ops/pallas_t.py, run in interpret mode).

On the CPU the port's wrappers run the kernels' plain versions, so the
CPU cases hold the plain versions bit for bit against the TPU kernels; the
``gpu`` cases hold the Hopper kernels against the plain versions on the
card and skip without one.  JAX is imported only by the cases that use it,
so the ``gpu`` cases also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_t.py
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, gates, keys  # noqa: E402
from go_tfhe_tpu_torch import params as tparams  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_t  # noqa: E402
from go_tfhe_tpu_torch.ops.blindrotate import blind_rotate_t  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

_BASE = dict(lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
             lv1_alpha=1.0 / (1 << 30), nbit=8, basebit=4, iks_t=6,
             block_size=1)
# The three digit shapes of the kernels at N = 256: the 128bit_fast gadget
# (centered, on-grid key, lowest key limb dropped), the reference 128-bit
# gadget, and wide digits split into three limbs (the Uint2-5 shape).
CONFIGS = {
    "bg8_l2_lo1": tparams.TFHEParams(
        name="t_bg8_lo1", bgbit=8, l=2, kernel_limb_drop=1, key_grid_bits=8,
        centered_decomposition=True, **_BASE),
    "bg6_l3": tparams.TFHEParams(name="t_bg6", bgbit=6, l=3, **_BASE),
    "bg18_l1_nd3": tparams.TFHEParams(name="t_bg18", bgbit=18, l=1,
                                      message_modulus=8, **_BASE),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX side, with the Pallas kernels in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from go_tfhe_tpu.ops import pallas_t
    pallas_t.INTERPRET = True
    import go_tfhe_tpu
    from go_tfhe_tpu.ops.blindrotate import blind_rotate_t as j_blind_rotate_t
    return types.SimpleNamespace(jax=jax, jnp=jnp, pallas_t=pallas_t,
                                 tfhe=go_tfhe_tpu,
                                 blind_rotate_t=j_blind_rotate_t)


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _lo(p):
    return p.kernel_limb_drop if p.digit_limbs == 1 else 0


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _inputs(p, b, seed):
    rng = np.random.default_rng(seed)
    acc = _u32(rng, (2, p.n, b))
    amounts = rng.integers(0, 2 * p.n + 1, b).astype(np.int32)
    amounts[:2] = [0, 2 * p.n][:b]
    bsk = _u32(rng, (1, 2 * p.l, 2, p.n))
    return acc, amounts, bsk


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_rotate_decompose_ref_matches_pallas(jx, cfg):
    p = CONFIGS[cfg]
    acc, amounts, _ = _inputs(p, 8, 1)
    want = np.asarray(jx.pallas_t.rotate_decompose_t(
        _jparams(jx, p), jx.jnp.asarray(acc), jx.jnp.asarray(amounts), tb=8))
    got = cuda_t.rotate_decompose_t_ref(p, from_numpy_u32(acc, "cpu"),
                                        torch.from_numpy(amounts))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("on_grid", [True, False])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_extprod_ref_matches_pallas(jx, cfg, on_grid):
    """Off the key grid the dropped limb is not zero; the band packing
    folds the drop in, so the plain K2 still equals the TPU kernel."""
    p = CONFIGS[cfg]
    acc, amounts, bsk = _inputs(p, 8, 2)
    if on_grid:
        bsk &= np.uint32(0xFFFFFF00)
    lo, nd = _lo(p), p.digit_limbs
    jnp, pallas_t = jx.jnp, jx.pallas_t
    digits = np.asarray(pallas_t.rotate_decompose_t(
        _jparams(jx, p), jnp.asarray(acc), jnp.asarray(amounts), tb=8))
    band_rev = pallas_t.pack_bsk_band_rev(jnp.asarray(bsk))[0]
    want = np.asarray(pallas_t.extprod_t(
        jnp.asarray(digits), band_rev, jnp.asarray(acc),
        limb_mag=min(p.half_bg, 128), tb=8, lo=lo, nd=nd))
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"), lo)[0]
    got = cuda_t.extprod_t_ref(torch.from_numpy(digits.copy()), band,
                               from_numpy_u32(acc, "cpu"), nd)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_band_limb_drop_is_identity_on_grid():
    rng = np.random.default_rng(3)
    bsk = from_numpy_u32(_u32(rng, (2, 4, 2, 64)) & np.uint32(0xFFFFFF00),
                         "cpu")
    np.testing.assert_array_equal(cuda_t.pack_bsk_band_t(bsk, 1).numpy(),
                                  cuda_t.pack_bsk_band_t(bsk, 0).numpy())


@pytest.mark.parametrize("cfg", ["bg8_l2_lo1", "bg18_l1_nd3"])
def test_blind_rotate_t_matches_jax(jx, cfg):
    """The port's blind rotation == JAX blind_rotate_t on the same key."""
    p = CONFIGS[cfg]
    jp = _jparams(jx, p)
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(5))
    sk = jx.tfhe.gen_secret_key(k1, jp)
    ck = jx.tfhe.gen_cloud_key(k2, sk, jp)
    rng = np.random.default_rng(4)
    ct = _u32(rng, (8, p.lwe_n + 1))
    want = np.asarray(jx.blind_rotate_t(jp, ck.bsk_band_rev,
                                        jx.jnp.asarray(ct), ck.testvec, tb=8))
    tck = keys.cloud_key_from_numpy(p, np.asarray(ck.testvec),
                                    np.asarray(ck.ksk), np.asarray(ck.bsk),
                                    device="cpu")
    got = blind_rotate_t(p, tck.bands, from_numpy_u32(ct, "cpu"),
                         tck.testvec)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_cpu_wrappers_run_plain_and_count_nothing():
    p = CONFIGS["bg8_l2_lo1"]
    acc, amounts, bsk = _inputs(p, 4, 6)
    acc_t, am_t = from_numpy_u32(acc, "cpu"), torch.from_numpy(amounts)
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"), 1)[0]
    cuda_t.reset_launch_counts()
    d = cuda_t.rotate_decompose_t(p, acc_t, am_t)
    np.testing.assert_array_equal(
        d.numpy(), cuda_t.rotate_decompose_t_ref(p, acc_t, am_t).numpy())
    out = cuda_t.extprod_t(d, band, acc_t)
    np.testing.assert_array_equal(
        out.numpy(), cuda_t.extprod_t_ref(d, band, acc_t).numpy())
    assert cuda_t.launch_counts == dict.fromkeys(cuda_t.launch_counts, 0)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU goes to the kernel route, which refuses what is
    not a CUDA tensor instead of falling back to the plain version."""
    p = CONFIGS["bg8_l2_lo1"]
    acc = torch.empty((2, p.n, 4), dtype=torch.int32, device="meta")
    amounts = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_t.rotate_decompose_t(p, acc, amounts)
    digits = torch.empty((2 * p.l * p.n, 4), dtype=torch.int8, device="meta")
    band = torch.empty((2, 2 * p.l, 2 * p.n), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_t.extprod_t(digits, band, acc)


# ---------------------------------------------------------------------------
# On the card: the Hopper kernels against their plain versions.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 200])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_kernels_match_plain_on_gpu(cuda_device, cfg, b):
    p = CONFIGS[cfg]
    acc, amounts, bsk = _inputs(p, b, 7)
    acc_t = from_numpy_u32(acc, cuda_device)
    am_t = torch.from_numpy(amounts).to(cuda_device)
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, cuda_device),
                                  _lo(p))[0].contiguous()
    before = dict(cuda_t.launch_counts)
    d = cuda_t.rotate_decompose_t(p, acc_t, am_t)
    out = cuda_t.extprod_t(d, band, acc_t, p.digit_limbs)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts["rotate_decompose_t"] == \
        before["rotate_decompose_t"] + 1
    assert cuda_t.launch_counts["extprod_t"] == before["extprod_t"] + 1
    np.testing.assert_array_equal(
        d.cpu().numpy(),
        cuda_t.rotate_decompose_t_ref(p, acc_t, am_t).cpu().numpy())
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_t.extprod_t_ref(d, band, acc_t, p.digit_limbs)))


@pytest.mark.gpu
def test_gates_on_gpu_match_cpu(cuda_device):
    """The same keys and ciphertexts through NAND on the card (kernels)
    and on the CPU (plain versions) give the same words."""
    p = CONFIGS["bg8_l2_lo1"]
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    a = torch.from_numpy(np.resize([False, True], 33))
    b = torch.from_numpy(np.resize([False, False, True, True], 33))
    ca = cipher.lwe_encrypt_bool(gen, a, p.lwe_alpha, sk.lv0)
    cb = cipher.lwe_encrypt_bool(gen, b, p.lwe_alpha, sk.lv0)
    want = gates.NAND(ck, ca, cb)
    got = gates.NAND(ck.to(cuda_device), ca.to(cuda_device),
                     cb.to(cuda_device))
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(want, sk.lv0).numpy(), ~(a & b).numpy())
