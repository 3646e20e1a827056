"""The row-major step kernels of the port — K6 (ops/cuda_ext.py), K7
(ops/cuda_rotate.py), K8 (ops/cuda_extprod.py) — and the row-major extended
blind rotation, against the JAX package (Pallas kernels in interpret mode,
as tests/test_pallas_kernel.py and tests/test_pallas_ext.py run them).

On the CPU the wrappers run the kernels' plain versions; the ``gpu`` cases
hold the Hopper kernels against them on the card and skip without one.
JAX is imported only by the cases that use it, so the ``gpu`` cases also
run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_rowmajor.py

Tolerance is 0 throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import cipher, keys, lut, params  # noqa: E402
from go_tfhe_tpu_torch.ops import (cuda_ext, cuda_extprod,  # noqa: E402
                                   cuda_rotate, cuda_t)
from go_tfhe_tpu_torch.ops.blindrotate import (  # noqa: E402
    blind_rotate_extended_rm, blind_rotate_extended_t, block_bands)
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

_BASE = dict(lwe_alpha=1.0 / (1 << 28), n=256, lv1_alpha=1.0 / (1 << 31),
             nbit=8, basebit=4, iks_t=6)
# uint8's digit shape and k = 9 at N = 256 (bgbit 22 / l 1 -> 3 limbs).
EXT9 = params.TFHEParams(name="t_ext9_nd3", lwe_n=4, bgbit=22, l=1,
                         block_size=1, message_modulus=16,
                         poly_extend_factor=9, **_BASE)
K6_SHAPES = {"test_ext2": params.TEST_EXT2, "test_ext3": params.TEST_EXT3,
             "ext9_nd3": EXT9}
# K7/K8 digit shapes at N = 256: the 128bit_fast gadget (centered, on-grid
# key, lowest key limb dropped) and wide digits split into three limbs.
ROT_SHAPES = {
    "bg8_l2_lo1": params.TFHEParams(
        name="t_rm_bg8_lo1", lwe_n=8, bgbit=8, l=2, block_size=3,
        kernel_limb_drop=1, key_grid_bits=8, centered_decomposition=True,
        **_BASE),
    "bg18_l1_nd3": params.TFHEParams(
        name="t_rm_bg18", lwe_n=8, bgbit=18, l=1, block_size=3,
        message_modulus=8, **_BASE),
}


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
    from go_tfhe_tpu.ops import blindrotate as jbr
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, tfhe=go_tfhe_tpu, br=jbr, pallas_ext=pallas_ext,
        pallas_extprod=pallas_extprod, pallas_rotate=pallas_rotate)


def _jparams(jx, p):
    return jx.tfhe.TFHEParams(**dataclasses.asdict(p))


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(x, device="cpu"):
    return from_numpy_u32(np.asarray(x), device)


def _k6_inputs(p, b, seed):
    """acc (2, B, kN) and amounts over [0, 2kN] with 0, kN, 2kN - 1 and 2kN
    among them."""
    rng = np.random.default_rng(seed)
    k, n = p.poly_extend_factor, p.n
    big = 2 * k * n
    t = rng.integers(0, big + 1, b).astype(np.int32)
    t[:4] = [0, k * n, big - 1, big][:b]
    return _u32(rng, (2, b, k * n)), t


def _k7_inputs(p, bs, b, seed):
    """acc (2, B, N) and (bs, B) amounts over [0, 2N] with 0, N and 2N."""
    rng = np.random.default_rng(seed)
    amounts = rng.integers(0, 2 * p.n + 1, (bs, b)).astype(np.int32)
    amounts[0, :3] = [0, p.n, 2 * p.n][:b]
    return _u32(rng, (2, b, p.n)), amounts


# ---------------------------------------------------------------------------
# K6, K7 and K8 plain versions against the Pallas kernels (interpret mode).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(K6_SHAPES))
def test_rotate_decompose_ext_ref_matches_pallas(jx, shape):
    p = K6_SHAPES[shape]
    acc, t = _k6_inputs(p, 8, 1)
    want = np.asarray(jx.pallas_ext.rotate_decompose_ext_pallas(
        _jparams(jx, p), jx.jnp.asarray(acc), jx.jnp.asarray(t), tb=8))
    got = cuda_ext.rotate_decompose_ext_ref(p, _t(acc), torch.from_numpy(t))
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bs", [1, 2, 3])
@pytest.mark.parametrize("shape", sorted(ROT_SHAPES))
def test_rotate_decompose_ref_matches_pallas(jx, shape, bs):
    p = ROT_SHAPES[shape]
    acc, amounts = _k7_inputs(p, bs, 8, 2)
    want = np.asarray(jx.pallas_rotate.rotate_decompose_pallas(
        _jparams(jx, p), jx.jnp.asarray(acc), jx.jnp.asarray(amounts), tb=8))
    got = cuda_rotate.rotate_decompose_ref(p, _t(acc),
                                           torch.from_numpy(amounts))
    assert got.shape == (8, p.digit_limbs * bs * 2 * p.l * p.n)
    np.testing.assert_array_equal(got.numpy(), want.reshape(8, -1))
    if bs == 1:                     # a (B,) amount vector is one block bit
        np.testing.assert_array_equal(
            cuda_rotate.rotate_decompose_ref(
                p, _t(acc), torch.from_numpy(amounts[0])).numpy(),
            got.numpy())


# (shape, block bits, on the key grid, fused acc): per-bit and block rows,
# the 128bit_fast knobs on and off the key grid (the dropped limb is not
# zero off it, and the port folds the drop into the band), and wide
# digits; each shape family with and without the accumulator.
K8_CASES = [("bg8_l2_lo1", 1, True, True), ("bg8_l2_lo1", 1, False, False),
            ("bg8_l2_lo1", 3, True, False), ("bg8_l2_lo1", 3, False, True),
            ("bg18_l1_nd3", 1, False, False), ("bg18_l1_nd3", 2, False, True)]


@pytest.mark.parametrize("shape,bs,on_grid,fused", K8_CASES)
def test_extprod_ref_matches_pallas(jx, shape, bs, on_grid, fused):
    """R = 2L and R = bs*2L rows, nd = 1 and 3, drop_limbs = 1 against the
    port's folded band, with the fused accumulator and without it (the
    port's K8 always adds acc: zeros stand for no acc)."""
    p = ROT_SHAPES[shape]
    jnp = jx.jnp
    rng = np.random.default_rng(3)
    acc, amounts = _k7_inputs(p, bs, 8, 4)
    bsk = _u32(rng, (bs, 2 * p.l, 2, p.n))
    if on_grid:
        bsk &= np.uint32(0xFFFFFF00)
    nd = p.digit_limbs
    lo = p.kernel_limb_drop if nd == 1 else 0
    digits = jx.pallas_rotate.rotate_decompose_pallas(
        _jparams(jx, p), jnp.asarray(acc), jnp.asarray(amounts), tb=8)
    band = jx.pallas_extprod.pack_bsk_band(jnp.asarray(bsk), tn=256)
    w = band.shape[-1]
    band = jnp.moveaxis(band.reshape(bs, 2, 2 * p.l, w), 1, 0).reshape(
        2, bs * 2 * p.l, w)
    want = np.asarray(jx.pallas_extprod.extprod_pallas(
        digits, band, limb_mag=min(p.half_bg, 128), tb=8, tn=256,
        drop_limbs=lo, dot_dtype="int8",
        acc=jnp.asarray(acc) if fused else None))
    tbands = cuda_t.pack_bsk_band_t(_t(bsk), lo)
    tband = block_bands(dataclasses.replace(p, lwe_n=bs, block_size=bs),
                        tbands)[0] if bs > 1 else tbands[0]
    tacc = _t(acc) if fused else torch.zeros((2, 8, p.n), dtype=torch.int32)
    got = cuda_extprod.extprod_ref(
        torch.from_numpy(np.array(digits).reshape(8, -1)), tband, tacc, nd)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_block_bands_row_order():
    """Block step rows are block bit major, then each bit's 2L BSK rows:
    row j*2L + r of block f is band f*bs + j, row r."""
    p = dataclasses.replace(ROT_SHAPES["bg8_l2_lo1"], lwe_n=7)
    bands = torch.arange(7 * 2 * 4 * 2 * p.n, dtype=torch.int32).reshape(
        7, 2, 4, 2 * p.n)
    blk = block_bands(p, bands)
    assert blk.shape == (2, 2, 12, 2 * p.n)
    for f in range(2):
        for j in range(3):
            for r in range(4):
                assert torch.equal(blk[f, :, j * 4 + r], bands[f * 3 + j, :, r])


# ---------------------------------------------------------------------------
# The row-major extended blind rotation.
# ---------------------------------------------------------------------------

def _jax_keys(jx, p, seed, bands="auto"):
    jp = _jparams(jx, p)
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(seed))
    sk = jx.tfhe.gen_secret_key(k1, jp)
    ck = jx.tfhe.gen_cloud_key(k2, sk, jp, bands=bands)
    tck = keys.cloud_key_from_numpy(p, np.asarray(ck.testvec),
                                    np.asarray(ck.ksk), np.asarray(ck.bsk),
                                    device="cpu")
    return ck, tck


def _ext_ct(p, seed, b=8):
    rng = np.random.default_rng(seed)
    ct = _u32(rng, (b, p.lwe_n + 1))
    ct[0, :] = 0                                   # every amount 0 or 2kN
    tables = _u32(rng, (b, p.poly_extend_factor, 2, p.n))
    return ct, tables


def test_blind_rotate_extended_rm_matches_tpu_kernels(jx):
    """== JAX blind_rotate_extended_tpu (K6 + K8 in interpret mode) at
    TEST_EXT2, per-ciphertext tables."""
    p = params.TEST_EXT2
    ck, tck = _jax_keys(jx, p, 31, bands="all")
    ct, tables = _ext_ct(p, 5)
    want = np.asarray(jx.br.blind_rotate_extended_tpu(
        _jparams(jx, p), ck.bsk_band, jx.jnp.asarray(ct),
        jx.jnp.asarray(tables)))
    got = blind_rotate_extended_rm(p, tck.bands, _t(ct), _t(tables))
    assert got.shape == (8, p.poly_extend_factor, 2, p.n)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_blind_rotate_extended_rm_matches_portable_k9(jx):
    """== the JAX portable blind_rotate_extended at k = 9, nd = 3 (the
    interpreted nd = 3 Pallas rotation is too slow for tier 1), with the
    shared test vector."""
    p = EXT9
    ck, tck = _jax_keys(jx, p, 32)
    ct, _ = _ext_ct(p, 6)
    want = np.asarray(jx.br.blind_rotate_extended(
        _jparams(jx, p), ck.bsk_kernel, jx.jnp.asarray(ct), ck.testvec))
    got = blind_rotate_extended_rm(p, tck.bands, _t(ct), tck.testvec)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("shape", ["test_ext3", "ext9_nd3"])
def test_blind_rotate_extended_rm_matches_transposed(shape):
    """== the port's own transposed blind_rotate_extended_t (K4 + K5) on
    the same native keys: the two layouts compute the same words."""
    p = K6_SHAPES[shape]
    gen = torch.Generator().manual_seed(12)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    ct, tables = _ext_ct(p, 7, b=5)
    np.testing.assert_array_equal(
        blind_rotate_extended_rm(p, ck.bands, _t(ct), _t(tables)).numpy(),
        blind_rotate_extended_t(p, ck.bands, _t(ct), _t(tables)).numpy())


def test_cpu_rowmajor_wrappers_run_plain_and_count_nothing():
    p = ROT_SHAPES["bg18_l1_nd3"]
    acc, amounts = _k7_inputs(p, 3, 4, 8)
    acc_t, am_t = _t(acc), torch.from_numpy(amounts)
    bsk = _u32(np.random.default_rng(8), (3, 2, 2, p.n))
    band = block_bands(dataclasses.replace(p, lwe_n=3),
                       cuda_t.pack_bsk_band_t(_t(bsk)))[0]
    cuda_t.reset_launch_counts()
    d = cuda_rotate.rotate_decompose(p, acc_t, am_t)
    np.testing.assert_array_equal(
        d.numpy(), cuda_rotate.rotate_decompose_ref(p, acc_t, am_t).numpy())
    out = cuda_extprod.extprod(d, band, acc_t, 3)
    np.testing.assert_array_equal(
        out.numpy(), cuda_extprod.extprod_ref(d, band, acc_t, 3).numpy())
    acc9, t9 = _k6_inputs(EXT9, 4, 9)
    d9 = cuda_ext.rotate_decompose_ext(EXT9, _t(acc9), torch.from_numpy(t9))
    np.testing.assert_array_equal(
        d9.numpy(), cuda_ext.rotate_decompose_ext_ref(
            EXT9, _t(acc9), torch.from_numpy(t9)).numpy())
    assert cuda_t.launch_counts == dict.fromkeys(cuda_t.launch_counts, 0)


def test_non_cpu_tensor_never_takes_the_plain_rowmajor_path():
    """A tensor off the CPU goes to the kernel route, which refuses what is
    not a CUDA tensor instead of falling back to the plain version."""
    p = ROT_SHAPES["bg8_l2_lo1"]
    n = p.n
    acc = torch.empty((2, 4, n), dtype=torch.int32, device="meta")
    amounts = torch.empty((3, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_rotate.rotate_decompose(p, acc, amounts)
    digits = torch.empty((4, 12 * n), dtype=torch.int8, device="meta")
    band = torch.empty((2, 12, 2 * n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_extprod.extprod(digits, band, acc)
    acc9 = torch.empty((2, 4, 9 * n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        cuda_ext.rotate_decompose_ext(EXT9, acc9, amounts[0])


# ---------------------------------------------------------------------------
# On the card: K6, K7 and K8 against their plain versions, and a bootstrap.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _gpu_step(fn, counter, *args):
    before = cuda_t.launch_counts[counter]
    out = fn(*args)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts[counter] == before + 1
    return out


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose storage starts 4 bytes past a 16-byte
    boundary: the staged-row kernel then stages it in 4-byte pieces."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


# The staged-row kernel's edges (csrc/rotdec_row.cuh): ragged and one-
# ciphertext batches, and a misaligned accumulator (4-byte staging).
ROW_BATCHES = [(1, False), (3, False), (4, False), (5, False), (5, True),
               (8, False), (127, False), (129, False), (129, True),
               (130, False), (4095, False)]
# K6 at N 128, 256 and 2048, k 2, 3 and 9, nd 1 and 3, l 2 and 3.
K6_GPU_SHAPES = {
    **K6_SHAPES,
    "n128_k3": params.TFHEParams(
        name="t_k6_n128", lwe_n=4, lwe_alpha=1.0 / (1 << 28), n=128,
        lv1_alpha=1.0 / (1 << 31), nbit=7, bgbit=8, l=2, basebit=4, iks_t=6,
        block_size=1, poly_extend_factor=3),
    "uint6_centered": params.UINT6_CENTERED,
    "uint8_centered": params.UINT8_CENTERED}
# K7 at N 128, 256, 1024 and 2048, nd 1-3, l 1-3.
ROT_GPU_SHAPES = {**ROT_SHAPES, "test_block": params.TEST_BLOCK,
                  "128bit": params.P128, "uint1": params.UINT1,
                  "uint4": params.UINT4}


@pytest.mark.gpu
@pytest.mark.parametrize("b,misaligned", ROW_BATCHES)
@pytest.mark.parametrize("shape", sorted(K6_GPU_SHAPES))
def test_k6_matches_plain_on_gpu(cuda_device, shape, b, misaligned):
    p = K6_GPU_SHAPES[shape]
    acc, t = _k6_inputs(p, b, 10)
    acc_t, t_t = _t(acc, cuda_device), torch.from_numpy(t).to(cuda_device)
    if misaligned:
        acc_t = _misaligned(acc_t)
    d = _gpu_step(cuda_ext.rotate_decompose_ext, "rotate_decompose_ext", p,
                  acc_t, t_t)
    np.testing.assert_array_equal(
        d.cpu().numpy(),
        cuda_ext.rotate_decompose_ext_ref(p, acc_t, t_t).cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("b,misaligned", ROW_BATCHES)
@pytest.mark.parametrize("bs", [1, 2, 3])
@pytest.mark.parametrize("shape", sorted(ROT_GPU_SHAPES))
def test_k7_k8_match_plain_on_gpu(cuda_device, shape, bs, b, misaligned):
    p = ROT_GPU_SHAPES[shape]
    nd = p.digit_limbs
    acc, amounts = _k7_inputs(p, bs, b, 11)
    acc_t = _t(acc, cuda_device)
    am_t = torch.from_numpy(amounts).to(cuda_device)
    lo = cuda_t.band_limb_drop(p)
    bsk = _u32(np.random.default_rng(11), (bs, 2 * p.l, 2, p.n))
    bands = cuda_t.pack_bsk_band_t(_t(bsk, cuda_device), lo)
    band = block_bands(dataclasses.replace(p, lwe_n=bs, block_size=bs),
                       bands)[0] if bs > 1 else bands[0]
    d = _gpu_step(cuda_rotate.rotate_decompose, "rotate_decompose", p,
                  _misaligned(acc_t) if misaligned else acc_t, am_t)
    np.testing.assert_array_equal(
        d.cpu().numpy(),
        cuda_rotate.rotate_decompose_ref(p, acc_t, am_t).cpu().numpy())
    out = _gpu_step(cuda_extprod.extprod, "extprod", d, band, acc_t, nd, lo)
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_extprod.extprod_ref(d, band, acc_t, nd, lo)))


@pytest.mark.gpu
def test_extended_rm_bootstrap_on_gpu_matches_cpu(cuda_device):
    """The same keys and ciphertexts through the row-major extended PBS on
    the card (K6/K8) and on the CPU (plain versions) give the same words."""
    p = dataclasses.replace(EXT9, lwe_n=6)
    gen = torch.Generator().manual_seed(3)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    m = p.message_modulus
    msgs = np.arange(33) % m
    ct = cipher.lwe_encrypt_message(gen, msgs, m, p.lwe_alpha, sk.lv0)
    table = lut.Generator(p, device="cpu").gen_lut(
        lambda x: (5 * x + 2) % m)
    tv = table.expand(33, *table.shape)
    want = blind_rotate_extended_rm(p, ck.bands, ct, tv)
    cuda_t.reset_launch_counts()
    got = blind_rotate_extended_rm(p, ck.bands.to(cuda_device),
                                   ct.to(cuda_device), tv.to(cuda_device))
    assert cuda_t.launch_counts["rotate_decompose_ext"] == p.lwe_n
    assert cuda_t.launch_counts["extprod"] == p.lwe_n
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
