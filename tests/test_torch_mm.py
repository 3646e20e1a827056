"""The library form of the external products, ``cuda_t.extprod_t_mm`` and
``cuda_ext_t.extprod_ext_t_mm`` (``torch._int_mm`` on int8 Toeplitz key
limbs), against the plain K2/K5 (``extprod_t_ref`` / ``extprod_ext_t_ref``)
and the JAX package's Pallas K2 (interpret mode), on the CPU.

The library form computes with the limb-pair arithmetic of the tensor-core
tile (``csrc/extprod_tile.cuh``): balanced int8 key limbs (the bytes of
word + 0x80808080, each minus 128), int8 digit limbs, one s32 sum per limb
pair, shifted by 8(i + l) and added mod 2^32, pairs of weight >= 2^32 and
key limbs below ``lo`` skipped.  The extreme-operand cases (every digit limb
and every key limb -128) pin the largest s32 sums.  Tolerance 0 throughout.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import params  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_ext_t, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.ops.polymul import split_balanced_limbs_i8  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

_BASE = dict(lwe_n=4, lwe_alpha=1.0 / (1 << 26), lv1_alpha=1.0 / (1 << 30),
             basebit=4, iks_t=6, block_size=1)
# nd 3 at N 256 (chip_smoke.py's wide_nd3), and the extended k = 2 shape
# (chip_smoke.py's ext3_nd3 at k = 2)
WIDE_ND3 = params.TFHEParams(name="t_wide_nd3", n=256, nbit=8, bgbit=18,
                             l=1, message_modulus=8, **_BASE)
EXT2_ND3 = params.TFHEParams(name="t_ext2_nd3", n=256, nbit=8, bgbit=18,
                             l=1, message_modulus=8, poly_extend_factor=2,
                             **_BASE)
# The balanced key limbs all -128: the band word at lo 0, and with limb 0
# dropped (lo 1).
EXTREME_WORD = {0: 0x7F7F7F80, 1: 0x7F7F8000}


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _band(p, rng, extreme=False):
    """K2's band (2, 2L, 2N) for profile p, packed without its
    band_limb_drop key limbs (or filled with the extreme word)."""
    lo = cuda_t.band_limb_drop(p)
    if extreme:
        return torch.full((2, 2 * p.l, 2 * p.n), EXTREME_WORD[lo],
                          dtype=torch.int64).to(torch.int32)
    bsk = from_numpy_u32(_u32(rng, (1, 2 * p.l, 2, p.n)), "cpu")
    return cuda_t.pack_bsk_band_t(bsk, lo)[0].contiguous()


def _operands(p, b, seed, extreme=False):
    rng = np.random.default_rng(seed)
    k, nd = p.poly_extend_factor, p.digit_limbs
    rows = k * nd * 2 * p.l * p.n
    if extreme:
        digits = torch.full((rows, b), -128, dtype=torch.int8)
    else:
        digits = torch.from_numpy(
            rng.integers(-128, 128, (rows, b)).astype(np.int8))
    acc = from_numpy_u32(_u32(rng, (2, k * p.n, b)), "cpu")
    return digits, _band(p, rng, extreme), acc


@pytest.mark.parametrize("p,b", [
    (params.P128_FAST, 8),          # nd 1, lo 1: 3 limb pairs
    (params.P128, 5),               # l 3, nd 1, lo 0: 4 pairs, B padded to 8
    (WIDE_ND3, 16),                 # nd 3, lo 0: 9 pairs
], ids=["128bit_fast", "128bit", "wide_nd3"])
def test_extprod_t_mm_matches_plain(p, b):
    nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
    digits, band, acc = _operands(p, b, 1)
    want = cuda_t.extprod_t_ref(digits, band, acc, nd, lo)
    got = cuda_t.extprod_t_mm(digits, band, acc, nd, lo)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    key = cuda_t.toeplitz_limbs_i8(band, lo)
    assert key.dtype == torch.int8 and key.shape == (4 - lo, 2 * p.n,
                                                     2 * p.l * p.n)
    np.testing.assert_array_equal(
        to_numpy_u32(cuda_t.extprod_t_mm(digits, band, acc, nd, lo,
                                         key=key)), to_numpy_u32(want))


def test_extprod_ext_t_mm_matches_plain():
    p = EXT2_ND3
    k, nd = p.poly_extend_factor, p.digit_limbs
    digits, band, acc = _operands(p, 7, 2)
    want = cuda_ext_t.extprod_ext_t_ref(digits, band, acc, k, nd)
    got = cuda_ext_t.extprod_ext_t_mm(digits, band, acc, k, nd)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


@pytest.mark.parametrize("p", [params.P128, params.P128_FAST, WIDE_ND3],
                         ids=["nd1_lo0", "nd1_lo1", "nd3_lo0"])
def test_extreme_operands(p):
    """Every digit limb -128 and every key limb -128: the largest s32 sum
    of one limb pair, 2L*N * 2^14 (2^26.6 at 128bit), stays exact."""
    nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
    digits, band, acc = _operands(p, 8, 3, extreme=True)
    limbs = split_balanced_limbs_i8(band[:1, :1, :1], 4).flatten().tolist()
    assert limbs == [0] * lo + [-128] * (4 - lo)
    want = cuda_t.extprod_t_ref(digits, band, acc, nd, lo)
    got = cuda_t.extprod_t_mm(digits, band, acc, nd, lo)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


def test_extreme_operands_extended():
    p = EXT2_ND3
    k, nd = p.poly_extend_factor, p.digit_limbs
    digits, band, acc = _operands(p, 8, 4, extreme=True)
    want = cuda_ext_t.extprod_ext_t_ref(digits, band, acc, k, nd)
    got = cuda_ext_t.extprod_ext_t_mm(digits, band, acc, k, nd)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))


def test_balanced_limbs_are_bytes_of_offset_word():
    """The tile's limb split: byte l of (word + 0x80808080) ^ 0x80808080,
    read as int8, is split_balanced_limbs_i8's limb l; 0x80808080 splits
    as [-128, -127, -127, -127]."""
    rng = np.random.default_rng(5)
    words = np.concatenate([_u32(rng, 4096), np.asarray(
        [0, 0x80808080, 0x7F7F7F80, 0x7F7F8000, 0xFFFFFFFF, 0x7F, 0x80],
        dtype=np.uint32)])
    kb = ((words.astype(np.uint64) + 0x80808080) % 2 ** 32).astype(
        np.uint32) ^ np.uint32(0x80808080)
    tile = kb.view(np.int8).reshape(-1, 4).T                    # (4, n)
    want = split_balanced_limbs_i8(from_numpy_u32(words, "cpu"), 4).numpy()
    np.testing.assert_array_equal(tile, want)
    assert want[:, words.tolist().index(0x80808080)].tolist() == [
        -128, -127, -127, -127]


def test_extprod_t_mm_matches_pallas():
    """The library form at the 128bit_fast knobs (N 256) == the JAX
    package's Pallas K2 (interpret mode) on the same digits and key."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import go_tfhe_tpu
    from go_tfhe_tpu.ops import pallas_t
    pallas_t.INTERPRET = True
    p = dataclasses.replace(params.P128_FAST, name="t_fast256", n=256,
                            nbit=8)
    rng = np.random.default_rng(6)
    acc = _u32(rng, (2, p.n, 8))
    amounts = rng.integers(0, 2 * p.n + 1, 8).astype(np.int32)
    bsk = _u32(rng, (1, 2 * p.l, 2, p.n)) & np.uint32(0xFFFFFF00)
    jp = go_tfhe_tpu.TFHEParams(**dataclasses.asdict(p))
    digits = np.asarray(pallas_t.rotate_decompose_t(
        jp, jnp.asarray(acc), jnp.asarray(amounts), tb=8))
    want = np.asarray(pallas_t.extprod_t(
        jnp.asarray(digits), pallas_t.pack_bsk_band_rev(jnp.asarray(bsk))[0],
        jnp.asarray(acc), limb_mag=min(p.half_bg, 128), tb=8, lo=1, nd=1))
    band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"), 1)[0]
    got = cuda_t.extprod_t_mm(torch.from_numpy(digits.copy()), band,
                              from_numpy_u32(acc, "cpu"), 1, 1)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("lo,n,l2,match", [
    (2, 256, 4, "lo=2"),                    # the tile skips 0 or 1 limbs
    (0, 96, 4, "multiple of 64"),
    (0, 4096, 8, "overflow"),               # 2L*N = 2^15
])
def test_kernel_wrappers_refuse_what_the_tile_cannot(lo, n, l2, match):
    """The kernel route checks the tile's limits before it looks at the
    tensors (meta tensors: no CPU fallback either)."""
    acc = torch.empty((2, n, 4), dtype=torch.int32, device="meta")
    band = torch.empty((2, l2, 2 * n), dtype=torch.int32, device="meta")
    digits = torch.empty((l2 * n, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=match):
        cuda_t.extprod_t(digits, band, acc, 1, lo)
    with pytest.raises(ValueError, match=match):
        cuda_ext_t.extprod_ext_t(digits, band, acc, 1, 1, lo)
