"""K8's library form ``cuda_extprod.extprod_mm`` (``torch._int_mm`` on int8
Toeplitz key limbs) against the plain K8 (``extprod_ref``) and the JAX
package's Pallas K8 (interpret mode); K8's and K3's ``lo`` and tile limits
(``cuda_t.check_tile`` with R band rows); and every K8/K3 shape that
``engine._route`` can hand out on the repo's profiles.

The library form computes with the limb-pair arithmetic of the tensor-core
tile (``csrc/extprod_tile.cuh``), which K8 and K3 now share with K2: int8
digit limbs against balanced int8 key limbs, one s32 sum per limb pair,
shifted by 8(i + l) and added mod 2^32, pairs of weight >= 2^32 and key
limbs below ``lo`` skipped.  The extreme-operand cases (every digit limb and
every key limb -128) pin the largest s32 sums.  The ``gpu`` cases hold the
Hopper kernels against the plain versions on the card and skip without
one; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_rm_mm.py

Tolerance is 0 throughout: the arithmetic is exact mod 2^32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import engine, keys, params  # noqa: E402
from go_tfhe_tpu_torch.ops import (cuda_extprod, cuda_rotate,  # noqa: E402
                                   cuda_step, cuda_t)
from go_tfhe_tpu_torch.ops.blindrotate import block_bands  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402

_BASE = dict(lwe_alpha=1.0 / (1 << 26), lv1_alpha=1.0 / (1 << 30),
             basebit=4, iks_t=6)
# The 128bit_fast knobs (bgbit 8, l 2, lowest key limb dropped) and the
# 128bit knobs (bgbit 6, l 3), block_size 3, at N 256; uint8's digits
# (bgbit 22, l 1: three limbs) with k = 9 blocks folded into the batch.
FAST = dataclasses.replace(params.P128_FAST, name="t_rm_fast", n=256,
                           nbit=8)
EXACT = dataclasses.replace(params.P128, name="t_rm_exact", n=256, nbit=8)
EXT9 = params.TFHEParams(name="t_rm_ext9", lwe_n=4, n=256, nbit=8,
                         bgbit=22, l=1, block_size=1, message_modulus=16,
                         poly_extend_factor=9, **_BASE)
# The balanced key limbs all -128: the band word at lo 0, and with limb 0
# dropped (lo 1).
EXTREME_WORD = {0: 0x7F7F7F80, 1: 0x7F7F8000}


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _operands(p, rows, bp, seed, extreme=False, device="cpu"):
    """Digits (B', ND*R*N), a band (2, R, 2N) packed without the profile's
    band_limb_drop key limbs, and acc (2, B', N)."""
    rng = np.random.default_rng(seed)
    nd, lo, n = p.digit_limbs, cuda_t.band_limb_drop(p), p.n
    if extreme:
        digits = torch.full((bp, nd * rows * n), -128, dtype=torch.int8)
        band = torch.full((2, rows, 2 * n), EXTREME_WORD[lo],
                          dtype=torch.int64).to(torch.int32)
    else:
        digits = torch.from_numpy(
            rng.integers(-128, 128, (bp, nd * rows * n)).astype(np.int8))
        bsk = _u32(rng, (1, rows, 2, n))
        if p.key_grid_bits:
            bsk &= np.uint32(0xFFFFFFFF ^ ((1 << p.key_grid_bits) - 1))
        band = cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"), lo)[0]
    acc = from_numpy_u32(_u32(rng, (2, bp, n)), "cpu")
    return (digits.to(device), band.contiguous().to(device), acc.to(device))


# (profile, band rows, B'): a per-bit step (4 rows), a block step (12), a
# 128bit block step (18 rows, lo 0), uint8's nd 3 with B' = 9 B, and B'
# neither a multiple of 8 nor above 16.
MM_CASES = {"fast_4": (FAST, 4, 8), "fast_12": (FAST, 12, 8),
            "exact_18": (EXACT, 18, 16), "ext9_nd3": (EXT9, 2, 9 * 3),
            "fast_4_ragged": (FAST, 4, 13)}


@pytest.mark.parametrize("extreme", [False, True], ids=["random", "extreme"])
@pytest.mark.parametrize("case", sorted(MM_CASES))
def test_extprod_mm_matches_plain(case, extreme):
    p, rows, bp = MM_CASES[case]
    nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
    digits, band, acc = _operands(p, rows, bp, 1, extreme)
    want = cuda_extprod.extprod_ref(digits, band, acc, nd, lo)
    got = cuda_extprod.extprod_mm(digits, band, acc, nd, lo)
    np.testing.assert_array_equal(to_numpy_u32(got), to_numpy_u32(want))
    key = cuda_extprod.key_columns_i8(band, lo, nd)
    assert [k.shape for k in key] == [
        (rows * p.n, (4 - lo - i) * 2 * p.n) for i in range(nd)
        if 4 - lo - i > 0]
    np.testing.assert_array_equal(
        to_numpy_u32(cuda_extprod.extprod_mm(digits, band, acc, nd, lo,
                                             key=key)), to_numpy_u32(want))


def test_extprod_ref_ignores_lo():
    """``lo`` names the key limbs the band was packed without; the plain
    version's value does not depend on it."""
    for p, rows, bp in (MM_CASES["fast_12"], MM_CASES["ext9_nd3"]):
        digits, band, acc = _operands(p, rows, bp, 2)
        nd = p.digit_limbs
        plain = cuda_extprod.extprod_ref(digits, band, acc, nd)
        for lo in (0, 1):
            assert torch.equal(
                cuda_extprod.extprod_ref(digits, band, acc, nd, lo), plain)
            assert torch.equal(
                cuda_extprod.extprod(digits, band, acc, nd, lo), plain)


def test_extprod_mm_matches_pallas():
    """The library form at the 128bit_fast knobs, a block step's 12 rows,
    == the JAX package's Pallas K8 (interpret mode) on the same digits and
    keys, with the fused accumulator (as test_torch_rowmajor.py's
    test_extprod_ref_matches_pallas builds them)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import go_tfhe_tpu
    from go_tfhe_tpu.ops import pallas_extprod, pallas_rotate
    pallas_extprod.INTERPRET = pallas_rotate.INTERPRET = True
    p, bs, b = FAST, 3, 8
    jp = go_tfhe_tpu.TFHEParams(**dataclasses.asdict(p))
    rng = np.random.default_rng(3)
    acc = _u32(rng, (2, b, p.n))
    amounts = rng.integers(0, 2 * p.n + 1, (bs, b)).astype(np.int32)
    bsk = _u32(rng, (bs, 2 * p.l, 2, p.n)) & np.uint32(0xFFFFFF00)
    digits = pallas_rotate.rotate_decompose_pallas(
        jp, jnp.asarray(acc), jnp.asarray(amounts), tb=8)
    band = pallas_extprod.pack_bsk_band(jnp.asarray(bsk), tn=256)
    w = band.shape[-1]
    band = jnp.moveaxis(band.reshape(bs, 2, 2 * p.l, w), 1, 0).reshape(
        2, bs * 2 * p.l, w)
    want = np.asarray(pallas_extprod.extprod_pallas(
        digits, band, limb_mag=min(p.half_bg, 128), tb=8, tn=256,
        drop_limbs=1, dot_dtype="int8", acc=jnp.asarray(acc)))
    tband = block_bands(dataclasses.replace(p, lwe_n=bs),
                        cuda_t.pack_bsk_band_t(from_numpy_u32(bsk, "cpu"),
                                               1))[0]
    got = cuda_extprod.extprod_mm(
        torch.from_numpy(np.array(digits).reshape(b, -1)), tband,
        from_numpy_u32(acc, "cpu"), 1, 1)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("lo,n,rows,match", [
    (2, 256, 4, "lo=2"),                    # the tile skips 0 or 1 limbs
    (0, 96, 4, "multiple of 64"),
    (0, 1024, 32, "overflow"),              # R*N = 2^15
    (1, 2048, 16, "overflow"),
])
def test_k8_wrapper_refuses_what_the_tile_cannot(lo, n, rows, match):
    """K8 checks the tile's limits for its R band rows before it looks at
    the tensors (meta tensors: no CPU fallback either)."""
    acc = torch.empty((2, 4, n), dtype=torch.int32, device="meta")
    band = torch.empty((2, rows, 2 * n), dtype=torch.int32, device="meta")
    digits = torch.empty((4, rows * n), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match=match):
        cuda_extprod.extprod(digits, band, acc, 1, lo)


@pytest.mark.parametrize("knobs,match", [
    (dict(kernel_limb_drop=2, key_grid_bits=16), "lo=2"),   # from p
    (dict(n=32, nbit=5), "multiple of 64"),
    (dict(n=2048, nbit=11, l=8, bgbit=4), "overflow"),     # 2L*N = 2^15
])
def test_k3_wrapper_refuses_what_the_tile_cannot(knobs, match):
    p = dataclasses.replace(FAST, **knobs)
    acc = torch.empty((2, 4, p.n), dtype=torch.int32, device="meta")
    amounts = torch.empty((4,), dtype=torch.int32, device="meta")
    band = torch.empty((2, 2 * p.l, 2 * p.n), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match=match):
        cuda_step.fused_rotate_step(p, acc, amounts, band)


def _route_shapes(p, route):
    """(K8 band rows ..., K3 band rows or None) of one bootstrap on a
    route, as ops/blindrotate.py hands them out."""
    l2, bs = 2 * p.l, p.block_size
    if route == "blind_rotate_block":
        full, rem = divmod(p.lwe_n, bs)
        return [bs * l2] * bool(full) + [l2] * bool(rem), None
    if route == "blind_rotate_extended_rm":
        return [l2], None
    if route == "blind_rotate_tpu":
        int8_ok = l2 * p.n * min(p.half_bg, 128) * 128 < 1 << 31
        return [l2], (l2 if p.digits_fit_int8 and int8_ok else None)
    return [], None


def test_every_route_hands_k8_and_k3_shapes_the_tile_takes(monkeypatch):
    """Every profile in ``params``, uniform and block-binary keys,
    ``transposed`` True and False, ``PREFER_BLOCK_ROTATION`` and
    ``PREFER_PIPE`` on and off: each K8 and K3 shape on the route that
    ``engine._route`` picks passes ``cuda_t.check_tile`` at the profile's
    ``band_limb_drop`` (N a multiple of 64, R*N < 2^15)."""
    seen = set()
    for prefer_block in (False, True):
        monkeypatch.setattr(engine, "PREFER_BLOCK_ROTATION", prefer_block)
        for prefer_pipe in (False, True):
            monkeypatch.setattr(engine, "PREFER_PIPE", prefer_pipe)
            for p in set(params.PROFILES.values()):
                for block_binary in (False, True):
                    for transposed in (True, False):
                        ck = keys.CloudKey(testvec=None, ksk=None, bsk=None,
                                           bands=None, params=p,
                                           block_binary=block_binary,
                                           transposed=transposed)
                        route = engine._route(ck)
                        rows, k3 = _route_shapes(p, route)
                        lo = cuda_t.band_limb_drop(p)
                        for r in rows + ([k3] if k3 else []):
                            cuda_t.check_tile(route, p.n, r, lo)
                            seen.add((p.name, route, r))
    # the block step at 128bit (R 18) and at 128bit_fast (R 12), uint8's
    # row-major extended step, and both per-bit row-major shapes
    for want in (("128bit", "blind_rotate_block", 18),
                 ("128bit_fast", "blind_rotate_block", 12),
                 ("uint8", "blind_rotate_extended_rm", 2),
                 ("128bit_fast", "blind_rotate_tpu", 4),
                 ("128bit", "blind_rotate_tpu", 6)):
        assert want in seen, want


# ---------------------------------------------------------------------------
# On the card: K8 and K3 against their plain versions.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _counted(fn, counter, *args):
    before = cuda_t.launch_counts[counter]
    out = fn(*args)
    torch.cuda.synchronize()
    assert cuda_t.launch_counts[counter] == before + 1
    return out


GPU_K8 = {"fast_4": (params.P128_FAST, 4), "fast_12": (params.P128_FAST, 12),
          "exact_18": (params.P128, 18),
          "uint8_nd3": (params.UINT8_CENTERED, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("bp", [1, 8, 130])
@pytest.mark.parametrize("case", sorted(GPU_K8))
def test_k8_matches_plain_on_gpu(cuda_device, case, bp):
    """Full widths (N 1024, and uint8's N 2048 with three digit limbs),
    R 4, 12 and 18 band rows, ``lo`` explicit, ragged B'."""
    p, rows = GPU_K8[case]
    nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
    digits, band, acc = _operands(p, rows, bp, 4, device=cuda_device)
    out = _counted(cuda_extprod.extprod, "extprod", digits, band, acc, nd,
                   lo)
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_extprod.extprod_ref(digits, band, acc, nd, lo)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_K8))
def test_k8_extreme_operands_on_gpu(cuda_device, case):
    p, rows = GPU_K8[case]
    nd, lo = p.digit_limbs, cuda_t.band_limb_drop(p)
    digits, band, acc = _operands(p, rows, 64, 5, extreme=True,
                                  device=cuda_device)
    out = _counted(cuda_extprod.extprod, "extprod", digits, band, acc, nd,
                   lo)
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_extprod.extprod_ref(digits, band, acc, nd, lo)))


@pytest.mark.gpu
@pytest.mark.parametrize("lo", [0, 1])
def test_k3_extreme_operands_on_gpu(cuda_device, lo):
    """Every digit -128 (amounts N, acc = (offset - 1 - s) / 2 with s its
    parity, so X^N acc - acc + offset = s) and every key limb -128."""
    p = dataclasses.replace(params.P128_FAST, kernel_limb_drop=lo)
    off, b = p.decomposition_offset, 64
    word = (off - 1 - (off - 1) % 2) // 2
    acc = torch.full((2, b, p.n), word - (word >> 31 << 32),
                     dtype=torch.int32, device=cuda_device)
    amounts = torch.full((b,), p.n, dtype=torch.int32, device=cuda_device)
    assert int(cuda_rotate.rotate_decompose_ref(p, acc, amounts).max()) == \
        -p.half_bg
    band = torch.full((2, 2 * p.l, 2 * p.n), EXTREME_WORD[lo],
                      dtype=torch.int64, device=cuda_device).to(torch.int32)
    out = _counted(cuda_step.fused_rotate_step, "fused_rotate_step", p, acc,
                   amounts, band)
    np.testing.assert_array_equal(
        to_numpy_u32(out),
        to_numpy_u32(cuda_step.fused_rotate_step_ref(p, acc, amounts, band)))
