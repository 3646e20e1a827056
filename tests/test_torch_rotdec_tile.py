"""The staged-column rotate + decompose kernels K1 and K4
(csrc/rotdec_col.cuh, rotdec_t.cu, rotdec_ext_t.cu) on the CPU.

A CUDA kernel cannot run here, so these cases check what surrounds it and a
model of it:

* the launch plans (ops/cuda_t.rotdec_t_plan, ops/cuda_ext_t.rotdec_ext_t_plan)
  of every profile that reaches K1 or K4 fit the card's shared memory and
  cover the batch, and each tile width of the kernel is reached by a shape;
* a numpy model of the kernels, step by step (the staged column, the
  rotation table, each thread's rows and read order, the flipped and
  sign-extended digit fields, the limb carries, the byte packing, the
  direct or chunked digit layout, and K4's second pass) equals the plain
  versions;
* that model's shared-memory accesses are bank-conflict free.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import params  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_ext_t, cuda_t  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32  # noqa: E402

THREADS = 256                  # rotdec_col.cuh kThreads (and the untiler's)
_BASE = dict(lwe_n=8, lwe_alpha=1.0 / (1 << 24), n=256,
             lv1_alpha=1.0 / (1 << 30), nbit=8, basebit=4, iks_t=6,
             block_size=1)
# test_torch_kernels_t.py's three K1 digit shapes, test_torch_ext.py's K4.
K1_CONFIGS = {
    "bg8_l2_lo1": params.TFHEParams(
        name="t_bg8_lo1", bgbit=8, l=2, kernel_limb_drop=1, key_grid_bits=8,
        centered_decomposition=True, **_BASE),
    "bg6_l3": params.TFHEParams(name="t_bg6", bgbit=6, l=3, **_BASE),
    "bg18_l1_nd3": params.TFHEParams(name="t_bg18", bgbit=18, l=1,
                                     message_modulus=8, **_BASE),
}
K4_CONFIGS = {
    "test_ext2": params.TEST_EXT2, "test_ext3": params.TEST_EXT3,
    "test_ext_wide": params.TFHEParams(
        name="test_ext_wide", lwe_n=6, lwe_alpha=1.0 / (1 << 28), n=256,
        lv1_alpha=1.0 / (1 << 31), nbit=8, bgbit=18, l=1, basebit=4,
        iks_t=6, block_size=1, message_modulus=8, poly_extend_factor=3),
    "uint6_centered": params.UINT6_CENTERED,
    "uint7_centered": params.UINT7_CENTERED}


def _k1_profiles():
    return sorted({p.name: p for p in params.PROFILES.values()
                   if p.poly_extend_factor == 1}.items())


def _k4_profiles():
    return sorted({p.name: p for p in params.PROFILES.values()
                   if p.poly_extend_factor > 1 and cuda_ext_t.ext_t_fits(p)
                   }.items())


@pytest.mark.parametrize("b", [1, 256, 2048, 4096])
def test_plans_fit_and_cover_every_profile(b):
    """Every profile that reaches K1 (k = 1) or K4 (extended, ext_t_fits):
    a block's column and rotation table fit the card; K1's tiles hold 16;
    K4 takes two passes exactly where B % 4 == 0, with tiles of 4 that
    cover the batch exactly (the scratch buffer is the size of the
    digits), else one pass with the widest tile that fits."""
    k1, k4 = _k1_profiles(), _k4_profiles()
    assert {"128bit_fast", "uint4", "uint2"} <= dict(k1).keys()
    assert {"uint6_centered", "uint7_centered"} <= dict(k4).keys()
    for _, p in k1:
        plan = cuda_t.rotdec_t_plan(p.n, b)
        assert plan.smem == 4 * (p.n + 1) * plan.tb <= cuda_t.SMEM_LIMIT
        assert plan.tb == 16 and not plan.two_pass
    for _, p in k4:
        k, n = p.poly_extend_factor, p.n
        plan = cuda_ext_t.rotdec_ext_t_plan(n, k, b)
        assert plan.smem == 4 * k * (n + 1) * plan.tb <= cuda_t.SMEM_LIMIT
        assert plan.two_pass == (b % 4 == 0)
        if plan.two_pass:
            assert plan.tb == 4 and -(-b // plan.tb) * plan.tb == b
        else:                           # the widest tile that fits
            assert plan.tb == 32 or 8 * k * (n + 1) * plan.tb > \
                cuda_t.SMEM_LIMIT


def test_plans_refuse_what_the_kernels_do_not_take():
    """Shapes no profile of the port reaches: N beyond 3,600 (K1), an odd
    N, an empty batch, k = 9 (uint8, which routes to K6)."""
    with pytest.raises(ValueError, match="shared memory"):
        cuda_t.rotdec_t_plan(4096, 8)
    with pytest.raises(ValueError, match="tile width"):
        cuda_t.rotdec_t_plan(1025, 8)
    with pytest.raises(ValueError, match="empty batch"):
        cuda_t.rotdec_t_plan(1024, 0)
    with pytest.raises(ValueError, match="empty batch"):
        cuda_ext_t.rotdec_ext_t_plan(2048, 2, 0)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ext_t.rotdec_ext_t_plan(2048, 9, 256)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ext_t.rotdec_ext_t_plan(2048, 9, 255)


# ---------------------------------------------------------------------------
# The numpy model of rotdec_col.cuh and rotdec_ext_t.cu.
# ---------------------------------------------------------------------------

def _rot_entry(a, n, k, rp):
    """rot_entry: (rr, flip, sel) of amounts a for output block rp."""
    big = 2 * k * n
    t = a.astype(np.int64) % big
    r = (rp - t) % k
    q = (t + r - rp) // k
    q = np.where(q >= 2 * n, q - 2 * n, q)
    return q % n, q >= n, r


def _bank_degree(addrs):
    """Most distinct word addresses that fall in one bank (1: no conflict;
    lanes reading one address share it)."""
    addrs = np.unique(addrs)
    return int(np.bincount(addrs % 32).max())


def _warps(addr, live):
    """The bank-conflict degree of each warp's access (32 consecutive
    lanes in thread order), inactive lanes left out."""
    return [_bank_degree(addr[w:w + 32][live[w:w + 32]])
            for w in range(0, len(addr), 32) if live[w:w + 32].any()]


def model(p, acc, amounts, tb_w, k=1, tiled=False, degrees=None):
    """rotdec_kernel's output for acc (2, k*N, B) uint32, amounts (B,):
    the digit rows (k*ND*2L*N, B) int8, or with ``tiled`` the chunked
    buffer [row group][N / 32][tile][32][TB] (flat int8).  Appends each
    warp's shared-memory bank-conflict degree per gather load to
    ``degrees``."""
    n, l, nd = p.n, p.l, p.digit_limbs
    b = acc.shape[2]
    tiles = -(-b // tb_w)
    bp = tiles * tb_w if tiled else b
    per_row, cycle = tb_w // 4, 32 // tb_w
    off = np.uint32(p.decomposition_offset)
    top = np.uint32(sum(1 << (31 - lv * p.bgbit) for lv in range(l)))
    out = np.full(k * nd * 2 * l * n * bp, 0x55, np.int64)
    # thread tid takes rows tid / P, + THREADS / P, ...: item it = tid + m
    # THREADS is (row it / P, ciphertexts 4 (it % P) ..); lanes in item order
    it = np.arange(n * per_row)
    ni, w0 = it // per_row, 4 * (it % per_row)
    g = (it % THREADS // per_row // cycle) & 3
    assert (g == (ni // cycle) & 3).all()      # one read order a thread
    row_stride = tb_w if tiled else b
    lv_stride = n * bp
    limb_stride, rp_stride = 2 * l * lv_stride, nd * 2 * l * lv_stride
    for tile in range(tiles):
        b0 = tile * tb_w
        tb = min(tb_w, b - b0)
        live = w0 < tb
        am = np.zeros(tb_w, np.int64)
        am[:tb] = amounts[b0:b0 + tb]
        for c in range(2):
            col = np.zeros((k * n, tb_w), np.uint32)      # the staged words
            col[:, :tb] = acc[c, :, b0:b0 + tb]
            base = c * l * lv_stride + (b0 * 32 if tiled else b0)
            for rp in range(k):
                rr, flip, sel = _rot_entry(am, n, k, rp)
                rr[tb:], flip[tb:], sel[tb:] = 0, False, 0
                tmp, shift = [], []
                for t in range(4):
                    j = (t + g) & 3
                    w = w0 + j
                    s = ni - rr[w]
                    wrapped = s < 0
                    s = np.where(wrapped, s + n, s)
                    src_row = sel[w] * n + s
                    xr = col[src_row, w]
                    xr = np.where(wrapped != flip[w], ~xr, xr)
                    tmp.append((xr - col[rp * n + ni, w] + off) ^ top)
                    shift.append(8 * j)
                    if degrees is not None:        # rotated, unrotated word
                        degrees += _warps(src_row * tb_w + w, live)
                        degrees += _warps((rp * n + ni) * tb_w + w, live)
                o = (base + rp * rp_stride + (ni >> 5) * 32 * bp
                     + (ni & 31) * row_stride + w0)
                for lv in range(l):
                    if p.bgbit == 8 and nd == 1:          # the fields' bytes
                        d = [(x >> np.uint32(24 - 8 * lv)).astype(np.int64)
                             for x in tmp]
                    else:                 # sign-extended flipped fields
                        d = [((x << np.uint32(lv * p.bgbit)).view(np.int32)
                              >> (32 - p.bgbit)).astype(np.int64)
                             for x in tmp]
                    for i in range(nd):
                        word = np.zeros(len(it), np.int64)
                        for t in range(4):
                            word |= (d[t] & 255) << shift[t]
                            d[t] = (d[t] + 128) >> 8
                        at = o + i * limb_stride + lv * lv_stride
                        for j in range(4):               # the word's bytes
                            ok = live & ((w0 + j < tb) | tiled)
                            out[at[ok] + j] = (word[ok] >> (8 * j)) & 255
    out = ((out + 128) % 256 - 128).astype(np.int8)
    return out if tiled else out.reshape(-1, b)


def untile_model(scratch, rows, b, n, degrees=None):
    """untile_kernel: the chunked buffer (TB 4, B % 4 == 0) as 32-bit words
    -> the digit rows (rows, B) int8, block by block as the kernel moves
    them; appends the bank-conflict degree of each warp's shared-memory
    store and load to ``degrees``."""
    words = b // 4
    sw = scratch.view(np.uint32)
    out = np.zeros((rows, words), np.uint32)
    f = np.arange(THREADS)
    for grp in range(rows // n):
        for nc in range(n // 32):
            for x0 in range(0, words, 32):
                t = np.zeros((32, 33), np.uint32)
                start = (grp * n + nc * 32) * words + x0 * 32
                x, nl = f >> 3, (f & 7) * 4
                live = x0 + x < words
                for j in range(4):                  # one 16-byte load
                    t[nl[live] + j, x[live]] = sw[start + 4 * f[live] + j]
                    if degrees is not None:
                        degrees += _warps((nl + j) * 33 + x, live)
                nl, x = f >> 3, (f & 7) * 4
                for j in range(4):                  # one 16-byte store
                    ok = x0 + x + j < words
                    out[grp * n + nc * 32 + nl[ok], x0 + x[ok] + j] = \
                        t[nl[ok], x[ok] + j]
                    if degrees is not None:
                        degrees += _warps(nl * 33 + x + j, ok)
    return out.view(np.int8).reshape(rows, b)


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _amounts(rng, big, b):
    """Amounts over [0, big] with 0, big / 2, big - 1 and big among them."""
    t = rng.integers(0, big + 1, b).astype(np.int32)
    t[:4] = [0, big // 2, big - 1, big][:b]
    return t


def model_k1(p, acc, amounts, degrees=None):
    """K1 as its wrapper launches it (rotdec_t_plan)."""
    plan = cuda_t.rotdec_t_plan(p.n, acc.shape[2])
    return model(p, acc, amounts, plan.tb, degrees=degrees)


def model_k4(p, acc, amounts, degrees=None):
    """K4 as its wrapper launches it (rotdec_ext_t_plan): one pass, or the
    chunked first pass and the untiler."""
    k, n, b = p.poly_extend_factor, p.n, acc.shape[2]
    plan = cuda_ext_t.rotdec_ext_t_plan(n, k, b)
    got = model(p, acc, amounts, plan.tb, k, plan.two_pass, degrees)
    if plan.two_pass:
        rows = k * p.digit_limbs * 2 * p.l * n
        got = untile_model(got, rows, b, n, degrees)
    return got


@pytest.mark.parametrize("b", [1, 15, 16, 17])
@pytest.mark.parametrize("cfg", sorted(K1_CONFIGS))
def test_k1_model_matches_plain(cfg, b):
    """B 1, TB - 1, TB and TB + 1 (tiles of 16), amounts 0, N, 2N - 1,
    2N."""
    p = K1_CONFIGS[cfg]
    rng = np.random.default_rng(b)
    acc = _u32(rng, (2, p.n, b))
    amounts = _amounts(rng, 2 * p.n, b)
    want = cuda_t.rotate_decompose_t_ref(p, from_numpy_u32(acc, "cpu"),
                                         torch.from_numpy(amounts))
    np.testing.assert_array_equal(model_k1(p, acc, amounts), want.numpy())


@pytest.mark.parametrize("b", [1, 5, 40])
@pytest.mark.parametrize("cfg", sorted(K4_CONFIGS))
def test_k4_model_matches_plain(cfg, b):
    """One pass at B 1 and 5 with the widest tile that fits (32 at N 256,
    8 at uint6, 4 at uint7), two passes (tiles of 4, chunked scratch,
    untiler) at B 40; amounts 0, kN, 2kN - 1, 2kN."""
    p = K4_CONFIGS[cfg]
    k, n = p.poly_extend_factor, p.n
    rng = np.random.default_rng(k + b)
    acc = _u32(rng, (2, k * n, b))
    amounts = _amounts(rng, 2 * k * n, b)
    want = cuda_ext_t.rotate_decompose_ext_t_ref(
        p, from_numpy_u32(acc, "cpu"), torch.from_numpy(amounts)).numpy()
    np.testing.assert_array_equal(model_k4(p, acc, amounts), want)


# A shape that reaches each tile width of rotdec_col.cuh through the
# wrappers' plans: (kernel, config, B, the plan's tile, two passes).
WIDTH_CASES = {
    "k1_tb16": ("k1", "bg8_l2_lo1", 16, 16, False),
    "k4_tb32": ("k4", "test_ext3", 31, 32, False),
    "k4_tb8_uint6": ("k4", "uint6_centered", 7, 8, False),
    "k4_tb4_uint7": ("k4", "uint7_centered", 3, 4, False),
    "k4_tb4_two_passes": ("k4", "test_ext3", 16, 4, True),
}


@pytest.mark.parametrize("case", sorted(WIDTH_CASES))
def test_model_reads_are_bank_conflict_free(case):
    """Every warp's rotated-word and unrotated-word loads hit each bank at
    most once, at each tile width the plans choose, with random rotations;
    so do the untiler's shared-memory stores and loads."""
    kernel, cfg, b, tb, two_pass = WIDTH_CASES[case]
    rng = np.random.default_rng(100 + b)
    degrees = []
    if kernel == "k1":
        p = K1_CONFIGS[cfg]
        assert cuda_t.rotdec_t_plan(p.n, b).tb == tb
        model_k1(p, _u32(rng, (2, p.n, b)), _amounts(rng, 2 * p.n, b),
                 degrees)
    else:
        p = K4_CONFIGS[cfg]
        k = p.poly_extend_factor
        plan = cuda_ext_t.rotdec_ext_t_plan(p.n, k, b)
        assert (plan.tb, plan.two_pass) == (tb, two_pass)
        model_k4(p, _u32(rng, (2, k * p.n, b)),
                 _amounts(rng, 2 * k * p.n, b), degrees)
    assert len(degrees) > 0 and max(degrees) == 1
