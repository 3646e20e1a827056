"""The staged-row rotate + decompose kernels K7 and K6 (csrc/rotdec_row.cuh,
rotdec.cu, rotdec_ext.cu) on the CPU.

A CUDA kernel cannot run here, so these cases check what surrounds it and a
model of it:

* the launch plans (ops/cuda_rotate.rotdec_plan, ops/cuda_ext.rotdec_ext_plan)
  of every profile that reaches K7 or K6 fit the card's shared memory and
  cover the batch;
* a numpy model of the kernels, step by step (the staged rows, K6's
  source-block selection, the rotation entries, each thread's coefficient
  group and read order, the flipped and sign-extended digit fields, the limb
  carries, the byte permutes and the 32-bit stores in both digit layouts),
  equals the plain versions bit for bit, at the edge amounts;
* that model's shared-memory reads are bank-conflict free.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import params  # noqa: E402
from go_tfhe_tpu_torch.ops import (cuda_ext, cuda_ext_t,  # noqa: E402
                                   cuda_rotate, cuda_t)
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32  # noqa: E402
from test_torch_rowmajor import K6_SHAPES, ROT_SHAPES  # noqa: E402

_BASE = dict(lwe_n=8, lwe_alpha=1.0 / (1 << 26), lv1_alpha=1.0 / (1 << 30),
             nbit=8, basebit=4, iks_t=6, block_size=3)
# K7 beyond ROT_SHAPES: the 128bit gadget (bgbit 6, l 3), TEST_BLOCK's N 128
# (its block rotation also runs a bs-1 tail) and uint4 (N 2048, nd 3).
K7_SHAPES = {**ROT_SHAPES,
             "bg6_l3": params.TFHEParams(name="t_row_bg6", n=256, bgbit=6,
                                         l=3, **_BASE),
             "n128": params.TEST_BLOCK, "uint4": params.UINT4}


def _k7_profiles():
    """Every profile that reaches K7: route (b) at bs 1 for each
    non-extended profile, the block rotation at its block_size."""
    return sorted({p.name: p for p in params.PROFILES.values()
                   if p.poly_extend_factor == 1}.items())


def _k6_profiles():
    """Every profile that reaches K6: the extended ones K4 does not take."""
    return sorted({p.name: p for p in params.PROFILES.values()
                   if p.poly_extend_factor > 1
                   and not cuda_ext_t.ext_t_fits(p)}.items())


@pytest.mark.parametrize("b", [1, 255, 256, 4096])
def test_plans_fit_and_cover_every_profile(b):
    """K7: blocks of 16 KB of consecutive accumulator rows (c*B + b) that
    cover the 2B rows; K6: a block a (ciphertext, output block).  The
    staged words and rotations fit the shared memory a block gets without
    opting in; whole warps, whole rows' threads, 4 coefficients a
    thread."""
    k7, k6 = _k7_profiles(), _k6_profiles()
    assert {"128bit_fast", "128bit", "uint4", "test_block"} <= dict(k7).keys()
    assert {"uint8", "uint8_centered"} == dict(k6).keys()
    for _, p in k7:
        for bs in sorted({1, p.block_size}):
            plan = cuda_rotate.rotdec_plan(p.n, b, bs)
            rows = plan.rows
            assert rows * p.n * 4 == max(16384, 4 * p.n)
            assert plan.grid[1:] == (1, 1)
            assert (plan.grid[0] - 1) * rows < 2 * b <= plan.grid[0] * rows
            assert plan.smem == 4 * rows * (p.n + bs) <= cuda_t.ROW_SMEM_LIMIT
            assert plan.threads == 256
            assert plan.threads % min(p.n // 4, plan.threads) == 0
    for _, p in k6:
        k, n = p.poly_extend_factor, p.n
        plan = cuda_ext.rotdec_ext_plan(n, k, b)
        assert plan.grid == (b, k, 1) and plan.rows == 2
        assert plan.smem == 4 * (4 * n + 1) <= cuda_t.ROW_SMEM_LIMIT
        assert plan.threads == 256


def test_plans_refuse_what_the_kernel_does_not_take():
    """An empty batch, N not a multiple of 128, rows beyond the shared
    memory a block gets without opting in."""
    with pytest.raises(ValueError, match="empty batch"):
        cuda_rotate.rotdec_plan(1024, 0, 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_rotate.rotdec_plan(1000, 8, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_ext.rotdec_ext_plan(64, 2, 8)
    with pytest.raises(ValueError, match="empty batch"):
        cuda_ext.rotdec_ext_plan(2048, 9, 0)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_ext.rotdec_ext_plan(4096, 9, 4)


# ---------------------------------------------------------------------------
# The numpy model of rotdec_row.cuh, rotdec.cu and rotdec_ext.cu.
# ---------------------------------------------------------------------------

def _rot_entry(a, n, k, rp):
    """rotdec_row.cuh rot_entry: (rr, flip, sel) of amount a for output
    block rp."""
    big = 2 * k * n
    t = int(a) % big
    r = (rp - t) % k
    q = (t + r - rp) // k
    q = q - 2 * n if q >= 2 * n else q
    return q % n, q >= n, r


def _byte_perm(x, y, s):
    """__byte_perm(x, y, s) on uint32 arrays (selectors 0..7)."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    s = np.asarray(s, np.uint64)
    out = np.zeros(np.broadcast(src, s).shape, np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((src >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << \
            np.uint64(8 * i)
    return out.astype(np.uint32)


def _read_place(g):
    """row_digits' `place`: step t's byte -> byte (t + g) & 3."""
    place = np.zeros_like(g, np.uint32)
    for t in range(4):
        place |= np.uint32(t if t < 2 else t + 2) << (4 * ((t + g) & 3)
                                                      ).astype(np.uint32)
    return place


def _bank_degree(addrs):
    """Most distinct word addresses that fall in one bank (1: no
    conflict; lanes reading one address share it)."""
    addrs = np.unique(addrs)
    return int(np.bincount(addrs % 32).max())


def _stage(words, vec):
    """stage: the row copied into shared memory in 16-byte pieces (vec)
    or 4-byte ones, every word exactly once."""
    piece = 4 if vec else 1
    staged = np.zeros_like(words)
    copies = np.zeros(len(words), np.int64)
    for i in range(len(words) // piece):
        staged[piece * i:piece * (i + 1)] = words[piece * i:piece * (i + 1)]
        copies[piece * i:piece * (i + 1)] += 1
    assert (copies == 1).all()
    return staged


def _emit_digits(tmp, place, p):
    """row_digits' digit rows: {(lv, limb i): the packed 32-bit words}
    of the four step-order fields tmp[t]."""
    words = {}
    for lv in range(p.l):
        if p.bgbit == 8 and p.digit_limbs == 1:      # the fields' bytes
            pick = (3 - lv) | (7 - lv) << 4
            words[lv, 0] = _byte_perm(_byte_perm(tmp[0], tmp[1], pick),
                                      _byte_perm(tmp[2], tmp[3], pick), place)
            continue
        d = [(x << np.uint32(lv * p.bgbit)).view(np.int32) >> (32 - p.bgbit)
             for x in tmp]
        for i in range(p.digit_limbs):
            w = [x.view(np.uint32) for x in d]
            words[lv, i] = _byte_perm(_byte_perm(w[0], w[1], 0x40),
                                      _byte_perm(w[2], w[3], 0x40), place)
            d = [(x + 128) >> 8 for x in d]
    return words


def _row_digits(p, smem, src_at, x0_at, rots, count, store, degrees):
    """rotdec_row.cuh row_digits over one row, by its ``count`` threads:
    smem the block's shared words, src_at / x0_at where its source and
    unrotated rows start, rots the (rr, flip) of each rotation j.  Hands
    store(j, lv, i, n0, words) each 32-bit store; appends each warp's
    bank-conflict degree per load to ``degrees``."""
    n = p.n
    u = np.arange(n // 4)
    g = ((u % count) >> 3) & 3        # v = the thread's place on the row
    n0 = 4 * u
    place = _read_place(g)
    top = np.uint32(sum(1 << (31 - lv * p.bgbit) for lv in range(p.l)))
    off = np.uint32(p.decomposition_offset)
    warps = [slice(w, w + 32) for w in range(0, len(u), 32)]
    x, x_addr = [], []
    for t in range(4):
        x_addr.append(x0_at + n0 + ((t + g) & 3))
        x.append(smem[x_addr[-1]])
    for j, (rr, flip) in enumerate(rots):
        tmp, s_addr = [], []
        for t in range(4):
            s = n0 + ((t + g) & 3) - rr
            m = s >> 31                       # -1 where the source wraps
            s = s + (n & m)
            s_addr.append(src_at + s)
            xr = smem[s_addr[-1]] ^ np.uint32(0xFFFFFFFF if flip else 0) \
                ^ m.astype(np.uint32)
            tmp.append((xr - x[t] + off) ^ top)
        if degrees is not None:
            for t in range(4):
                for w in warps:
                    degrees.append(_bank_degree(s_addr[t][w]))
                    if j == 0:
                        degrees.append(_bank_degree(x_addr[t][w]))
        for (lv, i), words in _emit_digits(tmp, place, p).items():
            store(j, lv, i, n0, words)


class _Out:
    """The digit buffer (B, C) int8 as the kernel writes it: 32-bit words at
    4-byte aligned offsets, every byte exactly once."""

    def __init__(self, b, cols):
        self.bytes = np.zeros(b * cols, np.uint8)
        self.writes = np.zeros(b * cols, np.int64)
        self.shape = (b, cols)

    def store(self, at, words):
        assert (at % 4 == 0).all()
        for k in range(4):
            self.bytes[at + k] = (words >> np.uint32(8 * k)).astype(np.uint8)
            self.writes[at + k] += 1

    def result(self):
        assert (self.writes == 1).all()
        return self.bytes.view(np.int8).reshape(self.shape)


def model_k7(p, acc, amounts, vec=True, degrees=None):
    """rotdec.cu for acc (2, B, N) uint32 and amounts (bs, B): the digits
    (B, ND*bs*2L*N) int8 as its wrapper launches it (rotdec_plan)."""
    n, l, nd = p.n, p.l, p.digit_limbs
    bs, b = amounts.shape
    plan = cuda_rotate.rotdec_plan(n, b, bs)
    per_row = min(n // 4, plan.threads)
    digit_rows = 2 * l * n                          # one block bit's
    out = _Out(b, nd * bs * digit_rows)
    flat = acc.reshape(2 * b * n)                   # rows c*B + b
    for blk in range(plan.grid[0]):
        r0 = blk * plan.rows
        nr = min(plan.rows, 2 * b - r0)
        half = (nr + 1) // 2                        # two cp.async groups
        smem = np.concatenate([
            _stage(flat[r0 * n:(r0 + half) * n], vec),
            _stage(flat[(r0 + half) * n:(r0 + nr) * n], vec)])
        for r in range(nr):
            c, bi = divmod(r0 + r, b)
            rots = [_rot_entry(amounts[j, bi], n, 1, 0)[:2]
                    for j in range(bs)]
            base = bi * nd * bs * digit_rows + c * l * n

            def store(j, lv, i, n0, words, base=base):
                out.store(base + j * digit_rows + i * bs * digit_rows
                          + lv * n + n0, words)
            _row_digits(p, smem, r * n, r * n, rots, per_row, store, degrees)
    return out.result()


def model_k6(p, acc, amounts, vec=True, degrees=None):
    """rotdec_ext.cu for acc (2, B, kN) uint32 and amounts (B,): the digits
    (B, k*ND*2L*N) int8 as its wrapper launches it (rotdec_ext_plan)."""
    k, n, l, nd = p.poly_extend_factor, p.n, p.l, p.digit_limbs
    b = acc.shape[1]
    plan = cuda_ext.rotdec_ext_plan(n, k, b)
    digit_rows = 2 * l * n                          # one limb's
    out = _Out(b, k * nd * digit_rows)
    for bi in range(b):
        for rp in range(k):                         # blockIdx (bi, rp)
            rr, flip, sel = _rot_entry(amounts[bi], n, k, rp)
            smem = np.zeros(4 * n, np.uint32)       # [c][block r' | r]
            for c in range(2):
                row = acc[c, bi]
                smem[2 * c * n:(2 * c + 1) * n] = _stage(
                    row[rp * n:(rp + 1) * n], vec)
                if sel != rp:
                    smem[(2 * c + 1) * n:(2 * c + 2) * n] = _stage(
                        row[sel * n:(sel + 1) * n], vec)
            base = (bi * k + rp) * nd * digit_rows
            for c in range(2):
                def store(j, lv, i, n0, words, at=base + c * l * n):
                    out.store(at + i * digit_rows + lv * n + n0, words)
                x0_at = 2 * c * n
                _row_digits(p, smem, x0_at + n if sel != rp else x0_at,
                            x0_at, [(rr, flip)], plan.threads, store, degrees)
    return out.result()


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _k7_inputs(p, bs, b, seed):
    """acc (2, B, N), amounts (bs, B) over [0, 2N] with 0, N, 2N - 1 and 2N
    among each block bit's."""
    rng = np.random.default_rng(seed)
    amounts = rng.integers(0, 2 * p.n + 1, (bs, b)).astype(np.int32)
    for j in range(bs):
        edges = np.roll([0, p.n, 2 * p.n - 1, 2 * p.n], j)[:b]
        amounts[j, :len(edges)] = edges
    return _u32(rng, (2, b, p.n)), amounts


def _k6_inputs(p, b, seed):
    """acc (2, B, kN), amounts over [0, 2kN] with 0, kN, 2kN - 1 and 2kN."""
    rng = np.random.default_rng(seed)
    k, n = p.poly_extend_factor, p.n
    big = 2 * k * n
    t = rng.integers(0, big + 1, b).astype(np.int32)
    t[:4] = [0, k * n, big - 1, big][:b]
    return _u32(rng, (2, b, k * n)), t


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("bs", [1, 2, 3])
@pytest.mark.parametrize("shape", sorted(K7_SHAPES))
def test_k7_model_matches_plain(shape, bs, b):
    p = K7_SHAPES[shape]
    acc, amounts = _k7_inputs(p, bs, b, 10 * bs + b)
    want = cuda_rotate.rotate_decompose_ref(p, from_numpy_u32(acc, "cpu"),
                                            torch.from_numpy(amounts))
    np.testing.assert_array_equal(model_k7(p, acc, amounts), want.numpy())


@pytest.mark.parametrize("b", [1, 6])
@pytest.mark.parametrize("shape", sorted(K6_SHAPES))
def test_k6_model_matches_plain(shape, b):
    p = K6_SHAPES[shape]
    acc, t = _k6_inputs(p, b, 20 + b)
    want = cuda_ext.rotate_decompose_ext_ref(p, from_numpy_u32(acc, "cpu"),
                                             torch.from_numpy(t))
    np.testing.assert_array_equal(model_k6(p, acc, t), want.numpy())


def test_model_stages_a_misaligned_view_in_4_byte_pieces():
    """An accumulator that is not 16-byte aligned is staged word by word;
    the digits are the same."""
    p = K7_SHAPES["bg18_l1_nd3"]
    acc, amounts = _k7_inputs(p, 3, 3, 5)
    np.testing.assert_array_equal(model_k7(p, acc, amounts, vec=False),
                                  model_k7(p, acc, amounts))
    p = K6_SHAPES["test_ext3"]
    acc, t = _k6_inputs(p, 3, 6)
    np.testing.assert_array_equal(model_k6(p, acc, t, vec=False),
                                  model_k6(p, acc, t))


# (kernel, shape, B): N 128 (one warp a block), 256, 1024 (256 threads)
# and 2048 (two groups a thread).
CONFLICT_CASES = {
    "k7_n128": ("k7", params.TEST_BLOCK, 3),
    "k7_n256": ("k7", K7_SHAPES["bg8_l2_lo1"], 3),
    "k7_128bit_fast": ("k7", params.P128_FAST, 2),
    "k7_n2048": ("k7", params.UINT4, 2),
    "k6_ext3": ("k6", K6_SHAPES["test_ext3"], 3),
    "k6_uint8": ("k6", params.UINT8_CENTERED, 1),
}


@pytest.mark.parametrize("case", sorted(CONFLICT_CASES))
def test_model_reads_are_bank_conflict_free(case):
    """Every warp's rotated-word and unrotated-word loads hit each bank at
    most once, with random rotations and the edge amounts."""
    kernel, p, b = CONFLICT_CASES[case]
    degrees = []
    if kernel == "k7":
        acc, amounts = _k7_inputs(p, p.block_size, b, 30 + b)
        model_k7(p, acc, amounts, degrees=degrees)
    else:
        acc, t = _k6_inputs(p, b, 40 + b)
        model_k6(p, acc, t, degrees=degrees)
    assert len(degrees) > 0 and max(degrees) == 1
