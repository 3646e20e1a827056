"""The blind rotation's route table (ops/blindrotate.ROUTES): every
rotation the engine can pick and every portable one has an entry, each
layout's move in and back keeps every word in its place, only K1 + K2
takes the step graph, and ``rotate`` keeps none of the prologue's tensors
while the steps run.  CPU only; the routes' words against JAX and their
plain paths are in the per-route files (test_torch_portable.py,
test_torch_block.py, test_torch_step.py, test_torch_pipe.py,
test_torch_ext.py, test_torch_rowmajor.py)."""

import itertools
import types
import weakref

import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import engine, params  # noqa: E402
from go_tfhe_tpu_torch.ops import blindrotate  # noqa: E402

# The names engine._route returns (each reached in
# test_route_reaches_exactly_the_kernel_routes), then the portable ones.
KERNEL_ROUTES = ("blind_rotate_t", "blind_rotate_extended_t",
                 "blind_rotate_extended_rm", "blind_rotate_block",
                 "blind_rotate_tpu", "blind_rotate_pipe")
PORTABLE_ROUTES = ("blind_rotate", "blind_rotate_extended",
                   "blind_rotate_block_portable")
EXTENDED = ("blind_rotate_extended_t", "blind_rotate_extended_rm",
            "blind_rotate_extended")
B = 3


def _profile(route):
    return params.TEST_EXT2 if route in EXTENDED else params.TEST_FAST


def _words(gen, shape):
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                         generator=gen).to(torch.int32)


def test_route_reaches_exactly_the_kernel_routes(monkeypatch):
    """Over plain, extended and block profiles, transposed or not,
    block-binary or not, and both path flags, engine._route names the six
    kernel routes and nothing else (it reads only the key's params and
    flags)."""
    seen = set()
    for name, transposed, block, prefer_block, prefer_pipe in (
            itertools.product(("test_fast", "test_ext2", "test_block",
                               "uint8"), *[(False, True)] * 4)):
        monkeypatch.setattr(engine, "PREFER_BLOCK_ROTATION", prefer_block)
        monkeypatch.setattr(engine, "PREFER_PIPE", prefer_pipe)
        seen.add(engine._route(types.SimpleNamespace(
            params=params.get_params(name), transposed=transposed,
            block_binary=block)))
    assert seen == set(KERNEL_ROUTES)
    assert set(blindrotate.ROUTES) == set(KERNEL_ROUTES + PORTABLE_ROUTES)


@pytest.mark.parametrize("route", KERNEL_ROUTES + PORTABLE_ROUTES)
def test_each_route_has_its_entry_and_its_layout_keeps_the_words(route):
    """The entry's layout moves a toy batch in and back unchanged, with
    block r of channel c of ciphertext b at rows (col) or columns (row)
    [rN, (r+1)N); the portable routes keep the batch layout and have no
    kernels; only blind_rotate_t is graphed."""
    r = blindrotate.ROUTES[route]
    p = _profile(route)
    k, n = p.poly_extend_factor, p.n
    gen = torch.Generator().manual_seed(22)
    acc = _words(gen, (B, 2, n) if k == 1 else (B, k, 2, n))
    a_tilda = _words(gen, (B, p.lwe_n))
    moved, amounts = blindrotate._into(r.layout, p, acc, a_tilda)
    assert r.graphed == (route == "blind_rotate_t")
    assert r.portable == (route in PORTABLE_ROUTES)
    if r.portable:
        assert r.kernels == r.plain == ()
        assert moved is acc and amounts is a_tilda
    else:
        assert r.layout in ("col", "row")
        assert r.kernels and len(r.kernels) == len(r.plain)
        assert moved.is_contiguous() and amounts.is_contiguous()
        assert torch.equal(amounts, a_tilda.t())
        blocks = acc.reshape(B, k, 2, n)
        for bi, blk, c, j in itertools.product(range(B), range(k), range(2),
                                               (0, 1, n - 1)):
            at = ((c, blk * n + j, bi) if r.layout == "col"
                  else (c, bi, blk * n + j))
            assert moved[at] == blocks[bi, blk, c, j]
    back = blindrotate._back(r.layout, p, moved)
    assert back.shape == acc.shape
    assert torch.equal(back, acc)


@pytest.mark.parametrize("route", KERNEL_ROUTES + PORTABLE_ROUTES)
def test_no_prologue_tensor_lives_through_the_steps(route, monkeypatch):
    """When the steps start, they hold the only reference to the first
    accumulator, and the test vector's first rotation is gone with it (or
    is that accumulator), so that a step frees it as the loop goes on."""
    p = _profile(route)
    firsts = []

    def keep(fn):
        def first_rotation(*args):
            out = fn(*args)
            firsts.append(weakref.ref(out))
            return out
        return first_rotation

    monkeypatch.setattr(blindrotate, "monomial_mul",
                        keep(blindrotate.monomial_mul))
    monkeypatch.setattr(blindrotate, "monomial_mul_blocks",
                        keep(blindrotate.monomial_mul_blocks))
    freed = []

    def steps(p, bands, acc, a_tilda, ops):
        shape, ref = acc.shape, weakref.ref(acc)
        del acc
        freed.append((ref() is None, [f() is None for f in firsts]))
        return torch.zeros(shape, dtype=torch.int32)

    entry = blindrotate.ROUTES[route]
    monkeypatch.setitem(blindrotate.ROUTES, route, entry._replace(steps=steps))
    gen = torch.Generator().manual_seed(23)
    k = p.poly_extend_factor
    tv = _words(gen, (2, p.n) if k == 1 else (k, 2, p.n))
    out = blindrotate.rotate(route, p, torch.zeros(1), _words(
        gen, (B, p.lwe_n + 1)), tv)
    assert out.shape == (B,) + tv.shape and not out.any()
    assert freed == [(True, [True])]
