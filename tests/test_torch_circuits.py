"""The port's circuit library against the JAX package: the gates NOT, COPY,
MUX, MUX_3GATE and constant, the adders (boolean ripple carry, many-LUT,
the 3-PBS nibble adder) and the comparators.

JAX keys and ciphertexts cross over as numpy arrays
(``keys.cloud_key_from_numpy``); the port runs on the CPU (the kernels'
plain versions) and must give the JAX package's words.  Tolerance is 0
throughout: the arithmetic is exact mod 2^32.  The ``gpu`` cases run the
same circuits on the card and hold them to CPU copies; JAX is imported only
by the cases that use it, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_circuits.py
"""

import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import (bitutils, cipher, engine, gates,  # noqa: E402
                               keys, params)
from go_tfhe_tpu_torch.models import adders, comparators  # noqa: E402
from go_tfhe_tpu_torch.ops import cuda_t  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _u(x):
    return to_numpy_u32(x)


def _port_ck(ck):
    return keys.cloud_key_from_numpy(
        ck.params.name, np.asarray(ck.testvec), np.asarray(ck.ksk),
        np.asarray(ck.bsk), ck.block_binary, device="cpu")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax

    import go_tfhe_tpu as jtfhe
    from go_tfhe_tpu import bitutils as jbitutils
    from go_tfhe_tpu import cipher as jcipher
    from go_tfhe_tpu import gates as jgates
    from go_tfhe_tpu.models import adders as jadders
    from go_tfhe_tpu.models import comparators as jcomparators
    return types.SimpleNamespace(jax=jax, tfhe=jtfhe, cipher=jcipher,
                                 gates=jgates, bitutils=jbitutils,
                                 adders=jadders, comparators=jcomparators)


# The 8 (sel, then, else) combinations, as three bit columns.
SEL, THEN, ELSE = (np.asarray(c, bool) for c in
                   zip(*itertools.product([False, True], repeat=3)))


@pytest.fixture(scope="module")
def fast(jx, fast_keys):
    """TEST_FAST keys of both packages and the 8 MUX input triples."""
    p, sk, ck = fast_keys
    ks = jx.jax.random.split(jx.jax.random.PRNGKey(51), 3)
    cts = [jx.cipher.lwe_encrypt_bool(k, bits, p.lwe_alpha, sk.lv0)
           for k, bits in zip(ks, (SEL, THEN, ELSE))]
    return types.SimpleNamespace(p=p, sk=sk, ck=ck, tck=_port_ck(ck),
                                 key=_t(sk.lv0), cts=cts)


# ---------------------------------------------------------------------------
# Gates.
# ---------------------------------------------------------------------------

def test_not_and_copy_match_jax(jx, fast):
    ct = fast.cts[0]
    got = gates.NOT(_t(ct))
    np.testing.assert_array_equal(_u(got), np.asarray(jx.gates.NOT(ct)))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, fast.key).numpy(), ~SEL)
    src = _t(ct)
    copy = gates.COPY(src)
    np.testing.assert_array_equal(_u(copy), np.asarray(jx.gates.COPY(ct)))
    copy[0, 0] += 1                                  # a copy, not a view
    np.testing.assert_array_equal(_u(src), np.asarray(ct))


@pytest.mark.parametrize("value,batch_shape", [
    (True, ()), (False, ()), (False, (2, 3)),
    (np.asarray([True, False, True]), (2, 3))])
def test_constant_matches_jax(jx, fast, value, batch_shape):
    want = np.asarray(jx.gates.constant(fast.p, value, batch_shape))
    got = gates.constant(params.TEST_FAST, value, batch_shape, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, fast.key).numpy(),
        np.broadcast_to(value, batch_shape))


def test_mux_matches_jax(jx, fast, monkeypatch):
    """MUX is two bootstraps without key switch and one key switch, and
    gives jgates.MUX's words; MUX_3GATE gives jgates.MUX_3GATE's."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(engine, "bootstrap",
                        spy("bootstrap", engine.bootstrap))
    monkeypatch.setattr(engine, "bootstrap_without_key_switch",
                        spy("no_ks", engine.bootstrap_without_key_switch))
    monkeypatch.setattr(gates, "identity_key_switch",
                        spy("key_switch", gates.identity_key_switch))
    sel, then, other = (_t(c) for c in fast.cts)
    got = gates.MUX(fast.tck, sel, then, other)
    assert calls == ["no_ks", "no_ks", "key_switch"]
    np.testing.assert_array_equal(
        _u(got), np.asarray(jx.gates.MUX(fast.ck, *fast.cts)))
    want_bits = np.where(SEL, THEN, ELSE)
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, fast.key).numpy(), want_bits)

    got3 = gates.MUX_3GATE(fast.tck, sel, then, other)
    np.testing.assert_array_equal(
        _u(got3), np.asarray(jx.gates.MUX_3GATE(fast.ck, *fast.cts)))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got3, fast.key).numpy(), want_bits)


# ---------------------------------------------------------------------------
# Boolean adders at TEST_FAST.
# ---------------------------------------------------------------------------

def test_half_and_full_adder_match_jax(jx, fast):
    a, b, c = (_t(x) for x in fast.cts)
    ja, jb, jc = fast.cts
    for got, want in ((adders.half_adder(fast.tck, a, b),
                       jx.adders.half_adder(fast.ck, ja, jb)),
                      (adders.full_adder(fast.tck, a, b, c),
                       jx.adders.full_adder(fast.ck, ja, jb, jc))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u(g), np.asarray(w))
    s, carry = adders.full_adder(fast.tck, a, b, c)
    total = SEL.astype(int) + THEN + ELSE
    dec = lambda x: cipher.lwe_decrypt_bool(x, fast.key).numpy()  # noqa: E731
    np.testing.assert_array_equal(dec(s), total & 1)
    np.testing.assert_array_equal(dec(carry), total >> 1)


def test_ripple_carry_add_matches_jax(jx, fast):
    """A 4-bit ripple-carry add at batch 2 (11 + 7, 9 + 9)."""
    pairs = [(11, 7), (9, 9)]
    a = np.stack([bitutils.to_bits(x, 4) for x, _ in pairs])
    b = np.stack([bitutils.to_bits(y, 4) for _, y in pairs])
    ka, kb = jx.jax.random.split(jx.jax.random.PRNGKey(52))
    ca = jx.bitutils.encrypt_bits(ka, a, fast.p.lwe_alpha, fast.sk.lv0)
    cb = jx.bitutils.encrypt_bits(kb, b, fast.p.lwe_alpha, fast.sk.lv0)
    want_s, want_c = jx.adders.ripple_carry_add(fast.ck, ca, cb)
    s, carry = adders.ripple_carry_add(fast.tck, _t(ca), _t(cb))
    assert s.shape == (2, 4, fast.p.lwe_n + 1)
    np.testing.assert_array_equal(_u(s), np.asarray(want_s))
    np.testing.assert_array_equal(_u(carry), np.asarray(want_c))
    dec = bitutils.decrypt_bits(s, fast.key).numpy()
    cdec = cipher.lwe_decrypt_bool(carry, fast.key).numpy()
    for i, (x, y) in enumerate(pairs):
        assert bitutils.from_bits(dec[i]) + (int(cdec[i]) << 4) == x + y


# ---------------------------------------------------------------------------
# Many-LUT and nibble adders at TEST_NIBBLE.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nibble(jx):
    p = jx.tfhe.TEST_NIBBLE
    k1, k2 = jx.jax.random.split(jx.jax.random.PRNGKey(53))
    sk = jx.tfhe.gen_secret_key(k1, p)
    ck = jx.tfhe.gen_cloud_key(k2, sk, p)
    return types.SimpleNamespace(p=p, sk=sk, ck=ck, tck=_port_ck(ck),
                                 key=_t(sk.lv0))


def test_full_adder_manylut_matches_jax(jx, nibble):
    ks = jx.jax.random.split(jx.jax.random.PRNGKey(54), 3)
    cts = [jx.bitutils.encrypt_bits_messages(k, bits, nibble.p.lwe_alpha,
                                             nibble.sk.lv0)
           for k, bits in zip(ks, (SEL, THEN, ELSE))]
    want = jx.adders.full_adder_manylut(nibble.ck, *cts)
    got = adders.full_adder_manylut(nibble.tck, *(_t(c) for c in cts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    total = SEL.astype(int) + THEN + ELSE
    for g, bit in zip(got, (total & 1, total >> 1)):
        np.testing.assert_array_equal(
            bitutils.decrypt_bits_messages(g, nibble.key).numpy(), bit)


def test_ripple_add_manylut_matches_jax(jx, nibble):
    """A 4-bit many-LUT ripple add at batch 2 (13 + 6, 15 + 15)."""
    pairs = [(13, 6), (15, 15)]
    a = np.stack([bitutils.to_bits(x, 4) for x, _ in pairs])
    b = np.stack([bitutils.to_bits(y, 4) for _, y in pairs])
    ka, kb = jx.jax.random.split(jx.jax.random.PRNGKey(55))
    enc = jx.bitutils.encrypt_bits_messages
    ca = enc(ka, a, nibble.p.lwe_alpha, nibble.sk.lv0)
    cb = enc(kb, b, nibble.p.lwe_alpha, nibble.sk.lv0)
    want_s, want_c = jx.adders.ripple_add_manylut(nibble.ck, ca, cb)
    s, carry = adders.ripple_add_manylut(nibble.tck, _t(ca), _t(cb))
    np.testing.assert_array_equal(_u(s), np.asarray(want_s))
    np.testing.assert_array_equal(_u(carry), np.asarray(want_c))
    dec = bitutils.decrypt_bits_messages(s, nibble.key).numpy()
    cdec = bitutils.decrypt_bits_messages(carry, nibble.key).numpy()
    for i, (x, y) in enumerate(pairs):
        assert bitutils.from_bits(dec[i]) + (int(cdec[i]) << 4) == x + y


def test_add8_pbs_matches_jax(jx, nibble):
    """0xA7 + 0x5C (tests/test_adders.py), 0xFF + 0x01 and 0x3C + 0x42 in
    one batch."""
    va = np.asarray([0xA7, 0xFF, 0x3C])
    vb = np.asarray([0x5C, 0x01, 0x42])
    ks = jx.jax.random.split(jx.jax.random.PRNGKey(56), 4)
    nibbles = (va & 0xF, va >> 4, vb & 0xF, vb >> 4)
    cts = [jx.cipher.lwe_encrypt_message(k, v, 32, nibble.p.lwe_alpha,
                                         nibble.sk.lv0)
           for k, v in zip(ks, nibbles)]
    want = jx.adders.add8_pbs(nibble.ck, *cts)
    got = adders.add8_pbs(nibble.tck, *(_t(c) for c in cts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    lo, hi = (cipher.lwe_decrypt_message(g, 32, nibble.key).numpy() & 0xF
              for g in got)
    np.testing.assert_array_equal((hi << 4) | lo, (va + vb) & 0xFF)
    tables = adders.make_adder_luts(nibble.tck)
    jtables = jx.adders.make_adder_luts(nibble.ck)
    for g, w in zip(tables, jtables):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(_u(g), np.asarray(w))


# ---------------------------------------------------------------------------
# Comparators at TEST_PBS, exhaustively on [0, 4)^2.
# ---------------------------------------------------------------------------

CMP = ("ge", "le", "gt", "lt", "eq", "neq")
CMP_TRUTH = {"ge": np.greater_equal, "le": np.less_equal, "gt": np.greater,
             "lt": np.less, "eq": np.equal, "neq": np.not_equal}


@pytest.fixture(scope="module")
def cmp_inputs(jx, pbs_keys):
    p, sk, ck = pbs_keys
    m = p.message_modulus
    pairs = list(itertools.product(range(m // 2), repeat=2))
    a = np.asarray([x for x, _ in pairs])
    b = np.asarray([y for _, y in pairs])
    ka, kb = jx.jax.random.split(jx.jax.random.PRNGKey(57))
    ct_a = jx.cipher.lwe_encrypt_message(ka, a, m, p.lwe_alpha, sk.lv0)
    ct_b = jx.cipher.lwe_encrypt_message(kb, b, m, p.lwe_alpha, sk.lv0)
    return types.SimpleNamespace(ck=ck, tck=_port_ck(ck), key=_t(sk.lv0),
                                 a=a, b=b, ct_a=ct_a, ct_b=ct_b)


@pytest.mark.parametrize("name", CMP)
def test_comparator_matches_jax(jx, cmp_inputs, name):
    c = cmp_inputs
    want = getattr(jx.comparators, name)(c.ck, c.ct_a, c.ct_b)
    got = getattr(comparators, name)(c.tck, _t(c.ct_a), _t(c.ct_b))
    np.testing.assert_array_equal(_u(got), np.asarray(want))
    np.testing.assert_array_equal(
        cipher.lwe_decrypt_bool(got, c.key).numpy(),
        CMP_TRUTH[name](c.a, c.b))


# ---------------------------------------------------------------------------
# On the card: the circuits on CUDA tensors equal the same calls on CPU
# copies (port keys, no JAX).
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _port_keys(p, seed):
    gen = torch.Generator().manual_seed(seed)
    sk = keys.gen_secret_key(gen, p, "cpu")
    return gen, sk, keys.gen_cloud_key(gen, sk, p)


def _inputs(gen, p, sk, n, messages):
    """Two batches of n ciphertexts: bits, or with ``messages`` = (m, hi)
    values in [0, hi) encrypted as modulus-m messages."""
    rng = np.random.default_rng(n)
    if messages is None:
        return [cipher.lwe_encrypt_bool(gen, x, p.lwe_alpha, sk.lv0)
                for x in rng.integers(0, 2, (2, n)).astype(bool)]
    m, hi = messages
    return [cipher.lwe_encrypt_message(gen, x, m, p.lwe_alpha, sk.lv0)
            for x in rng.integers(0, hi, (2, n))]


def _circuit(name):
    """(profile, input encoding, the call) of each circuit on the card."""
    def mux(ck, a, b):
        return (gates.MUX(ck, a, b, gates.NOT(a)),)

    def ripple(ck, a, b):
        return adders.ripple_carry_add(ck, a.view(4, 3, -1), b.view(4, 3, -1))

    def manylut(ck, a, b):
        return adders.ripple_add_manylut(ck, a.view(4, 3, -1),
                                         b.view(4, 3, -1))

    def add8(ck, a, b):
        return adders.add8_pbs(ck, a, b, b, a)

    def compare(ck, a, b):
        return comparators.ge(ck, a, b), comparators.eq(ck, a, b)

    return {"mux": (params.TEST_FAST, None, mux),
            "ripple_carry_add": (params.TEST_FAST, None, ripple),
            "ripple_add_manylut": (params.TEST_NIBBLE, (8, 2), manylut),
            "add8_pbs": (params.TEST_NIBBLE, (32, 16), add8),
            "comparators": (params.TEST_PBS, (8, 4), compare)}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mux", "ripple_carry_add",
                                  "ripple_add_manylut", "add8_pbs",
                                  "comparators"])
def test_circuit_on_gpu_matches_cpu(cuda_device, name):
    p, messages, call = _circuit(name)
    gen, sk, ck = _port_keys(p, 61)
    a, b = _inputs(gen, p, sk, 12, messages)
    want = call(ck, a, b)
    cuda_t.reset_launch_counts()
    got = call(ck.to(cuda_device), a.to(cuda_device), b.to(cuda_device))
    # every step of a rotation launches K2 or the fused step, which counts
    # as one (batches of at most cuda_t.FUSED_BATCH_MAX launch no K1)
    assert cuda_t.launch_counts["extprod_t"] > 0
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(_u(g), _u(w))
