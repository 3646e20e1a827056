"""The digit-table contraction that the key switch and proxy re-encryption
share (``ops.keyswitch.digit_table_switch``): ``identity_key_switch`` gives
the JAX package's words at TEST_FAST and TEST_PBS, and the words that
tests/test_torch_keyswitch_kernel.py holds the card's kernel to are the
JAX package's; both it and ``proxyreenc.reencrypt`` run the one function,
on both of its paths (the plain version, and the gather-and-sum kernel's
launcher, stood in on the CPU).  Tolerance 0."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from go_tfhe_tpu import params as jparams  # noqa: E402
from go_tfhe_tpu.ops import keyswitch as jks  # noqa: E402
from go_tfhe_tpu_torch import params, proxyreenc  # noqa: E402
from go_tfhe_tpu_torch.ops import keyswitch  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


def _kernel_tests():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_keyswitch_kernel.py")
    spec = importlib.util.spec_from_file_location("kernel_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("profile", ["test_fast", "test_pbs", "128bit"])
def test_the_words_the_card_is_held_to_are_the_jax_packages(profile):
    """JAX_WORDS_SHA256, which the card's kernel must give on
    jax_case(profile)'s KSK and ciphertexts, is the sha256 of the JAX
    package's identity_key_switch there, and of the port's on the CPU."""
    kt = _kernel_tests()
    assert set(kt.JAX_WORDS_SHA256) == {"test_fast", "test_pbs", "128bit"}
    p, ksk, ct = kt.jax_case(profile)
    want = np.asarray(jks.identity_key_switch(
        jparams.get_params(profile), jnp.asarray(ksk), jnp.asarray(ct)))
    assert want.dtype == np.uint32 and want.shape == (2, 3, p.lwe_n + 1)
    assert kt.words_sha256(want) == kt.JAX_WORDS_SHA256[profile]
    got = keyswitch.identity_key_switch(p, _t(ksk), _t(ct))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


@pytest.mark.parametrize("which", ["fast", "pbs"])
def test_identity_key_switch_matches_jax(which, fast_keys, pbs_keys):
    """Random level-1 words (both halves of the torus, the batch over
    leading axes) through the JAX fixture's KSK."""
    p, _, ck = fast_keys if which == "fast" else pbs_keys
    rng = np.random.default_rng(len(which))
    ct = rng.integers(0, 2 ** 32, (2, 3, p.n + 1),
                      dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jks.identity_key_switch(p, ck.ksk, jnp.asarray(ct)))
    got = keyswitch.identity_key_switch(params.get_params(p.name),
                                        _t(ck.ksk), _t(ct))
    assert got.shape == (2, 3, p.lwe_n + 1)
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_key_switch_and_reencrypt_share_the_contraction(monkeypatch,
                                                        fast_keys):
    p, _, ck = fast_keys
    tp = params.get_params(p.name)
    seen = []
    shared = keyswitch.digit_table_switch

    def spy(table, ct, basebit, t, plain=False):
        seen.append((tuple(table.shape), basebit, t))
        return shared(table, ct, basebit, t, plain)

    monkeypatch.setattr(keyswitch, "digit_table_switch", spy)
    rng = np.random.default_rng(9)
    lv1 = _t(rng.integers(0, 2 ** 32, (4, p.n + 1), dtype=np.uint64
                          ).astype(np.uint32))
    lv0 = keyswitch.identity_key_switch(tp, _t(ck.ksk), lv1)
    table = _t(rng.integers(0, 2 ** 32, (p.lwe_n, 5, 8, p.lwe_n + 1),
                            dtype=np.uint64).astype(np.uint32))
    rk = proxyreenc.ProxyReencryptionKey(table=table, basebit=3, t=5)
    out = proxyreenc.reencrypt(rk, lv0)
    shapes = [((p.n, p.iks_t, p.base, p.lwe_n + 1), p.basebit, p.iks_t),
              ((p.lwe_n, 5, 8, p.lwe_n + 1), 3, 5)]
    assert seen == shapes
    np.testing.assert_array_equal(out.numpy(),
                                  shared(table, lv0, 3, 5).numpy())
    # Each path of the one function serves both callers: the plain version
    # where the kernel's rule refuses (as on the CPU), the kernel's
    # launcher where it takes the shapes (stood in here by the plain
    # version's words).
    plain = keyswitch.digit_table_switch_ref
    for path in ("plain", "kernel"):
        ran = []

        def run(name):
            def call(table_, ct, basebit, t):
                ran.append((name, tuple(table_.shape), basebit, t))
                return plain(table_, ct, basebit, t)
            return call

        monkeypatch.setattr(keyswitch, "takes_kernel",
                            lambda *a, path=path: path == "kernel")
        monkeypatch.setattr(keyswitch, "switch_kernel", run("kernel"))
        monkeypatch.setattr(keyswitch, "digit_table_switch_ref", run("plain"))
        got_lv0 = keyswitch.identity_key_switch(tp, _t(ck.ksk), lv1)
        got = proxyreenc.reencrypt(rk, got_lv0)
        assert ran == [(path, *shape) for shape in shapes]
        np.testing.assert_array_equal(got_lv0.numpy(), lv0.numpy())
        np.testing.assert_array_equal(got.numpy(), out.numpy())
