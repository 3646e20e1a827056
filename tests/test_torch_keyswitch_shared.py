"""The digit-table contraction that the key switch and proxy re-encryption
share (``ops.keyswitch.digit_table_switch``): ``identity_key_switch`` gives
the JAX package's words at TEST_FAST and TEST_PBS, and both it and
``proxyreenc.reencrypt`` run the one function.  Tolerance 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from go_tfhe_tpu.ops import keyswitch as jks  # noqa: E402
from go_tfhe_tpu_torch import params, proxyreenc  # noqa: E402
from go_tfhe_tpu_torch.ops import keyswitch  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402


def _t(x):
    return from_numpy_u32(np.asarray(x), "cpu")


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

    def spy(table, ct, basebit, t):
        seen.append((tuple(table.shape), basebit, t))
        return shared(table, ct, basebit, t)

    monkeypatch.setattr(keyswitch, "digit_table_switch", spy)
    rng = np.random.default_rng(9)
    lv1 = _t(rng.integers(0, 2 ** 32, (4, p.n + 1), dtype=np.uint64
                          ).astype(np.uint32))
    lv0 = keyswitch.identity_key_switch(tp, _t(ck.ksk), lv1)
    table = _t(rng.integers(0, 2 ** 32, (p.lwe_n, 5, 8, p.lwe_n + 1),
                            dtype=np.uint64).astype(np.uint32))
    rk = proxyreenc.ProxyReencryptionKey(table=table, basebit=3, t=5)
    out = proxyreenc.reencrypt(rk, lv0)
    assert seen == [((p.n, p.iks_t, p.base, p.lwe_n + 1), p.basebit,
                     p.iks_t),
                    ((p.lwe_n, 5, 8, p.lwe_n + 1), 3, 5)]
    np.testing.assert_array_equal(out.numpy(),
                                  shared(table, lv0, 3, 5).numpy())
