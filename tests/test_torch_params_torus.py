"""The port's parameter profiles and torus words against the JAX package.

Every profile of ``go_tfhe_tpu.params.PROFILES`` must equal the port's
copy field by field, derived properties included; torus conversions must
match the transcribed reference vectors bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu import params as jparams  # noqa: E402
from go_tfhe_tpu.utils import torus as jtorus  # noqa: E402
from go_tfhe_tpu_torch import params as tparams  # noqa: E402
from go_tfhe_tpu_torch.utils import torus as ttorus  # noqa: E402

V = np.load(os.path.join(os.path.dirname(__file__), "vectors",
                         "parity_vectors.npz"))

DERIVED = ("bg", "half_bg", "base", "ksk_alpha", "bsk_alpha", "tail_bits",
           "decomposition_offset", "gadget_powers", "ks_prec_offset",
           "mod_switch_offset", "mod_switch_shift", "lut_size", "block_count",
           "use_block_blind_rotation", "digits_fit_int8", "digit_limbs")


def test_profile_names_match():
    assert set(tparams.PROFILES) == set(jparams.PROFILES)
    assert tparams.DEFAULT.name == jparams.DEFAULT.name


@pytest.mark.parametrize("name", sorted(jparams.PROFILES))
def test_profile_matches_jax(name):
    j, t = jparams.PROFILES[name], tparams.get_params(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in DERIVED:
        assert getattr(t, prop) == getattr(j, prop), (name, prop)


def test_get_params_unknown_profile():
    with pytest.raises(KeyError, match="unknown parameter profile"):
        tparams.get_params("no_such_profile")


def test_invalid_profile_rejected():
    with pytest.raises(ValueError):
        dataclasses.replace(tparams.P128_FAST, key_grid_bits=0)


def test_f64_to_torus_vectors():
    np.testing.assert_array_equal(ttorus.f64_to_torus(V["f64_in"]),
                                  V["f64_torus"])
    np.testing.assert_array_equal(ttorus.f64_to_torus(V["f64_in"]),
                                  jtorus.f64_to_torus(V["f64_in"]))


def test_numpy_round_trip_and_views():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2 ** 32, (3, 17), dtype=np.uint64).astype(np.uint32)
    t = ttorus.from_numpy_u32(x, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(ttorus.to_numpy_u32(t), x)
    assert ttorus.to_signed(t) is t and ttorus.to_unsigned(t) is t
    np.testing.assert_array_equal(ttorus.to_numpy_u32(ttorus.torus_not(t)),
                                  ~x)


def test_word_helpers_match_uint32():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    t = ttorus.from_numpy_u32(x, "cpu")
    for s in (0, 1, 8, 21, 31):
        np.testing.assert_array_equal(ttorus.to_numpy_u32(ttorus.shr(t, s)),
                                      x >> np.uint32(s))
    for v in (0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5, -3):
        assert ttorus.i32(v) % 2 ** 32 == v % 2 ** 32
        assert -2 ** 31 <= ttorus.i32(v) < 2 ** 31
    big = torch.tensor([2 ** 40 + 7, -(2 ** 33) - 1, 2 ** 31], dtype=torch.int64)
    np.testing.assert_array_equal(
        ttorus.to_numpy_u32(ttorus.wrap_i32(big)),
        (big.numpy() % 2 ** 32).astype(np.uint32))
