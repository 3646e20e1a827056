"""The frozen yardstick: the work count against the program's profile
formula with k counted, the statistics over all requests, the union of
device intervals."""

import pytest

from benchmark import yardstick


def _fields(p):
    return {f: getattr(p, f) for f in
            ("lwe_n", "n", "l", "bgbit", "poly_extend_factor",
             "kernel_limb_drop")}


@pytest.mark.parametrize("name", ["128bit", "128bit_fast", "80bit_fast",
                                  "uint5", "uint6_centered", "uint7",
                                  "uint8_centered", "test_fast", "test_pbs"])
def test_work_count_is_the_profile_formula_with_k(name):
    from go_tfhe_tpu_torch import params
    from go_tfhe_tpu_torch.utils import profiling
    p = params.get_params(name)
    prm = _fields(p)
    assert yardstick.digit_limbs(prm) == p.digit_limbs
    assert yardstick.limb_pairs(prm) == profiling.limb_pairs(p)
    cost = profiling.bootstrap_cost(p)
    assert yardstick.rotation_ops(prm, 3) == (
        3 * cost.flops_per_ct * p.poly_extend_factor)


def test_the_cells_bounds():
    from go_tfhe_tpu_torch import params
    p128 = _fields(params.get_params("128bit"))
    u5 = _fields(params.get_params("uint5"))
    assert yardstick.limb_pairs(p128) == 4 and yardstick.limb_pairs(u5) == 9
    # the int8 operations bound both cells, far above their bytes
    assert yardstick.rotation_bound_s(p128, 4096) == pytest.approx(
        2 * 700 * 6 * 1024 * 2 * 4 * 1024 * 4096 / 1979e12)
    assert yardstick.rotation_bytes(u5, 2048) / 3.35e12 < 0.01 * (
        yardstick.rotation_ops(u5, 2048) / 1979e12)


def test_percentiles_are_over_all_requests():
    values = list(range(1, 201))[::-1]
    assert yardstick.percentile(values, 95) == 190
    assert yardstick.percentile(values, 50) == 100
    assert yardstick.percentile([7.0], 95) == 7.0
    assert yardstick.median([3, 1, 2, 10]) == 2.5
    with pytest.raises(ValueError):
        yardstick.percentile([], 50)


def test_idle_share_takes_the_union_of_intervals():
    ops = [("k1", 0.0, 2.0, True), ("k2", 1.0, 3.0, True),
           ("k3", 5.0, 6.0, True), ("Memcpy HtoD", 2.5, 2.8, False)]
    host = [("outer", 0.0, 10.0), ("aten::inner", 3.5, 4.5)]
    r = yardstick.reduce_trace(ops, host, 0.0, 10.0, calls=2)
    assert r["busy_s"] == pytest.approx(4.0)      # [0, 3] and [5, 6]
    assert r["window_s"] == 10.0 and r["kernels"] == 3
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"outer": 4.0, "aten::inner": 2.0})
    assert r["device_ops"][0] == ["k1", 2.0]


def test_short_names():
    assert yardstick.short_name(
        "void (anonymous namespace)::k<1, 0>(int const*, int)") == (
        "void (anonymous namespace)::k<1, 0>")
    assert yardstick.short_name("Memcpy HtoD (Pageable -> Device)") == (
        "Memcpy HtoD")


def test_noise_sigmas():
    assert yardstick.noise_sigmas([2 ** 25, -2 ** 25]) == 16.0
