"""The port's cost model and metrics (go_tfhe_tpu_torch/utils/profiling.py,
utils/metrics.py), the ``utils`` re-exports and
``ops.sample_extract_to_lv0``, against the JAX package's counterparts.

``bootstrap_cost``'s work fields equal the JAX function's for every
profile; the stated deviations (``dot_dtype`` "int8" everywhere, the port's
own band bytes, H100 peaks) are pinned here, and so is the undercount of
extended profiles that both keep.  ``chip_smoke.kernel_bound``, which
reads the cost model's limb pairs and peaks, recomputes the bound of every
row of PERF.md's kernel table (its figures, 4 decimals).
"""

import dataclasses
import glob
import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import go_tfhe_tpu.utils as jutils  # noqa: E402
from go_tfhe_tpu.ops import sample_extract_to_lv0 as jax_to_lv0  # noqa: E402
from go_tfhe_tpu.params import PROFILES as JPROFILES  # noqa: E402
from go_tfhe_tpu.utils import profiling as jprof  # noqa: E402
from go_tfhe_tpu_torch import cipher, keys, params, utils  # noqa: E402
from go_tfhe_tpu_torch.ops import sample_extract_to_lv0  # noqa: E402
from go_tfhe_tpu_torch.ops.sample_extract import sample_extract  # noqa: E402
from go_tfhe_tpu_torch.utils import profiling  # noqa: E402
from go_tfhe_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402
from go_tfhe_tpu_torch.utils.torus import from_numpy_u32, to_numpy_u32  # noqa: E402


@pytest.mark.parametrize("name", sorted(params.PROFILES))
def test_bootstrap_cost_matches_jax(name):
    """steps, macs_per_ct, flops_per_ct and ksk_bytes word for word; the
    port's dot is int8 at every profile and its band is its own."""
    p = params.PROFILES[name]
    want = jprof.bootstrap_cost(JPROFILES[name], batch=4096)
    got = profiling.bootstrap_cost(p, batch=4096)
    for field in ("batch", "steps", "macs_per_ct", "flops_per_ct",
                  "ksk_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.dot_dtype == "int8"
    assert got.bsk_bytes == p.lwe_n * 2 * (2 * p.l) * (2 * p.n) * 4
    assert got.seconds_at(1979.0) == pytest.approx(want.seconds_at(1979.0))


def test_stated_deviations():
    """JAX says bf16 at 3 digit limbs, where the port runs s8 limb pairs;
    the JAX band has 2N + 256 columns, the port's 2N; neither counts the
    k blocks of an extended profile (uint6_centered, k 2, counts as uint5,
    k 1)."""
    u5 = params.UINT5
    assert u5.digit_limbs == 3
    assert jprof.bootstrap_cost(JPROFILES["uint5"]).dot_dtype == "bf16"
    assert profiling.bootstrap_cost(u5).dot_dtype == "int8"
    fast = params.P128_FAST
    assert (jprof.bootstrap_cost(JPROFILES[fast.name]).bsk_bytes
            - profiling.bootstrap_cost(fast).bsk_bytes
            == fast.lwe_n * 2 * 2 * fast.l * 256 * 4)
    u6 = params.UINT6_CENTERED
    assert u6.poly_extend_factor == 2
    for cost in (profiling.bootstrap_cost, jprof.bootstrap_cost):
        assert cost(u6).macs_per_ct == cost(u5).macs_per_ct
    assert profiling.limb_pairs(fast) == 3 and profiling.limb_pairs(u5) == 9
    assert "h100" in profiling.H100_PEAKS and len(profiling.H100_PEAKS) == 1


def test_key_memory_matches_cost_and_tensors():
    """key_memory_usage of a real TEST_FAST key reports its tensors' bytes
    and their total; bootstrap_cost's bsk_bytes and ksk_bytes are its
    bands' and KSK's."""
    p = params.TEST_FAST
    gen = torch.Generator().manual_seed(8)
    ck = keys.gen_cloud_key(gen, keys.gen_secret_key(gen, p, "cpu"), p)
    mem = profiling.key_memory_usage(ck)
    assert set(mem) == {"testvec", "ksk", "bsk", "bands", "total"}
    for name in ("testvec", "ksk", "bsk", "bands"):
        t = getattr(ck, name)
        assert mem[name] == t.numel() * t.element_size()
    assert mem["total"] == sum(v for k, v in mem.items() if k != "total")
    cost = profiling.bootstrap_cost(p)
    assert (cost.bsk_bytes, cost.ksk_bytes) == (mem["bands"], mem["ksk"])


def test_report_and_utilization():
    """The report renders; bootstrap_utilization has JAX's keys and reads
    the measured rate against the int8 peak of the H100."""
    p = params.P128_FAST
    rep = profiling.speed_of_light_report(p, 2000.0)
    assert "speed of light" in rep and "2000" in rep and "(h100)" in rep
    util = profiling.bootstrap_utilization(p, 7726.3)
    assert set(util) == set(jprof.bootstrap_utilization(
        JPROFILES[p.name], 7726.3, "v5e"))
    sol = profiling.bootstrap_cost(p).bootstraps_per_sec_at(1979.0)
    assert util["dot_dtype"] == "int8"
    assert util["sol_bootstraps_per_sec"] == round(sol, 0)
    assert util["mfu"] == round(7726.3 / sol, 4)
    assert 0 < util["mfu"] <= 1


# PERF.md §6's kernel table: (kernel, profile, batch, rows) and the
# bound written there, in ms to 4 decimals, with what bounds it.
BOUND_ROWS = [
    ("rotate_decompose_t", "128bit_fast", 4096, 0, 0.0150, "bytes"),
    ("rotate_decompose_t", "128bit", 4096, 0, 0.0175, "bytes"),
    ("rotate_decompose_t", "uint4", 2048, 0, 0.0175, "bytes"),
    ("rotate_decompose_t", "uint5", 2048, 0, 0.0175, "bytes"),
    ("extprod_t", "128bit_fast", 4096, 0, 0.1042, "operations"),
    ("extprod_t", "uint5", 2048, 0, 0.3125, "operations"),
    ("fused_rotate_step", "128bit_fast", 4096, 0, 0.1042, "operations"),
    ("rotate_decompose_ext_t", "uint6_centered", 2048, 0, 0.0351, "bytes"),
    ("rotate_decompose_ext_t", "uint7_centered", 256, 0, 0.0088, "bytes"),
    ("extprod_ext_t", "uint6_centered", 2048, 0, 0.625, "operations"),
    ("rotate_decompose_ext", "uint8_centered", 256, 0, 0.0197, "bytes"),
    ("rotate_decompose", "128bit_fast", 4096, 12, 0.0251, "bytes"),
    ("rotate_decompose", "128bit_fast", 4096, 4, 0.0150, "bytes"),
    ("extprod", "128bit_fast", 4096, 12, 0.3125, "operations"),
    ("extprod", "128bit_fast", 4096, 4, 0.1042, "operations"),
    ("extprod", "uint8_centered", 256, 0, 0.3516, "operations"),
    ("pipe_step", "128bit_fast", 2048, 0, 0.0521, "operations"),
    ("pipe_step", "128bit", 2048, 0, 0.1042, "operations"),
    ("rotate_decompose_t", "128bit_fast", 2048, 0, 0.0075, "bytes"),
    ("extprod_t_small", "128bit", 1, 0, 0.0008, "operations"),
    ("extprod_t_small", "uint5", 1, 0, 0.0010, "operations"),
]


@pytest.fixture(scope="module")
def chip_smoke():
    """The root chip_smoke.py as a module (its main() is not run)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row", BOUND_ROWS,
                         ids=[f"{r[0]}-{r[1]}-{r[2]}-{r[3]}"
                              for r in BOUND_ROWS])
def test_kernel_bound_of_perf_table(chip_smoke, row):
    """chip_smoke.py's bounds read profiling.limb_pairs and H100_PEAKS,
    the cost model's limb pairs and peaks."""
    name, profile, b, rows, written, by = row
    ms, bound_by = chip_smoke.kernel_bound(name, params.get_params(profile),
                                           b, rows)
    assert bound_by == by
    assert round(ms, 4) == written


def test_uint5_guard_bound_from_the_draws(chip_smoke):
    """Phase 14's bound on add8_pbs's wrong sums is the smallest W with
    P(Binomial(U5_BATCH, p) > W) < 1e-6, p the one-sided upper 95%
    (Clopper-Pearson) limit of the rate over the card's 16 draws."""
    stats = pytest.importorskip("scipy.stats")
    draws = chip_smoke.U5_DRAW_WRONG
    k, n = sum(draws), len(draws) * chip_smoke.U5_BATCH
    p = stats.beta.ppf(0.95, k + 1, n - k)
    bound = next(w for w in range(chip_smoke.U5_BATCH)
                 if stats.binom.sf(w, chip_smoke.U5_BATCH, p) < 1e-6)
    assert (len(draws), k) == (16, 29)
    assert bound == chip_smoke.U5_MAX_WRONG


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() on the CPU writes one Chrome trace into log_dir, naming
    the ops run inside the scope."""
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.arange(64).reshape(8, 8).sum()
    files = glob.glob(str(tmp_path / "t" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_metrics_logger(tmp_path):
    """As tests/test_profiling.py holds the JAX class: JSON lines to a
    stream and an optional file, records retrievable for summaries."""
    path = str(tmp_path / "m.jsonl")
    s = io.StringIO()
    m = MetricsLogger(path=path, stream=s)
    m.emit("throughput", 7726.3, unit="bootstraps/s", profile="128bit_fast")
    m.emit_seconds("latency", 0.5, unit_count=4096)
    m.close()
    with open(path) as f:
        recs = [json.loads(ln) for ln in f.read().strip().splitlines()]
    assert recs == m.summary()
    assert recs[0] == {"metric": "throughput", "value": 7726.3,
                       "unit": "bootstraps/s", "profile": "128bit_fast"}
    assert recs[1]["value"] == round(0.5 * 1e3 / 4096, 3)
    assert s.getvalue().count("\n") == 2
    m.close()                       # a second close is a no-op


def _exports(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


def test_utils_reexports():
    """go_tfhe_tpu_torch.utils exports the names go_tfhe_tpu.utils
    exports, except the JAX tracing helper f32_to_torus_traced; the
    conversions give the same words."""
    assert _exports(utils) == _exports(jutils) - {"f32_to_torus_traced"}
    d = np.asarray([0.125, -0.25, 0.7, -0.999])
    np.testing.assert_array_equal(utils.f64_to_torus_vec(d),
                                  np.asarray(jutils.f64_to_torus_vec(d)))
    np.testing.assert_array_equal(utils.torus_to_f64(d.astype(np.uint32)),
                                  np.asarray(jutils.torus_to_f64(
                                      d.astype(np.uint32))))
    w = np.asarray([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    np.testing.assert_array_equal(
        to_numpy_u32(utils.torus_not(from_numpy_u32(w, "cpu"))),
        np.asarray(jutils.torus_not(jnp.asarray(w))))
    assert (utils.MOD32, utils.TORUS) == (jutils.MOD32, torch.int32)


@pytest.mark.parametrize("k", [0, 5])
def test_sample_extract_to_lv0_matches_jax(k):
    """Word for word with the JAX function on random (3, 2, N) words, and
    equal to level-1 extraction."""
    n = 64
    rng = np.random.default_rng(k)
    trlwe = rng.integers(0, 2 ** 32, (3, 2, n), dtype=np.uint64
                         ).astype(np.uint32)
    want = np.asarray(jax_to_lv0(jnp.asarray(trlwe), n, k))
    got = sample_extract_to_lv0(from_numpy_u32(trlwe, "cpu"), n, k)
    np.testing.assert_array_equal(to_numpy_u32(got), want)
    np.testing.assert_array_equal(
        got.numpy(), sample_extract(from_numpy_u32(trlwe, "cpu"), k).numpy())


def test_sample_extract_to_lv0_decrypts_and_refuses():
    """As tests/test_cipher.py:89-103 holds the JAX function: where
    N == lwe_n the coefficient-0 message decrypts under the ring key read
    as a level-0 key; a dimension mismatch raises ValueError in both."""
    p = dataclasses.replace(params.TEST_FAST, name="t_lv0", lwe_n=128)
    gen = torch.Generator().manual_seed(9)
    sk = keys.gen_secret_key(gen, p, "cpu")
    bits = torch.randint(0, 2, (p.n,), generator=gen).bool()
    ct = cipher.trlwe_encrypt_bool(gen, bits, p.lv1_alpha, sk.lv1)
    out = sample_extract_to_lv0(ct, p.lwe_n)
    assert bool(cipher.lwe_decrypt_bool(out, sk.lv1)) == bool(bits[0])
    with pytest.raises(ValueError, match="use sample_extract"):
        sample_extract_to_lv0(ct, params.TEST_FAST.lwe_n)
    with pytest.raises(ValueError, match="use sample_extract"):
        jax_to_lv0(jnp.zeros((2, p.n), jnp.uint32), params.TEST_FAST.lwe_n)
    assert jax.devices()[0].platform == "cpu"
