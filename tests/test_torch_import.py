"""The port imports without JAX, its kernel loader fails loudly, and no
entry point puts keys or tables on the CPU unless asked to.

The import cases run in a fresh interpreter with ``sys.modules["jax"] =
None``, so any import of JAX, direct or indirect, raises.
"""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_without_jax(code: str, **env) -> subprocess.CompletedProcess:
    prog = "import sys\nsys.modules['jax'] = None\n" + textwrap.dedent(code)
    return subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, **env})


def test_package_imports_without_jax():
    res = _run_without_jax("""
        import go_tfhe_tpu_torch as t
        assert t.P128_FAST.name == "128bit_fast"
        assert not any(m == "jax" or m.startswith(("jax.", "go_tfhe_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# The port's measuring entry points: the counterparts of the JAX repo's
# bench.py, bench_micro.py, bench_scaling.py, its tools and
# tests/test_noise_margin.py, and the program-trace tool.
ENTRY_SCRIPTS = ["bench_torch.py", "bench_micro_torch.py",
                 "bench_scaling_torch.py", "tools/torch_bench_profiles.py",
                 "tools/torch_bench_ext.py", "tools/torch_noise_margin.py",
                 "tools/torch_noise_margin_pbs.py",
                 "tools/torch_noise_many.py",
                 "tests/test_torch_noise_margin.py",
                 "tools/torch_program_trace.py",
                 "tools/torch_k2_crossover.py"]


def test_mesh_utils_and_examples_import_without_jax():
    """parallel/, experimental/, every module of utils/, the five
    examples/torch_*.py programs and the measuring entry points
    (:data:`ENTRY_SCRIPTS`) import with JAX blocked, print nothing at
    import, and load nothing of JAX or of the JAX package."""
    res = _run_without_jax("""
        import glob, importlib.util
        import go_tfhe_tpu_torch.experimental.nussbaumer
        import go_tfhe_tpu_torch.parallel.mesh
        from go_tfhe_tpu_torch.utils import (benchmarking, metrics,
                                             profiling, rng, torus,
                                             tracing)
        paths = sorted(glob.glob("examples/torch_*.py"))
        assert len(paths) == 5, paths
        for path in paths + %r:
            spec = importlib.util.spec_from_file_location("ex", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert not any(m == "jax" or m.startswith(("jax.", "go_tfhe_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """ % (ENTRY_SCRIPTS,))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _port_sources():
    import glob
    files = glob.glob(os.path.join(ROOT, "go_tfhe_tpu_torch", "**", "*.py"),
                      recursive=True)
    files += glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))
    return (sorted(os.path.relpath(f, ROOT) for f in files)
            + ["chip_smoke.py"] + ENTRY_SCRIPTS)


@pytest.mark.parametrize("path", _port_sources())
def test_no_jax_import_in_source(path):
    """No line of the port, its examples, chip_smoke.py or the measuring
    entry points imports JAX or the JAX package (as opposed to
    go_tfhe_tpu_torch)."""
    import re
    pattern = re.compile(r"^\s*(import|from)\s+(jax|go_tfhe_tpu)\b")
    with open(os.path.join(ROOT, path)) as f:
        bad = [line for line in f if pattern.match(line)]
    assert not bad, bad


def test_kernel_module_imports_without_nvcc():
    res = _run_without_jax("""
        from go_tfhe_tpu_torch.ops import (_build, cuda_ext, cuda_ext_t,
                                           cuda_extprod, cuda_pipe,
                                           cuda_rotate, cuda_step, cuda_t)
        assert cuda_t.launch_counts == {"rotate_decompose_t": 0,
                                        "extprod_t": 0,
                                        "rotate_decompose_ext_t": 0,
                                        "extprod_ext_t": 0,
                                        "rotate_decompose_ext": 0,
                                        "rotate_decompose": 0,
                                        "extprod": 0,
                                        "fused_rotate_step": 0,
                                        "pipe_step": 0,
                                        "extprod_t_small": 0}
        assert _build._lib is None
        assert not any(m == "jax" or m.startswith(("jax.", "go_tfhe_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """, CUDA_HOME="/nonexistent")
    assert res.returncode == 0, res.stderr


def _c_entry_points():
    """{name: [C parameter declarations]} of every extern "C" function in
    the kernel sources."""
    from go_tfhe_tpu_torch.ops import _build
    found = {}
    for name in _build.SOURCES:
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            text = f.read()
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     text):
            found[fn] = [" ".join(p.split()) for p in params.split(",")]
    return found


def test_ctypes_signatures_match_the_sources():
    """Each extern "C" entry point of csrc/*.cu has a ctypes signature in
    _build._SIGNATURES with as many arguments, each of the C type's kind
    (a pointer, int, or unsigned int): a missing argument would shift the
    stream pointer into the wrong slot."""
    import ctypes
    from go_tfhe_tpu_torch.ops import _build
    entries = _c_entry_points()
    assert entries.keys() == _build._SIGNATURES.keys()
    for fn, params in entries.items():
        want = [ctypes.POINTER(ctypes.c_int) if p.startswith("int*")
                else ctypes.c_void_p if "*" in p
                else ctypes.c_uint32 if p.startswith("unsigned int")
                else ctypes.c_int for p in params]
        assert list(_build._SIGNATURES[fn]) == want, (fn, params)


def test_loader_raises_without_cuda():
    res = _run_without_jax("""
        import torch
        if torch.cuda.is_available():
            print("skip")
            sys.exit(0)
        from go_tfhe_tpu_torch.ops import _build
        try:
            _build.load_library()
        except RuntimeError as e:
            assert "CUDA device" in str(e), e
            print("raised")
    """)
    assert res.returncode == 0, res.stderr
    if res.stdout.strip() == "skip":
        pytest.skip("a CUDA device is present")
    assert res.stdout.strip() == "raised"


def test_loader_raises_without_nvcc():
    """With a device but no toolkit the build refuses, naming nvcc."""
    res = _run_without_jax("""
        import torch
        torch.cuda.is_available = lambda: True
        from go_tfhe_tpu_torch.ops import _build
        _build.BUILD_DIR = "/nonexistent/build"
        try:
            _build.load_library()
        except RuntimeError as e:
            assert "no nvcc" in str(e), e
            print("raised")
    """, CUDA_HOME="/nonexistent", PATH="/usr/bin:/bin")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"


# ---------------------------------------------------------------------------
# No entry point defaults to the CPU.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def key_files(tmp_path_factory):
    """The port's own TEST_FAST keys, a public key and a re-encryption key,
    made on the CPU and saved."""
    from go_tfhe_tpu_torch import keys, params, proxyreenc
    from go_tfhe_tpu_torch.utils.torus import to_numpy_u32
    p = params.TEST_FAST
    gen = torch.Generator().manual_seed(1)
    sk = keys.gen_secret_key(gen, p, "cpu")
    ck = keys.gen_cloud_key(gen, sk, p)
    pk = proxyreenc.gen_public_key(gen, sk.lv0, p)
    rk = proxyreenc.gen_reencryption_key_symmetric(gen, sk.lv0, sk.lv0, p)
    d = tmp_path_factory.mktemp("keys")
    keys.save_cloud_key(str(d / "ck.npz"), ck)
    keys.save_secret_key(str(d / "sk.npz"), sk)
    proxyreenc.save_public_key(str(d / "pk.npz"), pk)
    proxyreenc.save_reencryption_key(str(d / "rk.npz"), rk)
    arrays = {f: to_numpy_u32(getattr(ck, f)) for f in ("testvec", "ksk",
                                                        "bsk")}
    arrays["pk"], arrays["rk"] = (to_numpy_u32(pk.encryptions),
                                  to_numpy_u32(rk.table))
    return (p, ck, sk, str(d / "ck.npz"), str(d / "sk.npz"), arrays,
            pk, rk, str(d))


def _entry_points(key_files):
    """Each entry point that makes tensors, called with the given keyword
    arguments; the tensor it returns.  encrypt_bits and gen_public_key
    follow their key, so they take a secret key loaded with ``device``."""
    from go_tfhe_tpu_torch import bitutils, gates, keys, lut, proxyreenc
    p, _, _, ck_path, sk_path, arrays, pk, rk, d = key_files
    gen = torch.Generator().manual_seed(2)
    lv0 = lambda **kw: keys.load_secret_key(sk_path, **kw).lv0  # noqa: E731
    return {
        "load_cloud_key": lambda **kw: keys.load_cloud_key(ck_path, **kw).bsk,
        "load_secret_key": lv0,
        "cloud_key_from_numpy": lambda **kw: keys.cloud_key_from_numpy(
            p, arrays["testvec"], arrays["ksk"], arrays["bsk"], **kw).bands,
        "gen_lut": lambda **kw: lut.Generator(p, **kw).gen_lut(
            lambda x: 1 - x),
        "constant": lambda **kw: gates.constant(p, True, (3,), **kw),
        "gen_cloud_key_no_ksk": lambda **kw: keys.gen_cloud_key_no_ksk(
            p, **kw).bands,
        "encrypt_bits": lambda **kw: bitutils.encrypt_bits(
            gen, [True, False], p.lwe_alpha, lv0(**kw)),
        "gen_public_key": lambda **kw: proxyreenc.gen_public_key(
            gen, lv0(**kw), p).encryptions,
        "load_public_key": lambda **kw: proxyreenc.load_public_key(
            f"{d}/pk.npz", **kw).encryptions,
        "load_reencryption_key": lambda **kw: proxyreenc.load_reencryption_key(
            f"{d}/rk.npz", **kw).table,
        "public_key_from_numpy": lambda **kw: proxyreenc.public_key_from_numpy(
            arrays["pk"], **kw).encryptions,
        "reencryption_key_from_numpy": lambda **kw: (
            proxyreenc.reencryption_key_from_numpy(
                arrays["rk"], rk.basebit, rk.t, **kw).table),
    }


ENTRY_POINTS = ["load_cloud_key", "load_secret_key", "cloud_key_from_numpy",
                "gen_lut", "constant", "gen_cloud_key_no_ksk",
                "encrypt_bits", "gen_public_key", "load_public_key",
                "load_reencryption_key", "public_key_from_numpy",
                "reencryption_key_from_numpy"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(key_files, name):
    """Without ``device`` the tensors go to the card: on a torch without a
    CUDA device the call raises (as ``.to("cuda")`` does) and returns no
    host tensor."""
    call = _entry_points(key_files)[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_on_the_host_when_asked(key_files, name):
    """With ``device="cpu"`` the calls give the host tensors they gave
    before: the saved keys' words, and the table on the CPU."""
    p, ck, sk, _, _, _, pk, rk, _ = key_files
    got = _entry_points(key_files)[name](device="cpu")
    assert got.device.type == "cpu"
    want = {"load_cloud_key": ck.bsk, "load_secret_key": sk.lv0,
            "cloud_key_from_numpy": ck.bands,
            "load_public_key": pk.encryptions,
            "public_key_from_numpy": pk.encryptions,
            "load_reencryption_key": rk.table,
            "reencryption_key_from_numpy": rk.table}.get(name)
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    elif name == "gen_lut":
        assert got.shape == (2, p.n)
