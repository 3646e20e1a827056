"""The port imports without JAX, and its kernel loader fails loudly.

Each case runs in a fresh interpreter with ``sys.modules["jax"] = None``,
so any import of JAX, direct or indirect, raises.
"""

import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

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


def test_kernel_module_imports_without_nvcc():
    res = _run_without_jax("""
        from go_tfhe_tpu_torch.ops import (_build, cuda_ext, cuda_ext_t,
                                           cuda_extprod, cuda_rotate, cuda_t)
        assert cuda_t.launch_counts == {"rotate_decompose_t": 0,
                                        "extprod_t": 0,
                                        "rotate_decompose_ext_t": 0,
                                        "extprod_ext_t": 0,
                                        "rotate_decompose_ext": 0,
                                        "rotate_decompose": 0,
                                        "extprod": 0}
        assert _build._lib is None
        print("ok")
    """, CUDA_HOME="/nonexistent")
    assert res.returncode == 0, res.stderr


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
