"""Build and load the Hopper kernels in ``go_tfhe_tpu_torch/csrc/``.

Route: ``nvcc`` compiles the ``.cu`` sources (plain C entry points, no
PyTorch headers) for ``sm_90a``, one ``nvcc`` process per source, all
started together, and links the objects into one shared library, loaded
with ``ctypes``.  The build happens at first use, into
``go_tfhe_tpu_torch/build/`` (listed in ``.gitignore``); the library's name
carries a hash of the sources, headers and flags, so an edited source
rebuilds.

:func:`load_library` raises ``RuntimeError`` when there is no CUDA device
or no ``nvcc``; no caller catches it, so a CUDA tensor never silently takes
a plain path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ..utils import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("rotdec_t.cu", "extprod_t.cu", "rotdec_ext_t.cu",
           "extprod_ext_t.cu", "rotdec_ext.cu", "rotdec.cu", "extprod.cu",
           "step.cu", "pipe.cu", "extprod_t_small.cu", "step_t_small.cu",
           "keyswitch.cu")
HEADERS = ("extprod_tile.cuh", "rotdec_col.cuh", "rotdec_row.cuh",
           "extprod_t_small.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # acc, amounts, out, n, b, l, bgbit, offset, nd, tb, stream
    "tfhe_rotdec_t": (_P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32, _I, _I, _P),
    # digits, band, acc, out, n, b, l2, nd, lo, stream
    "tfhe_extprod_t": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the same for K2's small-batch form; and whether it takes n, b, l2, nd
    "tfhe_extprod_t_small": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tfhe_extprod_t_small_fits": (_I, _I, _I, _I),
    # acc, amounts, band, out, n, b, l, bgbit, offset, stream (K1 in K2's
    # small form); and whether it takes n, b, l, bgbit
    "tfhe_step_t_small": (_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32,
                          _P),
    "tfhe_step_t_small_fits": (_I, _I, _I, _I),
    # acc, amounts, out, scratch, n, k, b, l, bgbit, offset, nd, tb, stream
    "tfhe_rotdec_ext_t": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                          ctypes.c_uint32, _I, _I, _P),
    # digits, band, acc, out, n, k, b, l2, nd, lo, stream
    "tfhe_extprod_ext_t": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # acc, amounts, out, n, k, b, l, bgbit, offset, nd, threads, stream
    "tfhe_rotdec_ext": (_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_uint32, _I,
                        _I, _P),
    # acc, amounts, out, n, b, bs, l, bgbit, offset, nd, rows, threads,
    # stream
    "tfhe_rotdec": (_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_uint32, _I, _I,
                    _I, _P),
    # digits, band, acc, out, n, b', rows, nd, lo, stream
    "tfhe_extprod": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # acc, amounts, band, out, n, b, l, bgbit, offset, lo, stream
    "tfhe_fused_step": (_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32, _I,
                        _P),
    # digits_x, band, acc_x, out_x, acc_y, amt_y, dig_y, n, bx, by, l,
    # bgbit, offset, lo, nx, ny, smem, stream
    "tfhe_pipe_step": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       ctypes.c_uint32, _I, _I, _I, _I, _P),
    # lo, smem, blocks (int*)
    "tfhe_pipe_occupancy": (_I, _I, ctypes.POINTER(_I)),
    # table, ct, out, n, t, basebit, w, b, stream (the key switch); and
    # whether it takes n, t, basebit, w, b
    "tfhe_key_switch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tfhe_key_switch_fits": (_I, _I, _I, _I, _I),
}

_lib = None           # the loaded library: built and loaded once per process


def _nvcc() -> str:
    """The nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME, PATH, or the
    toolkit's default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "go_tfhe_tpu_torch: cannot build the CUDA kernels: no nvcc found "
            "(set CUDA_HOME to a CUDA toolkit with Hopper support)")
    return nvcc


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libtfhe_kernels_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the kernels unless the current sources are already built.

    Returns {"path", "seconds", "log"}: the library, the build's wall
    time (0 when nothing was compiled) and nvcc's output (ptxas register
    and shared-memory report of every kernel)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "go_tfhe_tpu_torch: the CUDA kernels need a CUDA device; "
            "torch.cuda.is_available() is False")
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    objdir = f"{path}.{os.getpid()}.obj"
    os.makedirs(objdir, exist_ok=True)
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(objdir, f"{s}.o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, obj in zip(SOURCES, objs)]
        logs = [f"-- {s}\n{proc.communicate()[0]}"
                for s, proc in zip(SOURCES, procs)]
        log = "".join(logs)
        failed = [s for s, proc in zip(SOURCES, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"go_tfhe_tpu_torch: nvcc failed on "
                               f"{', '.join(failed)}:\n{log}")
        tmp = os.path.join(objdir, os.path.basename(path))
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"go_tfhe_tpu_torch: nvcc link failed "
                               f"(exit {res.returncode}):\n{log}")
        os.replace(tmp, path)      # atomic: concurrent builds agree
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    return {"path": path, "seconds": time.perf_counter() - t0, "log": log}


def load_library() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point's
    argument types declared (pointers and the stream as c_void_p, so
    64-bit addresses are never cut)."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        built = build()
        lib = ctypes.CDLL(built["path"])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        # first-run records (utils/tracing.py): the load, and nvcc's share
        tracing.note_first_run("library.load", time.perf_counter() - t0)
        tracing.note_first_run("library.nvcc", built["seconds"])
    return _lib
