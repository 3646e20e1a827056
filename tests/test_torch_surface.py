"""The port is complete: every public top-level name of the JAX package
(a function, class or assigned name of a module of ``go_tfhe_tpu/`` not
starting with ``_``; imports and re-exports aside) has a counterpart in
the port module that takes its place, under its own name or the name
:data:`RENAMES` gives, or stands in :data:`NOT_PORTED` with its reason.
Both packages are parsed with ``ast``; neither is imported.

The second map does the same for the JAX repo's scripts outside the
package (the ``*.py`` at the repo's root and the scripts under
``tools/``): each has a port script in :data:`SCRIPTS` or a reason in
:data:`NOT_PORTED_SCRIPTS`.
"""

import ast
import fnmatch
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "go_tfhe_tpu")
PORT_DIR = os.path.join(ROOT, "go_tfhe_tpu_torch")

# JAX module -> the port modules that hold its counterparts (by default the
# module of the same path).  Each Pallas kernel module's counterpart is the
# wrapper of its Hopper kernel.
MODULES = {
    "ops/pallas_t.py": ("ops/cuda_t.py", "ops/cuda_ext_t.py"),
    "ops/pallas_ext.py": ("ops/cuda_ext.py",),
    "ops/pallas_extprod.py": ("ops/cuda_extprod.py",),
    "ops/pallas_pipe.py": ("ops/cuda_pipe.py",),
    "ops/pallas_rotate.py": ("ops/cuda_rotate.py",),
    "ops/pallas_step.py": ("ops/cuda_step.py",),
}

# (JAX module, JAX name) -> the port's name.  The port's blind rotations
# keep the names its routes, launch counters and chip_smoke.py read
# (ops/blindrotate.py's docstring has the table of all nine).
RENAMES = {
    ("ops/blindrotate.py", "blind_rotate_block"):
        "blind_rotate_block_portable",
    ("ops/blindrotate.py", "blind_rotate_block_tpu"): "blind_rotate_block",
    ("ops/blindrotate.py", "blind_rotate_extended_tpu"):
        "blind_rotate_extended_rm",
    ("ops/pallas_t.py", "pack_bsk_band_rev"): "pack_bsk_band_t",
    ("ops/pallas_ext.py", "rotate_decompose_ext_pallas"):
        "rotate_decompose_ext",
    ("ops/pallas_extprod.py", "extprod_pallas"): "extprod",
    ("ops/pallas_rotate.py", "rotate_decompose_pallas"): "rotate_decompose",
    ("parallel/mesh.py", "sharded_bootstrap_pallas"):
        "sharded_bootstrap_cuda",
    ("utils/profiling.py", "TPU_PEAKS"): "H100_PEAKS",
}

# (JAX module pattern, name pattern) -> why the port has no counterpart.
NOT_PORTED = {
    ("utils/backend.py", "*"):
        "configures XLA (its backend and its compilation cache); PyTorch "
        "has neither",
    ("utils/torus.py", "f32_to_torus_traced"):
        "converts traced XLA arrays inside jit; the port traces nothing "
        "and converts with f64_to_torus",
    ("ops/pallas_*.py", "INTERPRET"):
        "a TPU knob: Pallas's interpret mode; a CUDA tensor launches the "
        "kernel and a CPU tensor runs its plain version",
    ("ops/pallas_*.py", "NUM_LIMBS"):
        "a TPU knob: the key limbs of the Pallas band layout; the port's "
        "band keeps whole words (cuda_t.pack_bsk_band_t)",
    ("ops/pallas_ext.py", "ext_batch_tile"):
        "a TPU knob: the Pallas batch tile; the kernels' plans choose "
        "their own tiles",
    ("ops/pallas_extprod.py", "pack_bsk_band"):
        "the row-major limb-packed band: the port has one band layout "
        "(cuda_t.pack_bsk_band_t), read by every kernel",
    ("*", "Array"): "the jax.Array type alias; the port annotates "
                    "torch.Tensor",
}


def _public_names(path):
    """Public top-level names defined (not imported) in a module."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    paths = glob.glob(os.path.join(JAX_DIR, "**", "*.py"), recursive=True)
    return sorted(os.path.relpath(p, JAX_DIR).replace(os.sep, "/")
                  for p in paths)


def _not_ported(module, name):
    return next((why for (mod, pat), why in NOT_PORTED.items()
                 if fnmatch.fnmatch(module, mod)
                 and fnmatch.fnmatch(name, pat)), None)


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_a_counterpart(module):
    if _not_ported(module, "*") is not None:       # the whole module
        return
    jax_names = _public_names(os.path.join(JAX_DIR, module))
    wanted = {RENAMES.get((module, n), n) for n in jax_names
              if _not_ported(module, n) is None}
    port_modules = MODULES.get(module, (module,))
    missing_modules = [m for m in port_modules
                       if not os.path.exists(os.path.join(PORT_DIR, m))]
    assert not missing_modules, f"no port module {missing_modules}"
    port_names = set().union(*(_public_names(os.path.join(PORT_DIR, m))
                               for m in port_modules))
    assert not wanted - port_names, (
        f"{module}: no counterpart in {port_modules} for "
        f"{sorted(wanted - port_names)}")


def test_mapping_entries_are_live():
    """Every rename, module map and NOT_PORTED entry names something the
    JAX package defines, and every NOT_PORTED entry gives its reason."""
    modules = _jax_modules()
    defined = {(m, n) for m in modules
               for n in _public_names(os.path.join(JAX_DIR, m))}
    assert set(RENAMES) <= defined
    assert set(MODULES) <= set(modules)
    for (mod, pat), why in NOT_PORTED.items():
        assert why.strip()
        assert any(fnmatch.fnmatch(m, mod) and fnmatch.fnmatch(n, pat)
                   for m, n in defined), (mod, pat)


# ---------------------------------------------------------------------------
# The JAX repo's entry points outside the package: every script at the
# repo's root and under tools/ has a port counterpart or a reason.
# ---------------------------------------------------------------------------

# JAX script -> the port's counterpart (imports torch, numpy and the port).
SCRIPTS = {
    "bench.py": "bench_torch.py",
    "bench_micro.py": "bench_micro_torch.py",
    "bench_scaling.py": "bench_scaling_torch.py",
    "tools/bench_profiles.py": "tools/torch_bench_profiles.py",
    "tools/bench_ext.py": "tools/torch_bench_ext.py",
    "tools/noise_margin.py": "tools/torch_noise_margin.py",
    "tools/noise_margin_pbs.py": "tools/torch_noise_margin_pbs.py",
    "tools/noise_many.py": "tools/torch_noise_many.py",
}

# The port's scripts that are no JAX script's counterpart.
PORT_ONLY_SCRIPTS = ("chip_smoke.py", "rotdec_times.py")

# JAX script pattern -> why the port has no counterpart.
NOT_PORTED_SCRIPTS = {
    "tools/split_timing.py":
        "times the TPU step's kernels in jitted 700-step loops; "
        "rotdec_times.py and chip_smoke.py's phase 3 time the port's",
    "tools/security_estimate.py":
        "imports nothing of either package and runs as it is",
    "__graft_entry__.py":
        "the JAX package's compile check; chip_smoke.py is the port's",
    "tools/collect_artifacts.sh":
        "collects the JAX scripts' artifacts on the TPU host; "
        "chip_smoke.py's phase 21 runs the port's entry points",
    "tools/warm_cache.py":
        "fills XLA's persistent compilation cache; PyTorch has none",
    "tools/probe_*.py": "a TPU probe of a Pallas kernel's layout",
    "tools/sweep_*.py": "a sweep of a Pallas kernel's TPU tiles",
    "tools/proto_t_step.py":
        "the TPU prototype of the transposed step, now ops/pallas_t.py "
        "(ported as csrc/rotdec_t.cu and csrc/extprod_t.cu)",
    "tools/_exp_gadget*.py":
        "a noise experiment on the JAX package that chose the "
        "128bit_fast gadget; tests/test_torch_noise_margin.py and "
        "tools/torch_noise_margin.py measure the port's margins",
}


def _jax_scripts():
    port = set(SCRIPTS.values()) | set(PORT_ONLY_SCRIPTS)
    paths = glob.glob(os.path.join(ROOT, "*.py"))
    paths += glob.glob(os.path.join(ROOT, "tools", "*.py"))
    paths += glob.glob(os.path.join(ROOT, "tools", "*.sh"))
    rel = (os.path.relpath(p, ROOT).replace(os.sep, "/") for p in paths)
    return sorted(p for p in rel if p not in port)


@pytest.mark.parametrize("script", _jax_scripts())
def test_every_jax_script_has_a_counterpart(script):
    if script in SCRIPTS:
        assert os.path.exists(os.path.join(ROOT, SCRIPTS[script])), (
            f"{script}: no port script {SCRIPTS[script]}")
        return
    assert any(fnmatch.fnmatch(script, pat) for pat in NOT_PORTED_SCRIPTS), (
        f"{script}: neither a port counterpart in SCRIPTS nor a reason in "
        "NOT_PORTED_SCRIPTS")


def test_script_map_entries_are_live():
    """Every script map entry names a file of the repo, every reason is
    given, and no JAX script is both ported and not ported."""
    scripts = _jax_scripts()
    for jax_script, port_script in SCRIPTS.items():
        assert os.path.exists(os.path.join(ROOT, jax_script)), jax_script
        assert os.path.exists(os.path.join(ROOT, port_script)), port_script
    for name in PORT_ONLY_SCRIPTS:
        assert os.path.exists(os.path.join(ROOT, name)), name
    for pat, why in NOT_PORTED_SCRIPTS.items():
        assert why.strip()
        hits = [s for s in scripts if fnmatch.fnmatch(s, pat)]
        assert hits, pat
        assert not set(hits) & set(SCRIPTS), pat
