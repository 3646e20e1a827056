"""No run loads JAX or the JAX package (compared by whole top-level
names); a run without a card exits non-zero and prints no result."""

import json
import os
import subprocess
import sys

from benchmark import harness
from conftest import ROOT


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["go_tfhe_tpu_torch", "go_tfhe_tpu_torch.ops", "jax_like",
         "flaxen", "torch"]) == []
    assert harness.forbidden_modules(
        ["go_tfhe_tpu.engine", "jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "go_tfhe_tpu", "jax", "jaxlib"]


def test_a_whole_run_loads_nothing_forbidden():
    code = (
        "import sys; sys.path.insert(0, %r); "
        "sys.path.insert(0, %r); import conftest; "
        "r = conftest.toy_run('nand'); "
        "from benchmark import harness; "
        "print(r['correct'], harness.forbidden_modules(sys.modules))"
        % (ROOT, os.path.join(ROOT, "benchmark", "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    assert out[-1] == "True []"


def test_no_card_exits_non_zero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gate-128bit.nand-b4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")
