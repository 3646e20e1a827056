"""The five example programs of the port (examples/torch_*.py) at their
defaults on the CPU: each decrypts and checks every output and its
``main`` returns 0; asked for the card on a torch without CUDA, each
raises rather than running on the host."""

import contextlib
import importlib.util
import io
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["torch_simple_gates", "torch_programmable_bootstrap",
            "torch_add_two_numbers", "torch_manylut_adder",
            "torch_proxy_reencryption"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_host(name):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = _load(name).main(["--device", "cpu"])
    assert rc == 0, log.getvalue()
    assert log.getvalue().splitlines()[-1] == "all results correct"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises((AssertionError, RuntimeError)):
            _load(name).main([])
