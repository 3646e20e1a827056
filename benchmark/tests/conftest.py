"""Shared pieces of the benchmark's own tests: the checkout's root on
sys.path, toy cells at the program's test profiles, the step fault, the
card fixture."""

import dataclasses
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, traffic  # noqa: E402

NAND_MIX = {"op": "gate", "gate": "NAND", "batch": 8, "loop": "closed",
            "chain": False, "distinct_batches": 2}
CHAIN_MIX = {"op": "gate", "gate": "NAND", "batch": 1, "loop": "closed",
             "chain": True, "fresh_inputs": 8}
LUT_MIX = {"op": "lut", "table": [(3 * x + 1) % 8 for x in range(8)],
           "batch": 8, "loop": "closed", "chain": False,
           "distinct_batches": 2}
EXT_MIX = dict(LUT_MIX, table=[(3 * x + 1) % 16 for x in range(16)])
MIXES = {"nand": NAND_MIX, "chain": CHAIN_MIX, "lut": LUT_MIX,
         "ext": EXT_MIX}
PROFILE_OF = {"nand": "test_fast", "chain": "test_fast", "lut": "test_pbs",
              "ext": "test_ext2"}
# The plain references, relative to the checkout's root.
TFHE = "benchmark/reference/tfhe.py"
TFHE_EXT = "benchmark/reference/tfhe_ext.py"


def toy_cell(profile: str, mix: dict,
             ops_dir: str = traffic.OPS_DIR) -> harness.Cell:
    """A cell at one of the program's registered test profiles, reporting
    every metric of BENCHMARK.json; judged by ``tfhe_ext.py`` where the
    profile's tables are extended, else by ``tfhe.py``; its op found in
    ``ops_dir``."""
    from go_tfhe_tpu_torch import params
    p = params.get_params(profile)
    config = {"profile": profile,
              "reference": TFHE_EXT if p.poly_extend_factor > 1 else TFHE,
              "params": {f: getattr(p, f) for f in harness.PROFILE_FIELDS}}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return harness.Cell("toy", 1, config,
                        harness.load_reference(config["reference"]),
                        dict(mix), bench["end_to_end"], bench["per_layer"],
                        ops_dir)


def toy_run(kind: str, seed: int = 2 ** 33 + 5, seconds: float = 0.2,
            trace: bool = False, device: str = "cpu",
            profile: str | None = None) -> dict:
    return harness.run(toy_cell(profile or PROFILE_OF[kind], MIXES[kind]),
                       seed, seconds, trace, device, time.time())


def return_state_unchanged(monkeypatch) -> None:
    """The fault "a step that returns its state unchanged", on every
    route: each entry of ``blindrotate.ROUTES``, which ``rotate`` reads,
    gets steps that hand back the accumulator they were given."""
    from go_tfhe_tpu_torch.ops import blindrotate

    def unchanged(p, bands, acc, a_tilda, ops):
        return acc

    for name, route in list(blindrotate.ROUTES.items()):
        monkeypatch.setitem(blindrotate.ROUTES, name,
                            route._replace(steps=unchanged))


@pytest.fixture
def toy_uint(monkeypatch):
    """A small profile with uint5's gadget (bgbit 22, l 1: three digit
    limbs) and key switch, registered with the program for the test."""
    from go_tfhe_tpu_torch import params
    p = dataclasses.replace(
        params.get_params("test_pbs"), name="toy_uint", lwe_n=24, n=256,
        nbit=8, bgbit=22, l=1, basebit=6, iks_t=3, message_modulus=8,
        lwe_alpha=params.UINT5.lwe_alpha, lv1_alpha=params.UINT5.lv1_alpha)
    monkeypatch.setitem(params.PROFILES, "toy_uint", p)
    return p


@pytest.fixture
def toy_uint8():
    """A small extended profile with uint8's k = 9, gadget (bgbit 22, l 1)
    and key switch (basebit 7, t 3)."""
    from go_tfhe_tpu_torch import params
    return dataclasses.replace(params.UINT8, name="toy_uint8", lwe_n=24,
                               n=256, nbit=8, message_modulus=16)


@pytest.fixture
def toy_gate(monkeypatch):
    """128bit with 32 level-0 key bits: the card's kernels at their real
    ring size, a short rotation."""
    from go_tfhe_tpu_torch import params
    p = dataclasses.replace(params.P128, name="toy_gate", lwe_n=32)
    monkeypatch.setitem(params.PROFILES, "toy_gate", p)
    return p


@pytest.fixture
def card():
    """The CUDA card, decided when the test runs; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
