"""The control of the comparison at a size a test run holds: the
reference at 24-bit key words in the program's place must read over the
limit 0 of ``mismatched_ciphertexts``; the reference at full precision in
its place reads 0.  On the card the same runs at each cell's own size
(``python3 benchmark/control.py``)."""

import pytest

from benchmark import control
from conftest import MIXES, PROFILE_OF, toy_cell


@pytest.mark.parametrize("kind", ["nand", "chain", "lut", "ext"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9, 4_000_000_007])
def test_the_control_fails_the_comparison(kind, seed):
    cell = toy_cell(PROFILE_OF[kind], MIXES[kind])
    row = control.control_run(cell, seed, 6, 24, "cpu")
    assert row["mismatched_ciphertexts"] > 0
    assert row["mismatched_ciphertexts"] <= row["attempted"]


@pytest.mark.parametrize("kind", ["nand", "chain", "lut", "ext"])
def test_the_reference_in_the_programs_place_passes(kind):
    cell = toy_cell(PROFILE_OF[kind], MIXES[kind])
    assert control.control_run(cell, 5, 6, 32, "cpu")[
        "mismatched_ciphertexts"] == 0
