"""On the card: a short run of each mix kind through the program's
kernels is correct, traced and untraced (skips without a card).  The
profiles keep the cells' ring sizes and gadgets with few level-0 bits."""

import pytest

from conftest import toy_run


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["nand", "chain", "lut"])
def test_a_short_run_on_the_card(kind, card, toy_gate, toy_uint):
    profile = "toy_uint" if kind == "lut" else "toy_gate"
    for trace in (False, True):
        r = toy_run(kind, seconds=0.5, trace=trace, device=card,
                    profile=profile)
        assert r["correct"] and r["device"]["platform"] == "gpu"
        if trace:
            assert r["device"]["busy_s"] > 0
