"""Production-scale noise-margin tests of the port's fast-path knobs (the
counterpart of tests/test_noise_margin.py, with its asserts).

The knobs are the bgbit=8/l=2 gadget of the ``*_fast`` profiles and the
dropped lowest key limb of their bands (``kernel_limb_drop=1``); each must
keep the output-phase deviation of a NAND batch far inside the 2^29
boolean decision margin.  The production cases run the kernels at full
parameters, so they are marked ``gpu`` (and ``production``, as the JAX
file's) and skip without a card; on the card (no JAX there):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_noise_margin.py

The host case runs the same measurement at ``test_fast`` through the
kernels' plain versions.  No case imports JAX.
"""

from __future__ import annotations

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from go_tfhe_tpu_torch import params  # noqa: E402
from go_tfhe_tpu_torch.utils.benchmarking import load_script  # noqa: E402

MARGIN = 2 ** 29


def _measure(p, device, batch=512):
    """The phase deviations of a NAND batch's outputs from the ideal
    +-1/8, and its wrong answers (tools/torch_noise_margin.py's
    measurement, at its seed)."""
    rec, dev = load_script("tools/torch_noise_margin.py").measure_profile(
        p, batch, torch.device(device))
    return dev, rec["wrong_answers"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: production parameters run the "
                    "Hopper kernels")
    return torch.device("cuda", 0)


def _assert_headline_margins(dev, wrong):
    """Predicted phase std ~2^24.5 at 128bit_fast; the asserts leave ~1.5
    bits of slack.  >= 8 sigma means an error per gate below 1e-15."""
    assert wrong == 0
    std = dev.std()
    assert std < 2 ** 26, f"phase std 2^{math.log2(std):.2f}"
    assert abs(dev).max() < 2 ** 28
    assert MARGIN / std > 8.0


@pytest.mark.gpu
@pytest.mark.production
def test_margin_128bit_fast(cuda_device):
    """The headline profile: bgbit=8/l=2 gadget + kernel_limb_drop=1."""
    _assert_headline_margins(*_measure(params.P128_FAST, cuda_device))


@pytest.mark.gpu
@pytest.mark.production
def test_margin_128bit_fast_exact_kernel(cuda_device):
    """Isolate the gadget contribution: bgbit=8/l=2 WITHOUT limb drop (the
    bands keep all 4 key limbs, K2 at lo 0)."""
    p = dataclasses.replace(params.P128_FAST, name="128bit_fast_drop0",
                            kernel_limb_drop=0)
    dev, wrong = _measure(p, cuda_device)
    assert wrong == 0
    assert dev.std() < 2 ** 26


@pytest.mark.gpu
@pytest.mark.production
def test_margin_128bit_reference_gadget(cuda_device):
    """The reference's gadget (bgbit=6/l=3, no knobs) as a control: its
    floor decomposition carries a bias-times-ring-key walk of ~2^25.4 at
    its 2^14 tail grid, ~11 sigma inside the margin."""
    dev, wrong = _measure(params.P128, cuda_device)
    assert wrong == 0
    assert dev.std() < 2 ** 26.2


def test_margin_test_fast_on_the_host():
    """The headline case's asserts at test_fast on the host, through the
    kernels' plain versions."""
    _assert_headline_margins(*_measure(params.TEST_FAST, "cpu", batch=64))
