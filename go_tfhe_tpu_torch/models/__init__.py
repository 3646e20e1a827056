"""Homomorphic circuits, the JAX package's "model zoo" (port of
``go_tfhe_tpu/models/``): adders (``adders``) and comparators
(``comparators``) as batched library functions.  The reference ships
these as example programs (examples/*/main.go)."""

from .adders import (add8_pbs, full_adder, half_adder, make_adder_luts,
                     ripple_carry_add)
