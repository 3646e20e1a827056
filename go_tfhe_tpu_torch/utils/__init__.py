"""Torus conversions, RNG, and profiling helpers: the names that
``go_tfhe_tpu.utils`` exports, except ``f32_to_torus_traced`` (a helper
for JAX tracing, which the port has no use for)."""

from .torus import (MOD32, TORUS, f64_to_torus, f64_to_torus_vec, to_signed,
                    to_unsigned, torus_not, torus_to_f64)
from .rng import binary_key, gaussian_torus, uniform_torus
from .profiling import (bootstrap_cost, key_memory_usage,
                        speed_of_light_report, trace)
