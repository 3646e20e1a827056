"""Measured-negative research artifacts, ported for completeness
(port of ``go_tfhe_tpu/experimental``).

No path of the port runs anything here; each module's docstring says what
retired it in the JAX package and when it would be worth revisiting.
"""
