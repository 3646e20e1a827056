"""Compute kernels: exact negacyclic arithmetic, decomposition, rotation,
the external product and CMUX, the blind-rotation step kernels
(``cuda_t``, ``cuda_ext_t``, ``cuda_ext``, ``cuda_rotate``,
``cuda_extprod``), blind rotation (the kernel rotations and the portable
ones), key switching and sample extraction (to level 1, or to level 0
where N == lwe_n)."""

from .blindrotate import (blind_rotate, blind_rotate_block,
                          blind_rotate_extended_rm, blind_rotate_extended_t,
                          blind_rotate_t, mod_switch_2n)
from .cuda_t import (extprod_t, extprod_t_ref, launch_counts,
                     pack_bsk_band_t, reset_launch_counts, rotate_decompose_t,
                     rotate_decompose_t_ref)
from .decompose import gadget_decompose
from .extprod import cmux, external_product
from .keyswitch import identity_key_switch, ks_digits
from .polymul import (conv_kernel_from_poly, ext_band_from_trgsw,
                      extprod_kernel_from_trgsw, negacyclic_extprod_i8,
                      negacyclic_extprod_i32, negacyclic_extprod_toeplitz,
                      negacyclic_mul_binary, negacyclic_mul_fixed,
                      split_balanced_limbs_i8, split_signed_limbs_i8,
                      toeplitz_from_band)
from .rotate import monomial_mul, monomial_mul_log
from .sample_extract import sample_extract, sample_extract_to_lv0
