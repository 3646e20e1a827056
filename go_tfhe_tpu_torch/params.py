"""TFHE parameter profiles (port of ``go_tfhe_tpu/params.py``).

The profile table is copied, not imported: importing ``go_tfhe_tpu``
imports JAX, and the port runs where JAX is absent.
``tests/test_torch_params_torus.py`` pins every profile here to the JAX
package's, field by field and with every derived property.  The rationale
for each knob (the ``*_fast`` gadget, centered decomposition, on-grid keys,
limb drop) is documented at the JAX definitions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

MOD32 = 1 << 32


@dataclasses.dataclass(frozen=True)
class TFHEParams:
    """One complete TFHE parameter profile (immutable, hashable).

    Field map to the reference structs (``params/params.go:50-78``):
    lwe_n/lwe_alpha = TLWELv0 N/ALPHA; n/lv1_alpha/nbit = TLWELv1 / TRLWE /
    TRGSW N, ALPHA, NBIT; bgbit/l = the gadget; basebit/iks_t = identity
    key switching; block_size = TRGSW BlockSize.
    """

    name: str
    lwe_n: int
    lwe_alpha: float
    n: int
    lv1_alpha: float
    nbit: int
    bgbit: int
    l: int
    basebit: int
    iks_t: int
    block_size: int
    message_modulus: int = 2
    poly_extend_factor: int = 1
    # drop this many of the 4 base-256 key limbs in the external product;
    # exact because key_grid_bits >= 8 * kernel_limb_drop makes them zero
    kernel_limb_drop: int = 0
    # generate the BSK on the 2^key_grid_bits torus subgrid
    key_grid_bits: int = 0
    # round-to-nearest gadget decomposition instead of the reference's floor
    centered_decomposition: bool = False

    # ---- derived quantities -------------------------------------------------

    @property
    def bg(self) -> int:
        """Gadget base  Bg = 2^BGBIT  (params/params.go:72)."""
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)

    @property
    def base(self) -> int:
        """Key-switching base  2^BASEBIT  (trgsw/trgsw.go:288)."""
        return 1 << self.basebit

    @property
    def ksk_alpha(self) -> float:
        return self.lwe_alpha

    @property
    def bsk_alpha(self) -> float:
        return self.lv1_alpha

    @property
    def tail_bits(self) -> int:
        """Bits below the gadget's reach: 32 - L*BGBIT."""
        return 32 - self.l * self.bgbit

    @property
    def decomposition_offset(self) -> int:
        """sum_i (Bg/2) * 2^(32-(i+1)*BGBIT) mod 2^32
        (cloudkey/cloudkey.go:60-71), plus half the tail grid when
        centered."""
        off = 0
        for i in range(self.l):
            off += (self.bg // 2) * (1 << (32 - (i + 1) * self.bgbit))
        if self.centered_decomposition and self.tail_bits > 0:
            off += 1 << (self.tail_bits - 1)
        return off % MOD32

    @property
    def gadget_powers(self) -> Tuple[int, ...]:
        """2^(32-(i+1)*BGBIT) (trgsw/trgsw.go:38-42)."""
        return tuple((1 << (32 - (i + 1) * self.bgbit)) % MOD32
                     for i in range(self.l))

    @property
    def ks_prec_offset(self) -> int:
        """2^(32-(1+basebit*iks_t)) (trgsw/keyswitch.go:23)."""
        return 1 << (32 - (1 + self.basebit * self.iks_t))

    @property
    def mod_switch_offset(self) -> int:
        """2^(31-NBIT-1) (evaluator/evaluator.go:116)."""
        return 1 << (31 - self.nbit - 1)

    @property
    def mod_switch_shift(self) -> int:
        """32-NBIT-1 (evaluator/evaluator.go:116)."""
        return 32 - self.nbit - 1

    @property
    def lut_size(self) -> int:
        return self.poly_extend_factor * self.n

    @property
    def block_count(self) -> int:
        if self.block_size <= 1:
            return self.lwe_n
        return (self.lwe_n + self.block_size - 1) // self.block_size

    @property
    def use_block_blind_rotation(self) -> bool:
        return self.block_size > 1

    @property
    def digits_fit_int8(self) -> bool:
        return self.half_bg <= 128

    @property
    def digit_limbs(self) -> int:
        """Signed base-256 limbs per gadget digit: 1 for BGBIT <= 8, 3 for
        the Uint profiles (see ops.polymul.split_signed_limbs_i8)."""
        if self.half_bg <= 128:
            return 1
        nd = 2
        while self.half_bg > 64 * (256 ** (nd - 1)):
            nd += 1
        return nd

    def __post_init__(self):
        if self.n != 1 << self.nbit:
            raise ValueError(f"{self.name}: n {self.n} != 2^nbit")
        if self.l * self.bgbit > 32:
            raise ValueError(f"{self.name}: l*bgbit > 32")
        if self.basebit * self.iks_t >= 32:
            raise ValueError(f"{self.name}: basebit*iks_t >= 32")
        if self.key_grid_bits < 8 * self.kernel_limb_drop:
            raise ValueError(f"{self.name}: a dropped key limb is not zero "
                             "(key_grid_bits < 8*kernel_limb_drop)")
        if self.key_grid_bits > self.tail_bits and self.tail_bits != 0:
            raise ValueError(f"{self.name}: key grid above the gadget tail")


# ---------------------------------------------------------------------------
# Profile registry — numeric values from params/params.go:83-514, as in
# go_tfhe_tpu/params.py.
# ---------------------------------------------------------------------------

P80 = TFHEParams(
    name="80bit",
    lwe_n=550, lwe_alpha=5.0e-5,
    n=1024, lv1_alpha=3.73e-8, nbit=10,
    bgbit=6, l=3, basebit=2, iks_t=7, block_size=3,
)

P110 = TFHEParams(
    name="110bit",
    lwe_n=630, lwe_alpha=3.0517578125e-05,
    n=1024, lv1_alpha=2.980232238769531e-8, nbit=10,
    bgbit=6, l=3, basebit=2, iks_t=8, block_size=3,
)

P128 = TFHEParams(
    name="128bit",
    lwe_n=700, lwe_alpha=2.0e-5,
    n=1024, lv1_alpha=2.0e-8, nbit=10,
    bgbit=6, l=3, basebit=2, iks_t=9, block_size=3,
)

UINT1 = TFHEParams(
    name="uint1",
    lwe_n=700, lwe_alpha=2.0e-05,
    n=1024, lv1_alpha=2.0e-08, nbit=10,
    bgbit=10, l=2, basebit=2, iks_t=8, block_size=3,
    message_modulus=2,
)

UINT2 = TFHEParams(
    name="uint2",
    lwe_n=687, lwe_alpha=0.00002120846893069971872305794214,
    n=512, lv1_alpha=0.00000000000231841227527049948463, nbit=9,
    bgbit=18, l=1, basebit=4, iks_t=3, block_size=3,
    message_modulus=4,
)

UINT3 = TFHEParams(
    name="uint3",
    lwe_n=820, lwe_alpha=0.00000251676160959795544987084234,
    n=1024, lv1_alpha=0.00000000000000022204460492503131, nbit=10,
    bgbit=23, l=1, basebit=6, iks_t=2, block_size=4,
    message_modulus=8,
)

UINT4 = TFHEParams(
    name="uint4",
    lwe_n=820, lwe_alpha=0.00000251676160959795544987084234,
    n=2048, lv1_alpha=0.00000000000000022204460492503131, nbit=11,
    bgbit=22, l=1, basebit=5, iks_t=3, block_size=4,
    message_modulus=16,
)

UINT5 = TFHEParams(
    name="uint5",
    lwe_n=1071, lwe_alpha=7.088226765410429399593757e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=6, iks_t=3, block_size=7,
    message_modulus=32,
)

UINT6 = TFHEParams(
    name="uint6",
    lwe_n=1071, lwe_alpha=7.088226765410429399593757e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=6, iks_t=3, block_size=7,
    message_modulus=64, poly_extend_factor=2,
)

UINT7 = TFHEParams(
    name="uint7",
    lwe_n=1160, lwe_alpha=1.966220007498402695211596e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=7, iks_t=3, block_size=8,
    message_modulus=128, poly_extend_factor=4,
)

UINT8 = TFHEParams(
    name="uint8",
    lwe_n=1160, lwe_alpha=1.966220007498402695211596e-08,
    n=2048, lv1_alpha=2.2204460492503131e-17, nbit=11,
    bgbit=22, l=1, basebit=7, iks_t=3, block_size=8,
    message_modulus=256, poly_extend_factor=9,
)

# Small, insecure profiles for fast CPU tests (margins in go_tfhe_tpu/params.py).
TEST_FAST = TFHEParams(
    name="test_fast",
    lwe_n=16, lwe_alpha=1.0 / (1 << 20),
    n=128, lv1_alpha=1.0 / (1 << 28), nbit=7,
    bgbit=8, l=2, basebit=4, iks_t=6, block_size=1,
    message_modulus=2,
)

TEST_BLOCK = TFHEParams(
    name="test_block",
    lwe_n=17, lwe_alpha=1.0 / (1 << 20),
    n=128, lv1_alpha=1.0 / (1 << 28), nbit=7,
    bgbit=8, l=2, basebit=4, iks_t=6, block_size=2,
    message_modulus=2,
)

TEST_PBS = TFHEParams(
    name="test_pbs",
    lwe_n=32, lwe_alpha=1.0 / (1 << 26),
    n=512, lv1_alpha=1.0 / (1 << 30), nbit=9,
    bgbit=8, l=3, basebit=4, iks_t=7, block_size=1,
    message_modulus=8,
)

TEST_NIBBLE = TFHEParams(
    name="test_nibble",
    lwe_n=16, lwe_alpha=1.0 / (1 << 28),
    n=1024, lv1_alpha=1.0 / (1 << 32), nbit=10,
    bgbit=8, l=3, basebit=4, iks_t=7, block_size=1,
    message_modulus=32,
)

TEST_EXT2 = TFHEParams(
    name="test_ext2",
    lwe_n=16, lwe_alpha=1.0 / (1 << 28),
    n=256, lv1_alpha=1.0 / (1 << 31), nbit=8,
    bgbit=8, l=3, basebit=4, iks_t=6, block_size=1,
    message_modulus=16, poly_extend_factor=2,
)

TEST_EXT3 = TFHEParams(
    name="test_ext3",
    lwe_n=16, lwe_alpha=1.0 / (1 << 28),
    n=256, lv1_alpha=1.0 / (1 << 31), nbit=8,
    bgbit=8, l=3, basebit=4, iks_t=6, block_size=1,
    message_modulus=12, poly_extend_factor=3,
)

# Throughput-tuned variants: same crypto parameters, bgbit=8/l=2 gadget,
# centered decomposition, on-grid (q = 2^24) BSK with its zero low key limb
# dropped from the external product.
P80_FAST = dataclasses.replace(
    P80, name="80bit_fast", bgbit=8, l=2, kernel_limb_drop=1,
    key_grid_bits=8, centered_decomposition=True)
P110_FAST = dataclasses.replace(
    P110, name="110bit_fast", bgbit=8, l=2, kernel_limb_drop=1,
    key_grid_bits=8, centered_decomposition=True)
P128_FAST = dataclasses.replace(
    P128, name="128bit_fast", bgbit=8, l=2, kernel_limb_drop=1,
    key_grid_bits=8, centered_decomposition=True)

UINT6_CENTERED = dataclasses.replace(
    UINT6, name="uint6_centered", centered_decomposition=True)
UINT7_CENTERED = dataclasses.replace(
    UINT7, name="uint7_centered", centered_decomposition=True)
UINT8_CENTERED = dataclasses.replace(
    UINT8, name="uint8_centered", centered_decomposition=True)

PROFILES: Dict[str, TFHEParams] = {
    p.name: p
    for p in (P80, P110, P128, P80_FAST, P110_FAST, P128_FAST,
              UINT1, UINT2, UINT3, UINT4, UINT5, UINT6,
              UINT7, UINT8, UINT6_CENTERED, UINT7_CENTERED, UINT8_CENTERED,
              TEST_FAST, TEST_BLOCK, TEST_PBS, TEST_NIBBLE,
              TEST_EXT2, TEST_EXT3)
}

# Aliases mirroring the reference enum names (params/params.go:32-44).
PROFILES["Security80Bit"] = P80
PROFILES["Security110Bit"] = P110
PROFILES["Security128Bit"] = P128
for _i in range(1, 9):
    PROFILES[f"SecurityUint{_i}"] = PROFILES[f"uint{_i}"]

DEFAULT = P128


def get_params(name: str) -> TFHEParams:
    """Look a profile up by name ('128bit', 'uint5', 'Security80Bit', ...)."""
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown parameter profile {name!r}; available: "
            f"{sorted(set(p.name for p in PROFILES.values()))}") from None


def band_limb_drop(p: TFHEParams) -> int:
    """The key limbs that the bands of a profile's keys are packed without
    (``ops.cuda_t.pack_bsk_band_t``'s ``lo``) and that the external
    products skip: the TPU kernel's ``kernel_limb_drop`` for single-limb
    digits, else 0."""
    return p.kernel_limb_drop if p.digit_limbs == 1 else 0


def security_info(p: TFHEParams) -> str:
    """Human-readable description (params/params.go:639-666); the JAX
    package's strings word for word (``go_tfhe_tpu/params.py:482-506``)."""
    descs = {
        "80bit": "80-bit security (performance-optimized)",
        "110bit": "110-bit security (balanced, original TFHE)",
        "128bit": "128-bit security (high security, quantum-resistant)",
    }
    base = p.name
    suffix = ""
    if base.endswith("_fast"):
        base = base[:-5]
        suffix = (" [TPU-tuned CloudKey: bgbit=8/l=2 gadget, centered "
                  "decomposition, on-grid q=2^24 BSK — same crypto "
                  "parameters as the base profile, see SECURITY.md]")
    elif base.endswith("_centered"):
        base = base[:-9]
        suffix = (" [centered gadget decomposition: zero-mean "
                  "representation error, same crypto parameters]")
    if base.startswith("uint"):
        bits = base[4:]
        return (f"Uint{bits} parameters ({bits}-bit messages, "
                f"messageModulus={p.message_modulus}, N={p.n})" + suffix)
    if base in descs:
        return descs[base] + suffix
    return f"{p.name} (custom profile)"
