"""The plain TFHE reference of the benchmark: key material, encryption and
the whole bootstrap, in plain PyTorch.

It follows the upstream project's definitions (thedonutfactory/go-tfhe:
``tlwe``, ``trlwe``, ``trgsw``, ``cloudkey``, ``evaluator``, ``lut``) and
imports nothing of the program under test.  Torus words are carried as
int64 values in [0, 2^32) and every sum is reduced with :data:`MASK`, so
the arithmetic is exact mod 2^32 and reads as the definitions do.

Exact products.  A negacyclic product of small signed digits with 32-bit
key words runs as one float64 GEMM against the key's Toeplitz matrix, the
key words split into two unsigned 16-bit halves.  Every partial sum stays
below 2^53 (depth * max|digit| * 2^16: 6144 * 2^5 * 2^16 at 128-bit,
4096 * 2^21 * 2^16 = 2^49 at uint5), so the GEMM is exact.  The key switch
is a float64 one-hot GEMM against the key-switching key's 16-bit halves.

Conventions that the upstream fixes and a bit-exact comparison needs:
a coefficient that wraps in a monomial rotation takes the cheap negation
``^Torus(0) - a`` (bitwise NOT, -a-1), in the rotation and in the sample
extraction; products and look-up tables take the exact negation -a.

``key_bits`` < 32 computes the bootstrap with every key word rounded down
to a multiple of 2^(32 - key_bits): the lower-precision control of the
benchmark's comparison (see ``benchmark/control.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

MASK = 0xFFFFFFFF
TWO32 = 1 << 32
# Rows a step of the work is done in, to bound the memory it takes.
ENCRYPT_ROWS = 1 << 16      # LWE encryptions
BOOTSTRAP_ROWS = 4096       # ciphertexts of a blind rotation
SWITCH_ROWS = 256           # ciphertexts of a key switch's one-hot GEMM

# The two-input gates: (sign of a, sign of b, bias in eighths of the torus)
# of the affine input that the gate bootstraps (evaluator/gates_helper.go,
# gates/gates.go).
GATES = {
    "NAND": (-1, -1, 1), "AND": (1, 1, -1), "OR": (1, 1, 1),
    "XOR": (1, 2, 2), "XNOR": (1, -2, 2), "NOR": (-1, -1, -1),
    "ANDNY": (-1, 1, -1), "ANDYN": (1, -1, -1),
    "ORNY": (-1, 1, 1), "ORYN": (1, -1, 1),
}
# What each gate computes on plaintext bits.
TRUTH = {
    "NAND": lambda a, b: ~(a & b), "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b, "XOR": lambda a, b: a ^ b,
    "XNOR": lambda a, b: ~(a ^ b), "NOR": lambda a, b: ~(a | b),
    "ANDNY": lambda a, b: ~a & b, "ANDYN": lambda a, b: a & ~b,
    "ORNY": lambda a, b: ~a | b, "ORYN": lambda a, b: a | ~b,
}


@dataclasses.dataclass(frozen=True)
class Params:
    """A TFHE parameter set as a configuration file states it
    (params/params.go)."""
    lwe_n: int
    lwe_alpha: float
    n: int
    nbit: int
    lv1_alpha: float
    bgbit: int
    l: int
    basebit: int
    iks_t: int
    message_modulus: int = 2
    poly_extend_factor: int = 1
    centered_decomposition: bool = False

    @classmethod
    def from_config(cls, params: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        prm = cls(**{k: v for k, v in params.items() if k in names})
        if prm.poly_extend_factor != 1:
            raise NotImplementedError(
                "the plain reference covers profiles without extended "
                f"tables, not poly_extend_factor {prm.poly_extend_factor}")
        if prm.n != 1 << prm.nbit:
            raise ValueError(f"n {prm.n} != 2^nbit")
        return prm

    @property
    def decomposition_offset(self) -> int:
        """sum_i (Bg/2) 2^(32-(i+1)Bgbit) (cloudkey/cloudkey.go:60-71),
        plus half the grid below the gadget when centered."""
        off = sum((1 << (self.bgbit - 1)) << (32 - (i + 1) * self.bgbit)
                  for i in range(self.l))
        tail = 32 - self.l * self.bgbit
        if self.centered_decomposition and tail > 0:
            off += 1 << (tail - 1)
        return off % TWO32


# ---------------------------------------------------------------------------
# Words.
# ---------------------------------------------------------------------------

def words(x: torch.Tensor) -> torch.Tensor:
    """int32 words (the program's form) or int64 values -> int64 in
    [0, 2^32)."""
    return x.to(torch.int64) & MASK


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 words with the same low 32 bits."""
    x = x & MASK
    return torch.where(x >= 1 << 31, x - TWO32, x).to(torch.int32)


def f64_to_torus(d: float) -> int:
    """utils/utils.go:11-14: Torus(int64(math.Mod(d, 1) * 2^32))."""
    return int(math.fmod(d, 1.0) * TWO32) % TWO32


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, TWO32, tuple(shape), dtype=torch.int64,
                         generator=gen, device=gen.device)


def _noise(gen: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """Gaussian torus noise, truncated toward zero as Go's int64() does
    (utils/utils.go:31-34)."""
    x = torch.randn(tuple(shape), dtype=torch.float64, generator=gen,
                    device=gen.device) * alpha
    return torch.trunc(torch.fmod(x, 1.0) * TWO32).to(torch.int64) & MASK


def _limbs16(x: torch.Tensor) -> torch.Tensor:
    """int64 words -> (2, ...) float64 unsigned 16-bit halves."""
    return torch.stack([(x & 0xFFFF).to(torch.float64),
                        (x >> 16).to(torch.float64)])


def _recombine16(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Exact float64 sums of the two halves -> int64 words mod 2^32."""
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64) & 0xFFFF      # only hi mod 2^16 survives << 16
    return (lo + (hi << 16)) & MASK


# ---------------------------------------------------------------------------
# Keys and encryption (the benchmark's data).
# ---------------------------------------------------------------------------

def lwe_encrypt(gen: torch.Generator, mu: torch.Tensor, alpha: float,
                key: torch.Tensor) -> torch.Tensor:
    """LWE encryptions of torus words mu (any shape S) under a binary key:
    a uniform, b = <a, s> + mu + e (tlwe/tlwe.go:36-50).  Returns int32
    words (S, n+1), made ENCRYPT_ROWS rows at a time."""
    chunk = ENCRYPT_ROWS
    n = key.shape[0]
    flat = words(mu).reshape(-1)
    out = torch.empty((flat.shape[0], n + 1), dtype=torch.int32,
                      device=key.device)
    k64 = key.to(torch.int64)
    for s in range(0, flat.shape[0], chunk):
        rows = flat[s:s + chunk]
        a = _uniform(gen, (rows.shape[0], n))
        b = (a * k64).sum(-1) + rows + _noise(gen, alpha, rows.shape)
        out[s:s + chunk, :n] = as_int32(a)
        out[s:s + chunk, n] = as_int32(b)
    return out.reshape(tuple(mu.shape) + (n + 1,))


def _negacyclic_binary(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """a (M, N) int64 words times a binary polynomial, mod X^N + 1 and
    2^32: c[m] = sum_j a[j] S[j, m], S[j, m] = s[m-j] (m >= j) or
    -s[N+m-j]; the sums of the 16-bit halves are below 2^27."""
    n = key.shape[0]
    j = torch.arange(n, device=key.device)
    diff = j[None, :] - j[:, None]                     # m - j
    s = key.to(torch.float64)
    toeplitz = torch.where(diff >= 0, s[diff % n], -s[diff % n])
    lo, hi = _limbs16(a)
    return _recombine16(lo @ toeplitz, hi @ toeplitz)


def make_keys(gen: torch.Generator, prm: Params) -> dict:
    """Secret keys and the raw cloud key on the generator's device:
    ``lv0`` (lwe_n,) and ``lv1`` (N,) uniform binary int64; ``bsk``
    (lwe_n, 2L, 2, N), ``ksk`` (N, t, base, lwe_n+1) and ``testvec`` (2, N)
    int32 words, in the layouts of the upstream cloud key
    (cloudkey/cloudkey.go:24-145)."""
    dev = gen.device
    lv0 = torch.randint(0, 2, (prm.lwe_n,), generator=gen, device=dev)
    lv1 = torch.randint(0, 2, (prm.n,), generator=gen, device=dev)
    # BSK[i]: 2L TRLWE encryptions of 0 under lv1, plus s0[i] * g_r on the
    # A side of rows r < L and the B side of rows r >= L (trgsw.go:32-57)
    rows = prm.lwe_n * 2 * prm.l
    a = _uniform(gen, (rows, prm.n))
    b = (_negacyclic_binary(a, lv1)
         + _noise(gen, prm.lv1_alpha, (rows, prm.n))) & MASK
    bsk = torch.stack([a, b], dim=1).reshape(prm.lwe_n, 2 * prm.l, 2, prm.n)
    g = torch.tensor([1 << (32 - (r + 1) * prm.bgbit) for r in range(prm.l)],
                     dtype=torch.int64, device=dev)
    add = lv0[:, None] * g                                  # (lwe_n, L)
    bsk[:, :prm.l, 0, 0] += add
    bsk[:, prm.l:, 1, 0] += add
    # KSK[i, j, k] encrypts k * s1[i] / 2^((j+1) basebit) under lv0; the
    # k = 0 rows are zero (cloudkey.go:88-120)
    base = 1 << prm.basebit
    k = torch.arange(base, device=dev)
    shifts = torch.tensor([32 - (j + 1) * prm.basebit
                           for j in range(prm.iks_t)], device=dev)
    mu = (k[None, None, :] * lv1[:, None, None]) << shifts[None, :, None]
    ksk = lwe_encrypt(gen, mu, prm.lwe_alpha, lv0)
    ksk[:, :, 0, :] = 0
    return {"lv0": lv0, "lv1": lv1, "bsk": as_int32(bsk), "ksk": ksk,
            "testvec": gate_testvec(prm, dev)}


def encode_bool(bits: torch.Tensor) -> torch.Tensor:
    """+1/8 for true, -1/8 for false (tlwe/tlwe.go:52-61)."""
    return torch.where(bits, 1 << 29, TWO32 - (1 << 29)).to(torch.int64)


def encode_message(msgs: torch.Tensor, modulus: int) -> torch.Tensor:
    """m -> m * 2^31 / modulus (tlwe/programmable_encrypt.go:12-26)."""
    return (msgs.to(torch.int64) % modulus) * ((1 << 31) // modulus)


def phase(ct: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """b - <a, s> as int64 words."""
    n = key.shape[0]
    ct = words(ct)
    return (ct[..., n] - (ct[..., :n] * key.to(torch.int64)).sum(-1)) & MASK


def decrypt_bool(ct: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The sign of the phase (tlwe/tlwe.go:64-73)."""
    return phase(ct, key) < 1 << 31


def decrypt_message(ct: torch.Tensor, modulus: int,
                    key: torch.Tensor) -> torch.Tensor:
    """DivRound of the unsigned phase (tlwe/programmable_encrypt.go:32-54)."""
    scale = (1 << 31) // modulus
    return (((phase(ct, key) + scale // 2) & MASK) // scale) % modulus


# ---------------------------------------------------------------------------
# Test vectors and gate inputs.
# ---------------------------------------------------------------------------

def gate_testvec(prm: Params, device) -> torch.Tensor:
    """A = 0, B = T(1/8) everywhere (cloudkey/cloudkey.go:74-85)."""
    tv = torch.zeros((2, prm.n), dtype=torch.int64, device=device)
    tv[1] = 1 << 29
    return as_int32(tv)


def lut_testvec(prm: Params, table, modulus: int, device) -> torch.Tensor:
    """The trivial TRLWE look-up table of ``table`` (message -> message)
    over ``modulus`` messages (lut/generator.go:56-100, encoder scale
    1/(2 modulus)): each message owns a segment of the N coefficients,
    the table is rotated back by half a segment and the wrapped part
    negated."""
    n, m = prm.n, modulus

    def div_round(a, b):
        return (a + b // 2) // b

    raw = [0] * n
    for x in range(m):
        value = f64_to_torus((table[x] % m) / (2 * m))
        for i in range(div_round(x * n, m), div_round((x + 1) * n, m)):
            raw[i] = value
    off = div_round(n, 2 * m)
    rot = raw[off:] + raw[:off]
    rot[n - off:] = [(-v) % TWO32 for v in rot[n - off:]]
    tv = torch.zeros((2, n), dtype=torch.int64, device=device)
    tv[1] = torch.tensor(rot, dtype=torch.int64, device=device)
    return as_int32(tv)


def gate_input(gate: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The affine input that a two-input gate bootstraps:
    sa*a + sb*b + bias/8 on the body (int32 words)."""
    sa, sb, eighths = GATES[gate]
    x = words(a) * sa + words(b) * sb
    x[..., -1] += eighths * (1 << 29)
    return as_int32(x)


# ---------------------------------------------------------------------------
# The bootstrap.
# ---------------------------------------------------------------------------

def _rotate(poly: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """X^amount * poly mod X^N + 1, per row: poly (B, C, N) int64 words,
    amount (B,) in [0, 2N].  Wrapped coefficients take ~x."""
    n = poly.shape[-1]
    amount = amount % (2 * n)
    r = (amount % n)[:, None, None]
    m = torch.arange(n, device=poly.device)
    src = (m - r) % n
    out = torch.gather(poly, -1, src.expand(poly.shape))
    neg = (m < r) ^ (amount >= n)[:, None, None]
    return torch.where(neg, MASK - out, out)


def _mod_switch(x: torch.Tensor, prm: Params) -> torch.Tensor:
    """Torus -> [0, 2N): round(x * 2N / 2^32) (evaluator.go:116,122)."""
    shift = 32 - prm.nbit - 1
    return ((x + (1 << (shift - 1))) & MASK) >> shift


def _decompose(x: torch.Tensor, prm: Params) -> torch.Tensor:
    """(B, 2, N) words -> (B, 2L, N) signed digits in [-Bg/2, Bg/2), rows
    [A level 0..L-1, B level 0..L-1] (trgsw.go, evaluator.go:59-61)."""
    tmp = (x + prm.decomposition_offset) & MASK
    half = 1 << (prm.bgbit - 1)
    d = torch.stack([((tmp >> (32 - (i + 1) * prm.bgbit))
                      & ((1 << prm.bgbit) - 1)) - half
                     for i in range(prm.l)], dim=2)        # (B, 2, L, N)
    return d.reshape(x.shape[0], 2 * prm.l, prm.n)


def _round_key(x: torch.Tensor, key_bits: int) -> torch.Tensor:
    return x & (MASK ^ ((1 << (32 - key_bits)) - 1)) if key_bits < 32 else x


def sample_extract(acc: torch.Tensor) -> torch.Tensor:
    """TRLWE (B, 2, N) -> TLWE level 1 (B, N+1) at index 0:
    a[0] = A[0], a[i] = ~A[N-i], b = B[0] (trlwe/trlwe.go:112-131)."""
    a = acc[:, 0]
    rev = torch.cat([a[:, :1], MASK - a[:, 1:].flip(-1)], dim=-1)
    return torch.cat([rev, acc[:, 1, :1]], dim=-1)


class Bootstrap:
    """The whole bootstrap (evaluator/evaluator.go:139-148) under one
    cloud key: blind rotation, sample extraction at 0, identity key
    switch.  The key's float64 forms are built once, on ``bsk``'s device;
    ``key_bits`` < 32 rounds every key word down first (the control)."""

    def __init__(self, prm: Params, bsk: torch.Tensor, ksk: torch.Tensor,
                 key_bits: int = 32):
        self.prm = prm
        n, l2 = prm.n, 2 * prm.l
        dev = bsk.device
        # D bands: D[r, c] = (-K[r, c] mod 2^32, K[r, c]), length 2N; the
        # Toeplitz T[(r, j), (c, m)] = D[r, c, N + m - j] (negacyclic), both
        # 16-bit halves side by side in the columns.
        k = _round_key(words(bsk), key_bits)
        d = torch.cat([(-k) & MASK, k], dim=-1)       # (lwe_n, 2L, 2, 2N)
        del k
        self.bands = _limbs16(d).transpose(0, 1).reshape(prm.lwe_n, -1)
        del d
        rc, j, c, m = torch.meshgrid(
            torch.arange(l2, device=dev), torch.arange(n, device=dev),
            torch.arange(2, device=dev), torch.arange(n, device=dev),
            indexing="ij")
        idx = ((rc * 2 + c) * 2 * n + n + m - j).reshape(l2 * n, 2 * n)
        self.idx = torch.cat([idx, idx + l2 * 2 * 2 * n], dim=1)
        # the key switch's table: rows (i, j, digit), both halves
        w = prm.lwe_n + 1
        t = _limbs16(_round_key(words(ksk), key_bits).reshape(-1, w))
        self.table = torch.cat([t[0], t[1]], dim=1)   # (N t base, 2w)

    def blind_rotate(self, ct: torch.Tensor, testvec: torch.Tensor
                     ) -> torch.Tensor:
        """acc = X^(-b~) tv; for each i: acc += BSK[i] (x) (X^(a~_i) acc -
        acc) (evaluator/evaluator.go:109-137).  ct (B, lwe_n+1) words,
        testvec (2, N) or (B, 2, N) words; returns (B, 2, N) int64
        words."""
        prm = self.prm
        n, l2 = prm.n, 2 * prm.l
        ct = words(ct)
        bsz = ct.shape[0]
        tv = words(testvec).expand(bsz, 2, n)
        acc = _rotate(tv, 2 * n - _mod_switch(ct[:, prm.lwe_n], prm))
        a_t = _mod_switch(ct[:, :prm.lwe_n], prm)
        for i in range(prm.lwe_n):
            diff = (_rotate(acc, a_t[:, i]) - acc) & MASK
            digits = _decompose(diff, prm).reshape(bsz, l2 * n)
            prod = digits.to(torch.float64) @ self.bands[i][self.idx]
            ext = _recombine16(prod[:, :2 * n], prod[:, 2 * n:])
            acc = (acc + ext.reshape(bsz, 2, n)) & MASK
        return acc

    def key_switch(self, lv1: torch.Tensor) -> torch.Tensor:
        """Identity key switch lv1 (B, N+1) words -> lv0 (B, lwe_n+1)
        (trgsw/keyswitch.go:12-44): abar = a + 2^(32-(1+basebit t)),
        digit(i, j) = abar >> (32-(j+1) basebit) & (base-1),
        out = (0, b) - sum KSK[i, j, digit(i, j)]; a one-hot GEMM of
        SWITCH_ROWS ciphertexts at a time."""
        rows = SWITCH_ROWS
        prm = self.prm
        n, t, base = prm.n, prm.iks_t, 1 << prm.basebit
        w = prm.lwe_n + 1
        dev = lv1.device
        shifts = torch.tensor([32 - (j + 1) * prm.basebit for j in range(t)],
                              device=dev)
        col = (torch.arange(n, device=dev)[:, None] * t
               + torch.arange(t, device=dev)[None, :]) * base
        outs = []
        for s in range(0, lv1.shape[0], rows):
            part = lv1[s:s + rows]
            abar = (part[:, :n] + (1 << (32 - (1 + prm.basebit * t)))) & MASK
            digit = (abar[:, :, None] >> shifts) & (base - 1)  # (b, N, t)
            onehot = torch.zeros((part.shape[0], n * t * base),
                                 dtype=torch.float64, device=dev)
            onehot.scatter_(1, (col + digit).reshape(part.shape[0], -1), 1.0)
            prod = onehot @ self.table
            out = (-_recombine16(prod[:, :w], prod[:, w:])) & MASK
            out[:, -1] = (out[:, -1] + part[:, n]) & MASK
            outs.append(out)
        return torch.cat(outs)

    def __call__(self, ct: torch.Tensor, testvec: torch.Tensor
                 ) -> torch.Tensor:
        """ct (B, lwe_n+1) int32 words -> int32 words (B, lwe_n+1),
        BOOTSTRAP_ROWS ciphertexts at a time."""
        rows = BOOTSTRAP_ROWS
        outs = []
        for s in range(0, ct.shape[0], rows):
            tv = testvec if testvec.dim() == 2 else testvec[s:s + rows]
            acc = self.blind_rotate(ct[s:s + rows], tv)
            outs.append(self.key_switch(sample_extract(acc)))
        return as_int32(torch.cat(outs))
