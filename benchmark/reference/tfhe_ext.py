"""The plain reference of the bootstrap over an extended look-up table of
k*N words, for any k = poly_extend_factor >= 1, in plain PyTorch.

The upstream project (thedonutfactory/go-tfhe) lists extended tables for
Uint6-8 (params/UINT_STATUS.md:20-31) but never built the mechanism
(lut/generator.go:19-21), so its definition here is the JAX package's,
read and not imported: the mod switch ``go_tfhe_tpu/ops/blindrotate.py:
66-79``, the rotation ``:120-159``, the block rotation
``go_tfhe_tpu/ops/rotate.py:48-74`` and the table ``go_tfhe_tpu/lut.py:
85-114``.  Keys, encryption, the gadget decomposition, the exact float64
external product, the sample extraction and the key switch are
:mod:`benchmark.reference.tfhe`'s.  Nothing of the program is imported.

The table is a polynomial of degree kN mod X^(kN) + 1, the look-up table
of lut/generator.go:56-100 over LookUpTableSize = kN, stored interleaved as
k trivial TRLWE blocks, ``big[j] = block[j % k][j // k]``.  With Y = X^k,
X^t times it is a block permutation and a negacyclic Y-rotation of each
block: ``out[r'] = Y^q block[r]``, r = (r' - t) mod k, q = (t + r - r')/k;
a coefficient that wraps takes ~x, as in ``tfhe.py``.  The mod switch
targets [0, 2kN]: floor((x*M + 2^31) / 2^32), computed in 16-bit halves
with every product and sum mod 2^32, ``((x>>16) M + (((x & 0xFFFF) M)
>> 16) + 2^15) >> 16``; 2kN need not be a power of two (36,864 at
uint8).  Each step is ``tfhe.py``'s external product on all k blocks
against the same band, one float64 GEMM of k*B rows, exact for the same
reason (partial sums below 4096 * 2^21 * 2^16 = 2^49 at uint6-8).  The
bootstrap's output is block 0's sample extraction at index 0, then the
identity key switch.

Departures from the JAX package, none of which changes a word:

* at k = 1 the mod switch is this general form too, where the plain
  bootstrap shifts (``(x + 2^(s-1)) >> s``); the two agree mod 2N, which is
  all the rotation reads;
* the rotation is always the gather form (``monomial_mul_blocks``), never
  the composition of static rotations that the JAX package takes on a TPU
  (bit-exact with it);
* a table's entries over m messages are encoded as the JAX package's and
  the upstream encoder encode them, x * (1 / (2m)) (lut/encoder.go:47-75),
  where ``tfhe.lut_testvec`` divides; the two agree where m is a power of
  two;
* the gates' test vector of an extended key is the constant 1/8 in every
  block, (k, 2, N), as the JAX package's extended cloud key holds it.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import tfhe
from benchmark.reference.tfhe import (GATES, MASK, TRUTH, TWO32,  # noqa: F401
                                      as_int32, decrypt_bool,
                                      decrypt_message, encode_bool,
                                      encode_message, gate_input,
                                      lwe_encrypt, phase, words)


@dataclasses.dataclass(frozen=True)
class Params(tfhe.Params):
    """A TFHE parameter set as a configuration file states it, any
    poly_extend_factor k >= 1 with 2kN <= 2^16: the mod switch keeps 16
    bits of its result, so above 2^16 it would give its value mod 2^16 and
    not mod 2kN."""

    @classmethod
    def from_config(cls, params: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        prm = cls(**{k: v for k, v in params.items() if k in names})
        if prm.n != 1 << prm.nbit:
            raise ValueError(f"n {prm.n} != 2^nbit")
        if not 1 <= prm.poly_extend_factor <= (1 << 15) // prm.n:
            raise ValueError(f"poly_extend_factor {prm.poly_extend_factor}: "
                             f"need 1 <= k and 2kN <= 2^16")
        return prm


def make_keys(gen: torch.Generator, prm: Params) -> dict:
    """``tfhe.make_keys``; an extended key's ``testvec`` is (k, 2, N)."""
    keys = tfhe.make_keys(gen, prm)
    k = prm.poly_extend_factor
    if k > 1:
        keys["testvec"] = keys["testvec"].expand(k, 2, prm.n).contiguous()
    return keys


def lut_testvec(prm: Params, table, modulus: int, device) -> torch.Tensor:
    """The trivial look-up table of ``table`` (message -> message) over
    ``modulus`` messages and kN coefficients (lut/generator.go:56-100):
    each message owns a segment, the table is rotated back by half a
    segment and the wrapped part negated; interleaved into k blocks,
    (k, 2, N) int32 words, (2, N) at k = 1."""
    k, n, m = prm.poly_extend_factor, prm.n, modulus
    size = k * n

    def div_round(a, b):
        return (a + b // 2) // b

    raw = [0] * size
    for x in range(m):
        value = tfhe.f64_to_torus((table[x] % m) * (1.0 / (2 * m)))
        for i in range(div_round(x * size, m), div_round((x + 1) * size, m)):
            raw[i] = value
    off = div_round(size, 2 * m)
    rot = raw[off:] + raw[:off]
    rot[size - off:] = [(-v) % TWO32 for v in rot[size - off:]]
    tv = torch.zeros((k, 2, n), dtype=torch.int64, device=device)
    tv[:, 1] = torch.tensor(rot, dtype=torch.int64,
                            device=device).reshape(n, k).T
    return as_int32(tv if k > 1 else tv[0])


def mod_switch(x: torch.Tensor, modulus: int) -> torch.Tensor:
    """Torus words -> [0, modulus]: floor((x*M + 2^31) / 2^32) in 16-bit
    halves, each product and sum mod 2^32.  The result keeps 16 bits, so
    it is exact mod M only for M <= 2^16."""
    x = x & MASK
    acc = ((x >> 16) * modulus + ((((x & 0xFFFF) * modulus) & MASK) >> 16)
           + (1 << 15))
    return (acc & MASK) >> 16


def rotate_blocks(acc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """X^t times the interleaved polynomial: acc (B, k, C, N) int64 words,
    t (B,), taken mod 2kN."""
    bsz, k, c, n = acc.shape
    t = t % (2 * k * n)
    r_out = torch.arange(k, device=acc.device)
    r_src = (r_out - t[:, None]) % k                            # (B, k)
    q = (t[:, None] + r_src - r_out) // k                       # [0, 2N]
    blocks = torch.gather(acc, 1, r_src[:, :, None, None].expand(acc.shape))
    return tfhe._rotate(blocks.reshape(bsz * k, c, n),
                        q.reshape(-1)).reshape(acc.shape)


class Bootstrap(tfhe.Bootstrap):
    """The whole bootstrap over an extended table under one cloud key:
    ``tfhe.Bootstrap``'s key forms (and its ``key_bits`` < 32 for the
    control), the blind rotation over k blocks, sample extraction of block
    0 at 0, ``tfhe.Bootstrap``'s key switch."""

    def blind_rotate(self, ct: torch.Tensor, testvec: torch.Tensor
                     ) -> torch.Tensor:
        """acc = X^(-b~) tv; for each i: acc += BSK[i] (x) (X^(a~_i) acc -
        acc) on every block, mod switches to [0, 2kN].  ct (B, lwe_n+1)
        words, testvec (1 or B, k, 2, N) words; returns (B, k, 2, N) int64
        words."""
        prm = self.prm
        k, n, l2 = prm.poly_extend_factor, prm.n, 2 * prm.l
        big = 2 * k * n
        ct = words(ct)
        bsz = ct.shape[0]
        acc = rotate_blocks(words(testvec).expand(bsz, k, 2, n),
                            big - mod_switch(ct[:, prm.lwe_n], big))
        a_t = mod_switch(ct[:, :prm.lwe_n], big)
        for i in range(prm.lwe_n):
            diff = (rotate_blocks(acc, a_t[:, i]) - acc) & MASK
            digits = tfhe._decompose(diff.reshape(bsz * k, 2, n), prm)
            prod = (digits.reshape(bsz * k, l2 * n).to(torch.float64)
                    @ self.bands[i][self.idx])
            ext = tfhe._recombine16(prod[:, :2 * n], prod[:, 2 * n:])
            acc = (acc + ext.reshape(bsz, k, 2, n)) & MASK
        return acc

    def __call__(self, ct: torch.Tensor, testvec: torch.Tensor
                 ) -> torch.Tensor:
        """ct (B, lwe_n+1) int32 words, testvec (k, 2, N) or (B, k, 2, N)
        ((2, N) or (B, 2, N) at k = 1) -> int32 words (B, lwe_n+1), the
        rotation BOOTSTRAP_ROWS rows (k per ciphertext) at a time."""
        k, n = self.prm.poly_extend_factor, self.prm.n
        rows = max(1, tfhe.BOOTSTRAP_ROWS // k)
        tv = testvec.reshape(-1, k, 2, n)
        outs = []
        for s in range(0, ct.shape[0], rows):
            acc = self.blind_rotate(
                ct[s:s + rows], tv if tv.shape[0] == 1 else tv[s:s + rows])
            outs.append(self.key_switch(tfhe.sample_extract(acc[:, 0])))
        return as_int32(torch.cat(outs))
