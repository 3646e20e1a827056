"""LWE proxy re-encryption (port of ``go_tfhe_tpu/proxyreenc.py``;
reference: proxyreenc/proxyreenc.go).

* Public keys are collections of zero-encryptions (proxyreenc.go:56-92).
* Public-key encryption is a random +-1 subset-sum of the zero-encryptions
  plus the plaintext and fresh noise (proxyreenc.go:104-135): one exact
  float32 product of the {-1, 0, 1} coefficients and the zero-encryptions'
  four balanced int8 limbs (TF32 off; |partial sum| <= size * 128 < 2^24).
* Re-encryption keys (asymmetric via the target's public key, symmetric
  via the target's secret key) are KSK-style digit tables
  (proxyreenc.go:180-300).
* Re-encryption is the identity key switch's one-hot digit contraction
  (``ops.keyswitch.digit_table_switch``) with the table's own basebit and
  t (proxyreenc.go:321-366), batched over ciphertexts.

Keygen and encryption draw from a ``torch.Generator``; tensors live on the
secret key's device.  The ``.npz`` files are the JAX package's (uint32
arrays, ``basebit`` and ``t`` as 0-d arrays); the loaders and the
``*_from_numpy`` converters put the keys on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cipher
from .ops import keyswitch
from .ops.polymul import exact_f32_matmul, split_balanced_limbs_i8
from .params import TFHEParams
from .utils.rng import gaussian_torus
from .utils.torus import TORUS, from_numpy_u32, to_numpy_u32


@dataclasses.dataclass
class PublicKeyLv0:
    """Encryptions of zero (proxyreenc.go:56-58)."""
    encryptions: torch.Tensor  # (size, lwe_n+1) int32 words


@dataclasses.dataclass
class ProxyReencryptionKey:
    """Digit table for key switching between user keys
    (proxyreenc.go:159-163).  table[i, j, 0, :] rows are zero."""
    table: torch.Tensor  # (lwe_n, t, base, lwe_n+1) int32 words
    basebit: int
    t: int

    @property
    def base(self) -> int:
        return 1 << self.basebit


def gen_public_key(gen: torch.Generator, secret_key_lv0: torch.Tensor,
                   p: TFHEParams, size: int | None = None,
                   alpha: float | None = None) -> PublicKeyLv0:
    """proxyreenc.go:69-92: ``size`` zero-encryptions (default 2n)."""
    size = 2 * p.lwe_n if size is None else size
    alpha = p.lwe_alpha if alpha is None else alpha
    zeros = torch.zeros((size,), dtype=TORUS, device=secret_key_lv0.device)
    return PublicKeyLv0(encryptions=cipher.lwe_encrypt_torus(
        gen, zeros, alpha, secret_key_lv0))


def pk_encrypt_torus(gen: torch.Generator, pk: PublicKeyLv0, mu,
                     alpha: float) -> torch.Tensor:
    """Public-key encryption (proxyreenc.go:104-135).

    Each zero-encryption is added with probability 1/4, subtracted with
    probability 1/4 and skipped with probability 1/2 (two Intn(2) draws in
    the reference); then the plaintext and fresh noise are added to b.
    mu: int32 words (a tensor, or host uint32 values) of shape S ->
    (S, lwe_n+1), on the public key's device."""
    enc = pk.encryptions
    dev = enc.device
    mu = (mu if isinstance(mu, torch.Tensor) else from_numpy_u32(mu, dev)
          ).to(device=dev, dtype=TORUS)
    size, w = enc.shape
    shape = tuple(mu.shape) + (size,)
    use = torch.randint(0, 2, shape, generator=gen, device=gen.device)
    sign = torch.randint(0, 2, shape, generator=gen, device=gen.device)
    coeff = (use * (2 * sign - 1)).to(device=dev, dtype=torch.float32)
    limbs = split_balanced_limbs_i8(enc, 4).to(torch.float32)  # (4, size, w)
    with exact_f32_matmul():
        acc = (coeff.reshape(-1, size) @ limbs).to(TORUS)     # (4, M, w)
    out = acc[0]
    for i in range(1, 4):
        out = out + (acc[i] << (8 * i))
    out = out.reshape(tuple(mu.shape) + (w,))
    out[..., -1] += gaussian_torus(gen, mu, alpha, mu.shape)
    return out


def pk_encrypt_bool(gen: torch.Generator, pk: PublicKeyLv0, bits,
                    alpha: float) -> torch.Tensor:
    """proxyreenc.go:144-152."""
    bits = torch.as_tensor(bits, dtype=torch.bool,
                           device=pk.encryptions.device)
    mu = torch.where(bits, cipher.BOOL_TRUE_MU, cipher.BOOL_FALSE_MU)
    return pk_encrypt_torus(gen, pk, mu.to(TORUS), alpha)


def _digit_plaintexts(key_from: torch.Tensor, basebit: int, t: int
                      ) -> torch.Tensor:
    """mu[i,j,k] = T(k * key_from[i] / 2^((j+1)*basebit)), exactly
    (proxyreenc.go:216-218; dyadic, so integer shifts are bit-exact)."""
    dev = key_from.device
    ks = torch.arange(1 << basebit, dtype=TORUS, device=dev)
    shifts = torch.tensor([32 - (j + 1) * basebit for j in range(t)],
                          dtype=TORUS, device=dev)
    return (ks[None, None, :] * key_from[:, None, None]) << shifts[None, :,
                                                                   None]


def gen_reencryption_key_symmetric(
        gen: torch.Generator, key_from: torch.Tensor, key_to: torch.Tensor,
        p: TFHEParams, alpha: float | None = None,
        basebit: int | None = None, t: int | None = None
        ) -> ProxyReencryptionKey:
    """proxyreenc.go:249-300 (defaults: KSKAlpha, BASEBIT, IKS_T)."""
    alpha = p.ksk_alpha if alpha is None else alpha
    basebit = p.basebit if basebit is None else basebit
    t = p.iks_t if t is None else t
    table = cipher.lwe_encrypt_torus(
        gen, _digit_plaintexts(key_from, basebit, t), alpha, key_to)
    table[:, :, 0, :] = 0
    return ProxyReencryptionKey(table=table, basebit=basebit, t=t)


def gen_reencryption_key_asymmetric(
        gen: torch.Generator, key_from: torch.Tensor,
        public_key_to: PublicKeyLv0, p: TFHEParams,
        alpha: float | None = None, basebit: int | None = None,
        t: int | None = None) -> ProxyReencryptionKey:
    """proxyreenc.go:180-232: the digit table encrypted under the target's
    public key."""
    alpha = p.ksk_alpha if alpha is None else alpha
    basebit = p.basebit if basebit is None else basebit
    t = p.iks_t if t is None else t
    table = pk_encrypt_torus(
        gen, public_key_to, _digit_plaintexts(key_from, basebit, t), alpha)
    table[:, :, 0, :] = 0
    return ProxyReencryptionKey(table=table, basebit=basebit, t=t)


def reencrypt(rk: ProxyReencryptionKey, ct: torch.Tensor) -> torch.Tensor:
    """Transform ciphertext(s) (..., lwe_n+1) to the target key
    (proxyreenc.go:321-366).  Multi-hop chains are repeated application."""
    return keyswitch.digit_table_switch(rk.table, ct, rk.basebit, rk.t)


# ---------------------------------------------------------------------------
# Conversion from the JAX package's arrays, and .npz files.
# ---------------------------------------------------------------------------

def public_key_from_numpy(encryptions, device="cuda") -> PublicKeyLv0:
    """A PublicKeyLv0 from the JAX package's uint32 array."""
    return PublicKeyLv0(encryptions=from_numpy_u32(encryptions, device))


def reencryption_key_from_numpy(table, basebit: int, t: int, device="cuda"
                                ) -> ProxyReencryptionKey:
    """A ProxyReencryptionKey from the JAX package's uint32 table."""
    return ProxyReencryptionKey(table=from_numpy_u32(table, device),
                                basebit=int(basebit), t=int(t))


def save_reencryption_key(path: str, rk: ProxyReencryptionKey) -> None:
    np.savez_compressed(path, table=to_numpy_u32(rk.table),
                        basebit=np.asarray(rk.basebit), t=np.asarray(rk.t))


def load_reencryption_key(path: str, device="cuda") -> ProxyReencryptionKey:
    with np.load(path) as z:
        return reencryption_key_from_numpy(z["table"], int(z["basebit"]),
                                           int(z["t"]), device)


def save_public_key(path: str, pk: PublicKeyLv0) -> None:
    np.savez_compressed(path, encryptions=to_numpy_u32(pk.encryptions))


def load_public_key(path: str, device="cuda") -> PublicKeyLv0:
    with np.load(path) as z:
        return public_key_from_numpy(z["encryptions"], device)
