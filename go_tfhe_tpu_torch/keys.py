"""Secret and cloud (evaluation) keys: generation, conversion, ``.npz`` files
(port of ``go_tfhe_tpu/keys.py:44-158, 205-302``).

The ``.npz`` format is the JAX package's (``keys.save_cloud_key`` /
``save_secret_key``): uint32 arrays ``testvec``, ``ksk``, ``bsk``, the
profile name and the ``block_binary`` flag; files written by either
package load in the other.  The CloudKey keeps the raw BSK and the K2
bands built from it (ops/cuda_t.pack_bsk_band_t), the one band layout that
every kernel rotation reads: the block rotation views the bands of each
block as one block step's rows (ops/blindrotate.block_bands).

Deviation: the JAX CloudKey also carries ``bsk_kernel``, the signed D
bands of its portable path.  The port's carries no such field: the
portable rotations (ops/blindrotate.blind_rotate and its extended and
block forms) take :func:`prepare_bootstrap_kernels`'s bands, which
``engine._bootstrap`` builds from ``bsk`` on each call that takes a
portable route (about 46 MB at ``128bit_fast``).  So ``.npz`` files,
``CloudKey.to``, ``parallel.replicate_keys`` and
``utils.profiling.key_memory_usage`` see the same fields as before.

Entry points that make tensors from arrays or files put them on the card
(``device="cuda"``) unless the caller asks for the host with
``device="cpu"``; with no CUDA device they raise, as torch's ``.to("cuda")``
does.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import cipher
from .ops.cuda_t import band_limb_drop, pack_bsk_band_t
from .ops.polymul import ext_band_from_trgsw
from .params import TFHEParams, get_params
from .utils.rng import binary_key, block_binary_key
from .utils.torus import TORUS, f64_to_torus, from_numpy_u32, i32
from .utils.torus import to_numpy_u32


@dataclasses.dataclass
class SecretKey:
    """Binary secret keys for both levels (key/key.go:10-13)."""
    lv0: torch.Tensor   # (lwe_n,) int32 in {0,1}
    lv1: torch.Tensor   # (n,)     int32 in {0,1}
    block_binary: bool = False

    def to(self, device) -> "SecretKey":
        return dataclasses.replace(self, lv0=self.lv0.to(device),
                                   lv1=self.lv1.to(device))


@dataclasses.dataclass
class CloudKey:
    """Public evaluation key (cloudkey/cloudkey.go:16-21)."""
    testvec: torch.Tensor   # (2, N), or (k, 2, N) extended — constant 1/8
    ksk: torch.Tensor       # (N, iks_t, base, lwe_n+1); [.., 0, :] == 0
    bsk: torch.Tensor       # (lwe_n, 2L, 2, N) — raw TRGSW form
    bands: torch.Tensor     # (lwe_n, 2, 2L, 2N) — K2 bands, limb drop folded;
    #                         read by every blind rotation (K2, K5, K8)
    params: TFHEParams
    block_binary: bool = False
    # False: the counterpart of a JAX key without the reversed band
    # (bsk_band_rev None), which the JAX TPU dispatch sends to the
    # row-major cores (engine._route).  Every rotation reads the same
    # bands, so the flag costs no memory; like the bands it is not saved
    # in ``.npz`` files.  Set it with dataclasses.replace(ck, ...).
    transposed: bool = True

    def to(self, device) -> "CloudKey":
        return dataclasses.replace(
            self, testvec=self.testvec.to(device), ksk=self.ksk.to(device),
            bsk=self.bsk.to(device), bands=self.bands.to(device))


def gen_secret_key(gen: torch.Generator, p: TFHEParams, device,
                   block_binary: bool = False) -> SecretKey:
    """key/key.go:16-45 (``go_tfhe_tpu/keys.py:89-117``).

    The default samples both levels uniform binary, the distribution the
    reference uses.  ``block_binary=True`` samples a block-binary lv0 key
    (Hamming weight <= 1 per block of ``p.block_size`` bits), which the
    block blind rotation needs (engine.PREFER_BLOCK_ROTATION); the lv1
    ring key stays uniform binary.

    SECURITY CAVEAT for ``block_binary=True``: a block-binary key has
    log2(block_size+1)/block_size entropy bits per key bit (< 1), so a
    profile's nominal security level does not carry over.  The JAX
    package's estimate (primal uSVP + guess-and-reduce, SECURITY.md): at
    the 128-bit profile the cost drops from 107.2 classical core-SVP bits
    (uniform) to 105.1 at block_size 3 (the shipped BlockSize) and 97.6 at
    block_size 8.  The reference never samples such keys.
    """
    if block_binary and p.block_size <= 1:
        raise ValueError(
            f"profile {p.name!r} has block_size {p.block_size}; "
            "block-binary keys need block_size > 1")
    lv0 = (block_binary_key(gen, p.lwe_n, p.block_size, device)
           if block_binary else binary_key(gen, p.lwe_n, device))
    return SecretKey(lv0=lv0, lv1=binary_key(gen, p.n, device),
                     block_binary=block_binary)


def gen_testvec(p: TFHEParams, device) -> torch.Tensor:
    """Constant 1/8 test vector: A = 0, B[i] = T(1/8)
    (cloudkey/cloudkey.go:74-85).  For extended profiles (k > 1) the big
    constant polynomial interleaves into k identical blocks, (k, 2, N)."""
    k = p.poly_extend_factor
    tv = torch.zeros((k, 2, p.n), dtype=TORUS, device=device)
    tv[:, 1] = i32(int(f64_to_torus(0.125)))
    return tv[0] if k == 1 else tv


def gen_ksk(gen: torch.Generator, p: TFHEParams, sk: SecretKey
            ) -> torch.Tensor:
    """KSK[i,j,k] encrypts k * s1[i] / 2^((j+1)*basebit) under lv0; the k==0
    rows stay zero (cloudkey/cloudkey.go:88-120, keys.py:141-142)."""
    dev = sk.lv0.device
    ks = torch.arange(p.base, dtype=TORUS, device=dev)
    shifts = torch.tensor([32 - (j + 1) * p.basebit for j in range(p.iks_t)],
                          dtype=TORUS, device=dev)
    mu = (ks[None, None, :] * sk.lv1[:, None, None]) << shifts[None, :, None]
    ct = cipher.lwe_encrypt_torus(gen, mu, p.ksk_alpha, sk.lv0)
    ct[:, :, 0, :] = 0
    return ct


def gen_bsk(gen: torch.Generator, p: TFHEParams, sk: SecretKey
            ) -> torch.Tensor:
    """BSK[i] = TRGSW encryption of LWE key bit s0[i]
    (cloudkey/cloudkey.go:123-145), on the key_grid_bits grid."""
    return cipher.trgsw_encrypt_torus(gen, sk.lv0, p.bsk_alpha, sk.lv1, p)


def prepare_bootstrap_kernels(bsk: torch.Tensor, p: TFHEParams
                              ) -> torch.Tensor:
    """Raw BSK (lwe_n, 2L, 2, N) -> the signed D bands (lwe_n, 2L, 2, 2N)
    int32 of the portable Toeplitz external product
    (``go_tfhe_tpu/keys.py:153-158``), on the BSK's device."""
    del p
    return ext_band_from_trgsw(bsk)


def _cloud_key(p: TFHEParams, testvec, ksk, bsk, block_binary) -> CloudKey:
    return CloudKey(testvec=testvec, ksk=ksk, bsk=bsk,
                    bands=pack_bsk_band_t(bsk, band_limb_drop(p)), params=p,
                    block_binary=block_binary)


def _warn_marginal_profile(p: TFHEParams) -> None:
    """The floor-gadget extended profiles uint7/uint8 are measurably
    unreliable (the JAX package measured 73.8% PBS accuracy at uint7;
    uint8 cannot decode at all, EXT_r04.json): warn at keygen and point at
    the *_centered variants."""
    if (p.poly_extend_factor > 1 and not p.centered_decomposition
            and p.message_modulus >= 128):
        warnings.warn(
            f"profile {p.name!r} uses the reference's floor gadget offset, "
            f"whose bias random-walk exceeds the message-space tolerance at "
            f"messageModulus={p.message_modulus} (measured: uint7 73.8% PBS "
            f"accuracy, uint8 undecodable — EXT_r04.json).  Use "
            f"get_params('{p.name}_centered') for the 100%-accurate "
            f"centered-gadget variant (same crypto parameters).",
            stacklevel=3)


def gen_cloud_key(gen: torch.Generator, sk: SecretKey, p: TFHEParams
                  ) -> CloudKey:
    """cloudkey/cloudkey.go:24-31; on the secret key's device."""
    _warn_marginal_profile(p)
    bsk = gen_bsk(gen, p, sk)
    ksk = gen_ksk(gen, p, sk)
    return _cloud_key(p, gen_testvec(p, sk.lv0.device), ksk, bsk,
                      sk.block_binary)


def gen_cloud_key_no_ksk(p: TFHEParams, device="cuda") -> CloudKey:
    """All-zero KSK and BSK, for tests (cloudkey/cloudkey.go:34-57); the
    bands built from the zero BSK as :func:`gen_cloud_key` builds them."""
    ksk = torch.zeros((p.n, p.iks_t, p.base, p.lwe_n + 1), dtype=TORUS,
                      device=device)
    bsk = torch.zeros((p.lwe_n, 2 * p.l, 2, p.n), dtype=TORUS, device=device)
    return _cloud_key(p, gen_testvec(p, device), ksk, bsk, False)


# ---------------------------------------------------------------------------
# Conversion from the JAX package's arrays, and .npz files.
# ---------------------------------------------------------------------------

def cloud_key_from_numpy(profile, testvec, ksk, bsk,
                         block_binary: bool = False, device="cuda"
                         ) -> CloudKey:
    """A CloudKey from the JAX package's uint32 arrays (the fields
    ``go_tfhe_tpu.keys.save_cloud_key`` writes); bands built from ``bsk``.
    ``profile`` is a registered profile's name or a :class:`TFHEParams`."""
    p = profile if isinstance(profile, TFHEParams) else get_params(profile)
    return _cloud_key(p, from_numpy_u32(testvec, device),
                      from_numpy_u32(ksk, device),
                      from_numpy_u32(bsk, device), bool(block_binary))


def secret_key_from_numpy(lv0, lv1, block_binary: bool = False,
                          device="cuda") -> SecretKey:
    return SecretKey(lv0=from_numpy_u32(lv0, device),
                     lv1=from_numpy_u32(lv1, device),
                     block_binary=bool(block_binary))


def save_secret_key(path: str, sk: SecretKey) -> None:
    np.savez_compressed(path, lv0=to_numpy_u32(sk.lv0),
                        lv1=to_numpy_u32(sk.lv1),
                        block_binary=np.asarray(sk.block_binary))


def load_secret_key(path: str, device="cuda") -> SecretKey:
    with np.load(path) as z:
        return secret_key_from_numpy(
            z["lv0"], z["lv1"],
            bool(z["block_binary"]) if "block_binary" in z else False,
            device)


def save_cloud_key(path: str, ck: CloudKey) -> None:
    np.savez_compressed(
        path,
        profile=np.asarray(ck.params.name),
        testvec=to_numpy_u32(ck.testvec),
        ksk=to_numpy_u32(ck.ksk),
        bsk=to_numpy_u32(ck.bsk),
        block_binary=np.asarray(ck.block_binary),
    )


def load_cloud_key(path: str, device="cuda") -> CloudKey:
    with np.load(path) as z:
        return cloud_key_from_numpy(
            str(z["profile"]), z["testvec"], z["ksk"], z["bsk"],
            bool(z["block_binary"]) if "block_binary" in z else False,
            device)
