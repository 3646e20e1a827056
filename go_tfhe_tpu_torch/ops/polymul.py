"""Exact negacyclic polynomial arithmetic mod 2^32
(port of ``go_tfhe_tpu/ops/polymul.py``).

The key identity: with D = concat([-K mod 2^32, K]) of length 2N,

    (a (*) K)[n]  =  sum_j a[j] * D[N + n - j]          (X^N = -1)

so a negacyclic product is a contraction against the Toeplitz matrix
T[j, n] = D[N + n - j].  The JAX package also writes it as a
cross-correlation with the width-(2N-1) kernel kernel[kw] = D[2N-1-kw]
(:func:`conv_kernel_from_poly`), one ``lax.conv_general_dilated``; here
each conv form indexes that kernel's Toeplitz, T[j, n] = kernel[j-n+N-1],
and contracts it with an exact product.

Torch has no int32 matmul or convolution on CUDA (its one integer GEMM is
``torch._int_mm``, s8 x s8 -> s32), so the exact contractions here run on
operands small enough that every partial sum is exact.  Every function
runs the same form on the CPU and on the card:

* :func:`matmul_mod32` — any int32 operands, split into 16-bit halves,
  three float64 products (partial sums < 2^53 for contraction depths below
  2^20): :func:`negacyclic_extprod_toeplitz`,
  :func:`negacyclic_extprod_i32`, :func:`negacyclic_mul_fixed`;
* ``torch._int_mm`` — int8 digits against int8 kernel limbs, s32 sums of
  at most 2L*N terms of magnitude <= 2^14: :func:`negacyclic_extprod_i8`;
* :func:`negacyclic_mul_binary` — a binary key's Toeplitz has entries in
  {-1, 0, 1}; the other factor splits into four balanced int8 limbs, so a
  float32 product with TF32 off is exact (partial sums <= N*128 < 2^24).
"""

from __future__ import annotations

import contextlib

import torch

from ..utils.torus import TORUS, wrap_i32


# ---------------------------------------------------------------------------
# Exact matmuls.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def exact_f32_matmul():
    """Run float32 CUDA matmuls in full float32: TF32 off for the scope,
    the caller's setting restored after.  (On the CPU float32 matmuls are
    always full precision.)"""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_mod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) mod 2^32 for int32 tensors, exact on every device.

    a = a_hi*2^16 + a_lo with a_lo in [0, 2^16) (likewise b), so mod 2^32
    a@b = a_lo@b_lo + (a_hi@b_lo + a_lo@b_hi) * 2^16 — three float64
    products whose terms are below 2^32; exact for depth K < 2^20."""
    k = a.shape[-1]
    if k >= 1 << 20:
        raise ValueError(f"contraction depth {k} too deep for float64")
    a_lo = (a & 0xFFFF).to(torch.float64)
    a_hi = (a >> 16).to(torch.float64)
    b_lo = (b & 0xFFFF).to(torch.float64)
    b_hi = (b >> 16).to(torch.float64)
    lo = (a_lo @ b_lo).to(torch.int64)
    mid = (a_hi @ b_lo + a_lo @ b_hi).to(torch.int64)
    return wrap_i32(lo + ((mid & 0xFFFF) << 16))


# ---------------------------------------------------------------------------
# Limb splits.
# ---------------------------------------------------------------------------

def split_signed_limbs_i8(x: torch.Tensor, num_limbs: int) -> torch.Tensor:
    """Signed int32 -> (num_limbs, ...) int8 base-256 limbs with
    sum_i limb[i] * 2^(8i) == x exactly (no wraparound).  The first
    num_limbs-1 limbs are balanced in [-128, 127]; the last carries the
    signed remainder and must fit int8 (|x| <= 2^(8*num_limbs - 2))."""
    x = x.to(torch.int32)
    limbs = []
    for _ in range(num_limbs - 1):
        limb = ((x + 128) & 255) - 128
        limbs.append(limb.to(torch.int8))
        x = (x - limb) >> 8                        # arithmetic shift, exact
    limbs.append(x.to(torch.int8))
    return torch.stack(limbs, dim=0)


def split_balanced_limbs_i8(x: torch.Tensor, num_limbs: int = 4
                            ) -> torch.Tensor:
    """int32 words -> (num_limbs, ...) int8 balanced limbs with
    sum_i limb[i] * 2^(8i) == x (mod 2^32); the top limb wraps mod 256."""
    limbs = []
    for _ in range(num_limbs):
        limb = ((x + 128) & 255) - 128             # low byte, balanced
        limbs.append(limb.to(torch.int8))
        x = (x - limb) >> 8     # arithmetic: bits above the limb are kept
    return torch.stack(limbs, dim=0)


# ---------------------------------------------------------------------------
# Bands and Toeplitz matrices.
# ---------------------------------------------------------------------------

def _neg_ext(k: torch.Tensor) -> torch.Tensor:
    """D = concat([-K mod 2^32, K]) along the last axis."""
    return torch.cat([-k, k], dim=-1)


def conv_kernel_from_poly(k: torch.Tensor) -> torch.Tensor:
    """The width-(2N-1) correlation kernel of polynomial(s) k: (..., N)
    words -> (..., 2N-1), kernel[kw] = D[2N-1-kw] (D reversed, its unused
    D[0] dropped), so negacyclic_conv(a, k)[n] =
    sum_kw a[n + kw - (N-1)] * kernel[kw]."""
    return _neg_ext(k)[..., 1:].flip(-1)


def extprod_kernel_from_trgsw(trgsw: torch.Tensor) -> torch.Tensor:
    """TRGSW ciphertext(s) (..., 2L, 2, N) -> the external product's conv
    kernel (..., 2, 2L, 2N-1): (output channel A/B, input row, width), the
    JAX package's 'OIH' layout."""
    return conv_kernel_from_poly(trgsw).transpose(-3, -2)


def _kernel_toeplitz(kernel: torch.Tensor) -> torch.Tensor:
    """Kernel (..., 2N-1) -> (..., N, N), T[j, n] = kernel[j - n + N - 1]:
    the correlation with padding N-1 as a contraction over j."""
    n = (kernel.shape[-1] + 1) // 2
    ar = torch.arange(n, device=kernel.device)
    return kernel[..., ar[:, None] - ar[None, :] + n - 1]


def ext_band_from_trgsw(trgsw: torch.Tensor) -> torch.Tensor:
    """TRGSW ciphertext(s) (..., 2L, 2, N) -> signed D bands
    (..., 2L, 2, 2N) with D = concat([-K mod 2^32, K])."""
    return _neg_ext(trgsw)


def toeplitz_from_band(d_band: torch.Tensor) -> torch.Tensor:
    """Band (..., 2N) -> negacyclic Toeplitz (..., N, N),
    T[j, n] = D[N + n - j]."""
    n = d_band.shape[-1] // 2
    ar = torch.arange(n, device=d_band.device)
    idx = n + ar[None, :] - ar[:, None]            # (N, N), in [1, 2N-1]
    return d_band[..., idx]


def negacyclic_extprod_toeplitz(digits: torch.Tensor,
                                band: torch.Tensor) -> torch.Tensor:
    """Exact external product through a materialized Toeplitz matrix.

    digits: (..., 2L, N) int32 gadget digits (any magnitude).
    band:   (2L, 2, 2N) int32 from :func:`ext_band_from_trgsw`.
    Returns (..., 2, N) int32 words, exact mod 2^32."""
    l2, n = digits.shape[-2:]
    lead = digits.shape[:-2]
    t = toeplitz_from_band(band)                   # (2L, 2, N, N) [r,c,j,n]
    t = t.permute(0, 2, 1, 3).reshape(l2 * n, 2 * n)
    out = matmul_mod32(digits.reshape(-1, l2 * n), t)
    return out.reshape(lead + (2, n))


def negacyclic_extprod_i32(digits: torch.Tensor,
                           kernel: torch.Tensor) -> torch.Tensor:
    """The external product from the conv kernel, exact mod 2^32.

    digits: (..., 2L, N) int32 gadget digits (any magnitude).
    kernel: (2, 2L, 2N-1) int32 from :func:`extprod_kernel_from_trgsw`.
    Returns (..., 2, N) int32 words: the kernel's Toeplitz, rows (row, j)
    and columns (channel, n), through :func:`matmul_mod32`."""
    l2, n = digits.shape[-2:]
    lead = digits.shape[:-2]
    t = _kernel_toeplitz(kernel)                   # (2, 2L, N, N) [c,r,j,n]
    t = t.permute(1, 2, 0, 3).reshape(l2 * n, 2 * n)
    out = matmul_mod32(digits.reshape(-1, l2 * n), t)
    return out.reshape(lead + (2, n))


def negacyclic_extprod_i8(digits: torch.Tensor,
                          kernel: torch.Tensor) -> torch.Tensor:
    """The external product from int8 digits and int8 kernel limbs.

    digits: (..., 2L, N) int8 (half_bg <= 128).
    kernel: (4, 2, 2L, 2N-1) int8 balanced limbs of the int32 kernel
            (:func:`split_balanced_limbs_i8` of
            :func:`extprod_kernel_from_trgsw`).
    Returns (..., 2, N) int32 words.

    One ``torch._int_mm`` of the (M, 2L*N) digits against the limbs'
    Toeplitz (2L*N, 4*2*N), on the CPU and on the card alike.  Its s32 sums
    have 2L*N terms of magnitude <= 2^14, so they are exact for L*N < 2^16
    (every profile whose digits fit int8).  The card's int8 GEMM needs more
    than 16 rows and k, n multiples of 8: the rows are padded to a multiple
    of 8, at least 24 (2L*N and 8N are multiples of 8 for N >= 4).  The
    limb l output is shifted by 8*l and the four are added mod 2^32."""
    l2, n = digits.shape[-2:]
    lead = digits.shape[:-2]
    nl = kernel.shape[0]
    a = digits.reshape(-1, l2 * n)
    m = a.shape[0]
    pad = max(24, -(-m // 8) * 8) - m
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    t = _kernel_toeplitz(kernel)                   # (4, 2, 2L, N, N)
    t = t.permute(2, 3, 0, 1, 4).reshape(l2 * n, nl * 2 * n)
    out = torch._int_mm(a, t)[:m].view(m, nl, 2, n)
    acc = out[:, 0]
    for i in range(1, nl):
        acc = acc + (out[:, i] << (8 * i))
    return acc.reshape(lead + (2, n))


def negacyclic_mul_fixed(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Negacyclic product of batched polynomials with one fixed polynomial,
    exact mod 2^32 (poly/poly_mul.go:12-22).

    a: (..., N) int32 words;  k: (N,) int32 words.  The kernel's Toeplitz
    through :func:`matmul_mod32`."""
    lead = a.shape[:-1]
    n = a.shape[-1]
    t = _kernel_toeplitz(conv_kernel_from_poly(k))     # (N, N) [j, n]
    return matmul_mod32(a.reshape(-1, n), t).reshape(lead + (n,))


def negacyclic_mul_binary(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Negacyclic product with a BINARY polynomial (a ring secret key),
    exact mod 2^32.

    a: (..., N) int32 words;  key: (N,) int32 in {0, 1}.

    The key's Toeplitz has entries in {-1, 0, 1}; ``a`` splits into four
    balanced int8 limbs; each limb product runs as ONE float32 matmul with
    TF32 off (:func:`exact_f32_matmul`), whose partial sums are integers of
    magnitude <= N*128 < 2^24 and so exact; the limbs recombine mod 2^32.
    """
    lead = a.shape[:-1]
    n = a.shape[-1]
    t = toeplitz_from_band(ext_band_from_trgsw(key)).to(torch.float32)
    limbs = split_balanced_limbs_i8(a.reshape(-1, n), 4).to(torch.float32)
    with exact_f32_matmul():
        outs = (limbs @ t).to(TORUS)               # (4, M, N)
    acc = outs[0]
    for i in range(1, 4):
        acc = acc + (outs[i] << (8 * i))
    return acc.reshape(lead + (n,))
