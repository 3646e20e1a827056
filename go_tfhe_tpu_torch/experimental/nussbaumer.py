"""Nussbaumer polynomial transform: exact sub-quadratic negacyclic
convolution mod 2^32 (port of ``go_tfhe_tpu/experimental/nussbaumer.py``).

The dense Toeplitz external product costs (2L*N) x (2*N) multiply-adds
per ciphertext per blind-rotation step, for each pair of limbs.  The
Nussbaumer transform [Nussbaumer 1980] factors the length-N negacyclic
convolution through Z[Z]/(Z^(2r)+1):

    N = m*r  (m | 2r),   S = Z[Z]/(Z^(2r)+1),   zeta = Z^(2r/m)

* split a(X) into m chunks of r coefficients (a = sum_u a_u(X) * X^(r*u)),
  embed each chunk in S (upper half zero);
* twist chunk u by zeta^u, then a length-m CYCLIC NTT over S whose
  twiddles are POWERS OF Z — negacyclic array rotations, additions only,
  no multiplications (which is what makes it work over Z_2^32, where no
  root of unity exists);
* m pointwise products in S (size-2r negacyclic convolutions, the only
  multiplications);
* unnormalized inverse NTT, untwist by zeta^(-w), overlap-add the chunks.

The products shrink by m/8 (4x at N=1024, 8x at N=2048) at the price of
O(N log m) additions and rotations.

Division by m (the inverse NTT's 1/m) does not exist mod 2^32, so it is
absorbed into the other operand: the fast profiles generate the BSK on the
2^key_grid_bits torus subgrid (params.key_grid_bits >= log2(m)), so
J = K/m is exact and

    INTT'(NTT(d) . NTT(J)) = m * INTT(...) = d (x) K   (mod 2^32, exact)

with INTT' the unnormalized inverse.  Everything below is integer
arithmetic wrapping mod 2^32, word for word the dense product's.

A measured-negative artifact: the JAX package measured it about 1:200
against its dense product on the TPU's vector unit (README.md), and kept
the dense form.  No path of the port runs it; chip_smoke.py times
:func:`extprod_nuss_ref` on the card beside the dense form.  The slot
products run through :func:`..ops.polymul.matmul_mod32` (exact), where the
JAX package runs int32 einsums that wrap.
"""

from __future__ import annotations

import torch

from ..ops.polymul import ext_band_from_trgsw, matmul_mod32, toeplitz_from_band
from ..utils.torus import shr, to_unsigned


def nuss_shape(n: int) -> tuple[int, int, int]:
    """(m, r, e) for degree n: m the largest power of two with m | 2*(n/m)
    (i.e. m <= sqrt(2n)), r = n/m chunk size, e = 2r/m the twist stride."""
    if n & (n - 1) or n < 4:
        raise ValueError(f"degree {n} is not a power of two >= 4")
    nbit = n.bit_length() - 1
    m = 1 << ((nbit + 1) // 2)
    r = n // m
    return m, r, 2 * r // m


def neg_rot(v: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by Z^k in Z[Z]/(Z^s+1) along the last axis (k a Python
    integer).  Z^s = -1: out[z] = v[z-k] for z >= k, -v[s+z-k] for z < k.
    The arithmetic negation -v of this ring, not the torus's NOT."""
    s = v.shape[-1]
    k %= 2 * s
    if k >= s:
        v = -v
        k -= s
    if k == 0:
        return v
    rolled = torch.roll(v, k, dims=-1)
    idx = torch.arange(s, device=v.device)
    return torch.where(idx < k, -rolled, rolled)


def _bitrev(m: int) -> list[int]:
    bits = m.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) for i in range(m)]


def ntt_slots(x: torch.Tensor, we: int, inverse: bool = False
              ) -> torch.Tensor:
    """Length-m cyclic NTT over S on the second-to-last axis.

    x: (..., m, s) int32;  the m-th root of unity is Z^we (we = 2e forward).
    Returns X[t] = sum_u Z^(we*t*u) x[u] (sign flipped for inverse; the
    inverse is UNNORMALIZED — m times the true INTT).  Cooley-Tukey DIT
    with monomial twiddles (additions and rotations only)."""
    m = x.shape[-2]
    x = x[..., torch.tensor(_bitrev(m), device=x.device), :]
    size = 2
    sgn = -1 if inverse else 1
    while size <= m:
        half = size // 2
        wstep = sgn * we * (m // size)
        shape = x.shape
        x = x.reshape(shape[:-2] + (m // size, size, shape[-1]))
        lo = x[..., :half, :]
        hi = torch.stack([neg_rot(x[..., half + j, :], wstep * j)
                          for j in range(half)], dim=-2)
        x = torch.cat([lo + hi, lo - hi], dim=-2).reshape(shape)
        size *= 2
    return x


def _twist(c: torch.Tensor, e: int, sign: int) -> torch.Tensor:
    """Multiply chunk u by Z^(sign*e*u); c: (..., m, 2r)."""
    m = c.shape[-2]
    return torch.stack([neg_rot(c[..., u, :], sign * e * u)
                        for u in range(m)], dim=-2)


def forward(a: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Forward Nussbaumer transform: (..., N) int32 -> (..., m, 2r) int32.
    Values grow by at most a factor of m (sums of m inputs)."""
    n = a.shape[-1] if n is None else n
    m, r, e = nuss_shape(n)
    c = a.reshape(a.shape[:-1] + (m, r))
    c = torch.cat([c, torch.zeros_like(c)], dim=-1)            # embed in S
    return ntt_slots(_twist(c, e, +1), 2 * e)


def inverse_unnormalized(c_hat: torch.Tensor, n: int) -> torch.Tensor:
    """Unnormalized inverse: (..., m, 2r) -> (..., N) int32, equal to
    m * (true inverse) mod 2^32.  Untwists and overlap-adds the chunks."""
    m, r, e = nuss_shape(n)
    c = _twist(ntt_slots(c_hat, 2 * e, inverse=True), e, -1)
    low = c[..., :, :r]
    high = c[..., :, r:]
    high = torch.cat([-high[..., -1:, :], high[..., :-1, :]], dim=-2)
    return (low + high).reshape(c.shape[:-2] + (m * r,))


# ---------------------------------------------------------------------------
# External product through the transform (reference implementation).
# ---------------------------------------------------------------------------

def bsk_nuss_hat(bsk_rows: torch.Tensor, n: int) -> torch.Tensor:
    """Keygen-side operand transform with the 1/m absorbed.

    bsk_rows: (..., N) int32 words of TRGSW row polynomials, every word
    divisible by m (on-grid keys, params.key_grid_bits >= log2 m).
    Returns (..., m, 2r) int32 = forward(K/m): K/m is the LOGICAL right
    shift of the uint32 words, exact since K is a multiple of m."""
    m, _, _ = nuss_shape(n)
    return forward(shr(bsk_rows, m.bit_length() - 1), n)


def extprod_nuss_ref(digits: torch.Tensor, bsk: torch.Tensor
                     ) -> torch.Tensor:
    """Reference Nussbaumer external product, exact mod 2^32.

    digits: (..., 2L, N) int32 gadget digits.
    bsk:    (2L, 2, N) int32 words of TRGSW rows, divisible by m.
    Returns (..., 2, N) int32 words == negacyclic_extprod_toeplitz(digits,
    band)."""
    n = digits.shape[-1]
    l2 = digits.shape[-2]
    lead = digits.shape[:-2]
    j_hat = bsk_nuss_hat(bsk, n)                       # (2L, 2, m, 2r)
    d_hat = forward(digits, n)                         # (..., 2L, m, 2r)
    m, s = d_hat.shape[-2:]
    # Slot-wise negacyclic 2r-convolutions, contracted over the 2L rows:
    # per slot t, (M, 2L*2r) @ (2L*2r, 2*2r).
    t = toeplitz_from_band(
        ext_band_from_trgsw(to_unsigned(j_hat)))       # (2L,2,m,2r,2r)
    t = t.permute(2, 0, 3, 1, 4).reshape(m, l2 * s, 2 * s)
    d = d_hat.reshape(-1, l2, m, s).permute(2, 0, 1, 3).reshape(
        m, -1, l2 * s)
    c_hat = matmul_mod32(d, t)                         # (m, M, 2*2r)
    c_hat = c_hat.reshape(m, -1, 2, s).permute(1, 2, 0, 3)  # (M, 2, m, 2r)
    out = inverse_unnormalized(c_hat, n)
    return out.reshape(lead + (2, n))


def negacyclic_mul_nuss_ref(a: torch.Tensor, k: torch.Tensor
                            ) -> torch.Tensor:
    """Single negacyclic product a (x) K via the transform (K divisible by
    m); reference for tests."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    j_hat = bsk_nuss_hat(k, n)                         # (m, 2r)
    a_hat = forward(a, n)                              # (..., m, 2r)
    m, s = a_hat.shape[-2:]
    t = toeplitz_from_band(ext_band_from_trgsw(to_unsigned(j_hat)))
    c_hat = matmul_mod32(a_hat.reshape(-1, m, s).transpose(0, 1), t)
    out = inverse_unnormalized(c_hat.transpose(0, 1), n)  # (M, m, 2r)->N
    return out.reshape(lead + (n,))
