"""Sample extraction: TRLWE -> TLWE at a coefficient index
(port of ``go_tfhe_tpu/ops/sample_extract.py``), to level 1 or, where the
ring degree equals lwe_n, to level 0.

    out[i] = A[k-i]          for i <= k
    out[i] = ~A[n+k-i]       for i >  k     (NOT-negation, see rotate.py)
    out[n] = B[k]
"""

from __future__ import annotations

import torch

from ..utils.torus import torus_not


def sample_extract(trlwe: torch.Tensor, k: int = 0) -> torch.Tensor:
    """trlwe: (..., 2, N) int32 words -> (..., N+1) TLWE (level 1)."""
    n = trlwe.shape[-1]
    a = trlwe[..., 0, :]
    b = trlwe[..., 1, :]
    i = torch.arange(n, device=trlwe.device)
    src = torch.remainder(k - i, n)
    gathered = a[..., src]
    out_a = torch.where(i <= k, gathered, torus_not(gathered))
    return torch.cat([out_a, b[..., k:k + 1]], dim=-1)


def sample_extract_to_lv0(trlwe: torch.Tensor, lwe_n: int, k: int = 0
                          ) -> torch.Tensor:
    """Direct TRLWE -> TLWE *level 0* extraction (SampleExtractIndex2,
    trlwe/trlwe.go:133-154): valid only when the ring degree equals the
    level-0 LWE dimension (N == lwe_n), i.e. when the ring key is the
    level-0 key.  Raises ValueError on a dimension mismatch, as the JAX
    function does (the reference panics, trlwe/trlwe.go:140-142); for
    mismatched dimensions use ``sample_extract`` + identity key switching."""
    n = trlwe.shape[-1]
    if n != lwe_n:
        raise ValueError(
            f"sample_extract_to_lv0: TRLWE degree {n} != lwe_n {lwe_n} — "
            "use sample_extract + identity_key_switch instead "
            "(trlwe/trlwe.go:140-142)")
    return sample_extract(trlwe, k)
