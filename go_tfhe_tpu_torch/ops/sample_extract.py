"""Sample extraction: TRLWE -> TLWE at a coefficient index
(port of ``go_tfhe_tpu/ops/sample_extract.py``).

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
