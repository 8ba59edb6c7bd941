"""Oracle: exact SDPA with a materialized mask (port of
``repro/kernels/flash/ref.py``, over ``repro_torch.models.attention``)."""

from __future__ import annotations

import torch


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v [BH, S, D] -> [BH, Sq, D] via exact softmax attention."""
    from repro_torch.models import attention

    sq, sk = q.shape[1], k.shape[1]
    mask = attention._mask(sq, sk, causal, window if window > 0 else None,
                           device=q.device)
    out = attention.sdpa(q[:, :, None, :], k[:, :, None, :],
                         v[:, :, None, :], mask)
    return out[:, :, 0, :]
