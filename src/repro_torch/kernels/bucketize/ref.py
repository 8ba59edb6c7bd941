"""Oracle of the bucketize op (port of ``repro/kernels/bucketize/ref.py``):
the bisection written out over ``core.discretize``'s pointwise CDF,
evaluated where the search asks, on the committed edge table."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import discretize


def bucketize_ref(slot: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                  lat_bits: int, precision: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    f = discretize.posterior_starts_fn(mu, sigma, lat_bits, precision)
    slot = slot.to(torch.int64)
    lo = torch.zeros_like(slot)
    hi = torch.full_like(lo, 1 << lat_bits)
    for _ in range(lat_bits + 1):
        mid = (lo + hi + 1) // 2
        up = f(mid) <= slot
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    start = f(lo)
    return (lo.to(torch.int32), start.to(torch.int32),
            (f(lo + 1) - start).to(torch.int32))
