"""Plain PyTorch version of the bucketize kernel (the port of
``repro/kernels/bucketize/xla.py``): the CPU path of ``ops.bucketize``
and what ``chip_smoke.py`` holds the kernel to on the card.

``F`` is ``core/discretize``'s ``posterior_starts_fn`` (on
``core/xla_ndtr``, bit-identical to the kernel's ``ndtr.cuh``) over the
edge table it is given, and the search is ``discretize.bisect``. uint32
values are carried in int64 (H5: torch's CPU ``uint32`` lacks the ops);
every value here stays below 2^17, so no masking is needed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.discretize import (bisect, posterior_starts_fn,
                                         tabled_starts)


def bucketize(slot: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
              edges: torch.Tensor, lat_bits: int, precision: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """slot int32[L]; mu, sigma float32[L]; edges float32[K+1] -> (idx,
    start, freq) int32[L], any lane count."""
    f = tabled_starts(posterior_starts_fn, mu, sigma, lat_bits, precision,
                      edges)
    idx = bisect(f, slot.to(torch.int64), lat_bits)
    start = f(idx)
    return (idx.to(torch.int32), start.to(torch.int32),
            (f(idx + 1) - start).to(torch.int32))
