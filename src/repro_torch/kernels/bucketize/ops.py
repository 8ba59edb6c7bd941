"""The dispatched posterior-decode bucketize (port of
``repro/kernels/bucketize/ops.py``).

``bucketize(slot, mu, sigma, lat_bits, precision)`` finds, per lane, the
bucket ``idx = max{i : F(i) <= slot}`` of the fixed-point Gaussian CDF
``F(i) = floor(ndtr((z_i - mu) * (1/sigma)) * (2^p - K)) + i`` and returns
``(idx, F(idx), F(idx+1) - F(idx))``: what ``DiscretizedGaussian.pop``
computes before its state update, in one call. ``kernels.dispatch``
(op ``"bucketize"``) picks the CUDA kernel on the card (``kernel.py``),
the plain PyTorch version on the CPU (``twin.py``) or the oracle
(``ref.py``); all three give the same integers at any lane count (the
reference pads to 128-lane tiles for Pallas; nothing here does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import discretize
from repro_torch.kernels import dispatch
from repro_torch.kernels.bucketize import kernel as K
from repro_torch.kernels.bucketize import ref as R
from repro_torch.kernels.bucketize import twin as T


def bucketize(slot: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
              lat_bits: int, precision: int,
              backend: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """slot int[lanes] in [0, 2^precision); mu, sigma float[lanes] ->
    (idx, start, freq), each int32[lanes] (start and freq are the
    reference's uint32 values, all below 2^16 + 1)."""
    name = dispatch.resolve("bucketize", slot.device, backend)
    if name == "ref":
        return R.bucketize_ref(slot, mu, sigma, lat_bits, precision)
    emit = K.bucketize if name == "cuda" else T.bucketize
    return emit(slot.to(torch.int32).contiguous(),
                mu.to(torch.float32).contiguous(),
                sigma.to(torch.float32).contiguous(),
                discretize.edge_table(lat_bits, slot.device), lat_bits,
                precision)
