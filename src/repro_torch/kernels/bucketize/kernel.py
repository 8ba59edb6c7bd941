"""Wrapper of the hand-written bucketize kernel, ``csrc/bucketize.cu``
(the port of ``repro/kernels/bucketize/kernel.py:37 _bucketize_kernel``).

The source is built with the ANS kernels into one extension
(``kernels/ans/kernel.py`` ``build``, bound in ``ans/csrc/bindings.cpp``)
and the launch is counted in ``kernels.ans.kernel.LAUNCHES["bucketize"]``.
CUDA tensors only: on the CPU ``ops.bucketize`` runs ``twin.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ans import kernel as ans_kernel


def bucketize(slot: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
              edges: torch.Tensor, lat_bits: int, precision: int):
    """slot int32[L]; mu, sigma float32[L]; edges float32[K+1] -> (idx,
    start, freq) int32[L]."""
    return ans_kernel.launch("bucketize", "bucketize", slot, mu, sigma,
                             edges, lat_bits, precision)
