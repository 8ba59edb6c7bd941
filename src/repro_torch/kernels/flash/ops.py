"""Model-layout flash attention (port of ``repro/kernels/flash/ops.py``).

``flash_attention`` takes the model's ``[B, S, H, Dh]`` GQA layout, folds
(B, H) into the kernels' head axis and restores the layout.
``kernels.dispatch`` (op ``"flash"``) picks the CUDA kernel on the card
(``kernel.py``), the tile-for-tile plain version on the CPU (``twin.py``)
or exact SDPA (``ref.py``). The key/value heads are not repeated for the
kernel or the twin: query head ``h`` reads head ``h // G`` in place (the
reference's wrapper copies them with ``jnp.repeat``). The Pallas
wrapper's ``block_q``/``block_k``/``interpret`` have no counterpart: the
tiles are the kernel's own (``twin.BLOCK_Q``, ``twin.BLOCK_K``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash import kernel as K
from repro_torch.kernels.flash import ref as R
from repro_torch.kernels.flash import twin as T


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    backend: Optional[str] = None) -> torch.Tensor:
    """q [B, Sq, Hq, Dh]; k/v [B, Sk, Hkv, Dh] -> [B, Sq, Hq, Dh] in q's
    dtype. ``window <= 0`` disables the sliding window."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    name = dispatch.resolve("flash", q.device, backend)
    qf = q.transpose(1, 2).reshape(b * hq, sq, dh)
    kf = k.transpose(1, 2).reshape(b * hkv, sk, dh)
    vf = v.transpose(1, 2).reshape(b * hkv, sk, dh)
    if name == "ref":
        g = hq // hkv
        kf = kf.repeat_interleave(g, dim=0)
        vf = vf.repeat_interleave(g, dim=0)
        out = R.flash_ref(qf, kf, vf, causal=causal, window=window)
    else:
        fwd = K.flash_fwd if name == "cuda" else T.flash_fwd
        out = fwd(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                  causal=causal, window=window)
    return out.reshape(b, hq, sq, dh).transpose(1, 2)
