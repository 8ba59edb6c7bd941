"""Wrapper of the hand-written flash-attention forward kernels (the port
of ``repro/kernels/flash/kernel.py:28 _flash_fwd_kernel``), in two routes
that the inputs' dtype picks (``route``):

  * ``"wgmma"`` - bfloat16, ``csrc/flash_fwd_wgmma.cu``: the tensor cores
    (wgmma) fed by TMA, in instances of 64, 128 and 192 columns (keys a
    tile: ``twin.block_k(D)``);
  * ``"simt"`` - float32, ``csrc/flash_fwd.cu``: the CUDA cores, since the
    tensor cores would run float32 as TF32; register-tiled, in instances
    of D rounded up to 32 (tiles: ``twin.simt_tiles(D)``).

Both load rows in 16-byte pieces (TMA; cp.async), so this wrapper
zero-pads q, k and v to the next multiple of 16 (wgmma) or 4 (simt)
columns when D is not one (zero columns add nothing to q . k or to the
output's kept columns), copies a tensor that is not 16-byte aligned, and
passes the true D, which sets the scale.

Both take head dims up to 192 (the largest a registered config has is
stablelm-12b's 160); the binding raises above.

Both sources are built with the ANS kernels into one extension
(``kernels/ans/kernel.py`` ``build``, bound in ``ans/csrc/bindings.cpp``,
which raises on inputs the named route does not take), and each launch
is counted in ``kernels.ans.kernel.LAUNCHES["flash_fwd"]`` and in
``LAUNCHES["flash_fwd/<route>"]``. CUDA tensors only: on the CPU
``ops.flash_attention`` runs ``twin.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ans import kernel as ans_kernel

ROUTES = ("wgmma", "simt")


def route(dtype: torch.dtype) -> str:
    """The kernel that takes inputs of ``dtype``."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "simt"
    raise ValueError(f"kernels.flash: no route takes {dtype}")


#: the route's column multiple
PAD = {"wgmma": 16, "simt": 4}


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 multiple: int = PAD["wgmma"]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v with D zero-padded to the next multiple of ``multiple``
    (unchanged when D is one)."""
    pad = -q.shape[-1] % multiple
    if not pad:
        return q, k, v
    return tuple(F.pad(t, (0, pad)) for t in (q, k, v))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied when the kernels could not read it in place
    (contiguous and 16-byte aligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [BH, Sq, D]; k/v [BH // G, Sk, D], contiguous, all float32 or
    all bfloat16, D <= 192 -> out [BH, Sq, D] in q's dtype.
    ``window <= 0`` disables the window."""
    r = route(q.dtype)
    d = q.shape[-1]
    q, k, v = (_aligned(t) for t in pad_head_dim(q, k, v, PAD[r]))
    out = ans_kernel.launch(("flash_fwd", f"flash_fwd/{r}"), "flash_fwd", q,
                            k, v, bool(causal), int(window), r, d)
    return out[..., :d] if out.shape[-1] != d else out
