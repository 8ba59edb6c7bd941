"""Wrapper of the hand-written flash-attention forward kernel,
``csrc/flash_fwd.cu`` (the port of ``repro/kernels/flash/kernel.py:28
_flash_fwd_kernel``).

The source is built with the ANS kernels into one extension
(``kernels/ans/kernel.py`` ``build``, bound in ``ans/csrc/bindings.cpp``;
its products are explicit ``__fmaf_rn`` calls, so the extension's
``--fmad=false`` costs it nothing) and the launch is counted in
``kernels.ans.kernel.LAUNCHES["flash_fwd"]``. CUDA tensors only: on the
CPU ``ops.flash_attention`` runs ``twin.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ans import kernel as ans_kernel


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [BH, Sq, D]; k/v [BH // G, Sk, D], contiguous, all float32 or
    all bfloat16, D <= 128 -> out [BH, Sq, D] in q's dtype.
    ``window <= 0`` disables the window."""
    return ans_kernel.launch("flash_fwd", "flash_fwd", q, k, v,
                             bool(causal), int(window))
