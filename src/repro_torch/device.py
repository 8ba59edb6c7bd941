"""Where the port's entry points run.

Every public entry point takes ``device=``. Left out, it means the card:
the port is written for CUDA, and a caller without one has to say
``device="cpu"`` to get the plain PyTorch path (the tests do). It never
drops to the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when ``None`` is given and no CUDA device
    is visible.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is visible; pass "
                "device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (tensor, numpy array or nested lists) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a card it goes through
    pinned memory with a non-blocking copy: a copy from pageable memory
    would synchronize the stream, and the coder's pushes must not wait
    for the device."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
