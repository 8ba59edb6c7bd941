"""Backend choice for the coder kernels: cuda / torch / ref.

Every op in ``kernels/ans/ops.py``, and ``"bucketize"``
(``kernels/bucketize/ops.py``), has three bit-identical versions:

  * ``"cuda"``  - the hand-written CUDA kernel (``kernels/*/kernel.py``);
                  runs on CUDA tensors only;
  * ``"torch"`` - the plain PyTorch version (``kernels/*/twin.py``), the
                  CPU path;
  * ``"ref"``   - the per-step oracle (``kernels/*/ref.py``).

``resolve(op, device, backend)`` picks one with the reference's
precedence (``repro/kernels/dispatch.py:129``): an explicit ``backend=``,
then the ``REPRO_TORCH_KERNEL_BACKEND`` environment variable, then the
innermost ``with use_backend(...)``, then the tensors' device (``cuda``
on the card, ``torch`` on the CPU). The variable is the port's own: the
reference reads ``REPRO_KERNEL_BACKEND`` with other values
(``pallas``/``xla``/``interpret``), and one process - or a subprocess
that inherits the environment - may run both packages, so neither may
read the other's setting. The device decides what may run:
asking for ``"cuda"`` with CPU tensors raises, and so does asking for a
plain version with CUDA tensors - on the card a wrapper launches its
kernel or fails. (The reference's tuning cache is not ported.)
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, Optional

import torch

BACKENDS = ("cuda", "torch", "ref")

#: the environment variable that pins a backend for the whole process
ENV_BACKEND = "REPRO_TORCH_KERNEL_BACKEND"


class _ContextStack(threading.local):
    def __init__(self) -> None:
        self.stack: list = []


_CONTEXT = _ContextStack()


def _check(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(
            f"kernels.dispatch: unknown backend {name!r} (expected one of "
            f"{BACKENDS})")
    return name


@contextlib.contextmanager
def use_backend(backend: str) -> Iterator[str]:
    """Pin a backend for every dispatched op in the ``with`` body unless
    a call passes ``backend=``. Nests; innermost wins; per thread."""
    _CONTEXT.stack.append(_check(backend))
    try:
        yield backend
    finally:
        _CONTEXT.stack.pop()


def resolve(op: str, device: torch.device,
            backend: Optional[str] = None) -> str:
    """The backend ``op`` runs on for tensors on ``device``."""
    name = backend or os.environ.get(ENV_BACKEND) or \
        (_CONTEXT.stack[-1] if _CONTEXT.stack else None) or \
        ("cuda" if device.type == "cuda" else "torch")
    _check(name)
    if name == "cuda" and device.type != "cuda":
        raise RuntimeError(
            f"kernels.dispatch: {op} asked for the cuda backend, but its "
            f"tensors are on {device}")
    if name != "cuda" and device.type == "cuda":
        raise RuntimeError(
            f"kernels.dispatch: {op} asked for the {name!r} backend with "
            "CUDA tensors; on the card only the kernel runs (move the "
            "tensors to the CPU for the plain versions)")
    return name
