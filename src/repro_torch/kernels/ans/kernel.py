"""The hand-written CUDA kernels of the ANS coder and of the posterior
bucketize, and their loader.

Seven kernels, one source each (``csrc/`` here, ``../bucketize/csrc/``),
all one thread per lane with the step loop inside the thread (the Pallas
``fori_loop``):

  * ``push_emit``         - ``repro/kernels/ans/kernel.py:35 _push_kernel``;
  * ``pop_slots``         - ``kernel.py:92 _peek_kernel``;
  * ``pop_table_emit``    - ``kernel.py:120 _pop_table_kernel`` (one static
                            table per lane);
  * ``pop_dyntable_emit`` - ``kernel.py:196 _pop_dyntable_kernel``;
  * ``pop_grid_emit``     - ``kernel.py:266 _pop_grid_kernel`` (kinds
                            ``gaussian``, ``logistic`` and ``uniform``);
  * ``grid_starts``       - the push side's Gaussian and logistic starts,
                            XLA code in the reference
                            (``codecs/compile.py:97-118``, ``:357``); a
                            kernel here so that encoder and decoder share
                            ``common/ndtr.cuh`` and ``common/xla_math.cuh``;
  * ``bucketize``         - ``repro/kernels/bucketize/kernel.py:37
                            _bucketize_kernel`` (one bisection and no pop;
                            its wrapper is ``kernels/bucketize/kernel.py``).

Build: ``torch.utils.cpp_extension.load`` compiles the seven sources and
``csrc/bindings.cpp`` (typed ``torch::Tensor`` entry points that check
their tensors, hold a device guard, allocate the outputs and launch on
PyTorch's current stream) into one extension on first use, into
``build/kernels/`` of the checkout; ninja compiles the sources in
parallel and rebuilds only what changed. The flags keep the float
arithmetic IEEE and uncontracted (``--fmad=false -prec-div=true
-ftz=false``, no fast math), which the bit-exact CDF needs. Each wrapper
here counts its launch in ``LAUNCHES``. A build or launch failure
raises: nothing falls back to the plain versions (``twin.py``).
"""

from __future__ import annotations

import os
from typing import Dict

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_KERNELS = os.path.dirname(_HERE)
_COMMON = os.path.join(_KERNELS, "common")

#: ``build/kernels`` of the checkout that holds ``src/repro_torch``
BUILD_DIR = os.path.normpath(
    os.path.join(_HERE, "..", "..", "..", "..", "build", "kernels"))

#: kernel name -> source file, relative to ``repro_torch/kernels``
SOURCES = {
    "push_emit": "ans/csrc/push.cu",
    "pop_slots": "ans/csrc/peek.cu",
    "pop_table_emit": "ans/csrc/pop_table.cu",
    "pop_dyntable_emit": "ans/csrc/pop_dyntable.cu",
    "pop_grid_emit": "ans/csrc/pop_grid.cu",
    "grid_starts": "ans/csrc/grid_starts.cu",
    "bucketize": "bucketize/csrc/bucketize.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "--fmad=false",
              "-prec-div=true", "-ftz=false", "-O3"]

#: launches per kernel (the grid pop and starts per kind) since
#: ``reset_launches()``
LAUNCHES: Dict[str, int] = {
    "push_emit": 0, "pop_slots": 0, "pop_table_emit": 0,
    "pop_dyntable_emit": 0, "pop_grid_emit/gaussian": 0,
    "pop_grid_emit/logistic": 0, "pop_grid_emit/uniform": 0,
    "grid_starts/gaussian": 0, "grid_starts/logistic": 0, "bucketize": 0}

_EXT = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build():
    """Build the extension if it is not built yet, and load it. Raises
    with the compiler's output when a build fails."""
    global _EXT
    if _EXT is None:
        from torch.utils import cpp_extension

        os.makedirs(BUILD_DIR, exist_ok=True)
        _EXT = cpp_extension.load(
            name="repro_torch_ans_kernels",
            sources=[os.path.join(_KERNELS, f) for f in
                     ("ans/csrc/bindings.cpp", *SOURCES.values())],
            extra_cflags=["-O2"], extra_cuda_cflags=NVCC_FLAGS,
            extra_include_paths=[_COMMON], build_directory=BUILD_DIR)
    return _EXT


def launch(counter: str, fn: str, head: torch.Tensor, *args):
    """Call extension function ``fn`` on ``head`` (its first tensor, which
    sets the card and, when empty, means no launch) and ``args``; count
    the launch under ``counter``."""
    if head.device.type != "cuda":
        raise ValueError(f"kernels: the kernels take CUDA tensors, got "
                         f"{head.device}")
    out = getattr(build(), fn)(head, *args)
    if head.numel():
        LAUNCHES[counter] += 1
    return out if isinstance(out, torch.Tensor) else tuple(out)


def push_emit(head: torch.Tensor, starts: torch.Tensor, freqs: torch.Tensor,
              precision: int):
    """head int64[L]; starts/freqs int32[S, L] -> (head int64[L], chunks
    int32[S, L], need int32[S, L])."""
    return launch("push_emit", "push_emit", head, starts, freqs,
                  precision)


def pop_slots(head: torch.Tensor, precision: int) -> torch.Tensor:
    """head int64[L] -> slots int32[L] = head & (2^precision - 1)."""
    return launch("pop_slots", "pop_slots", head, precision)


def pop_table_emit(head: torch.Tensor, table: torch.Tensor,
                   feed: torch.Tensor, precision: int):
    """head int64[L]; table int32[L, A+1]; feed int32[S, L] -> (head,
    syms int32[S, L], reads int32[L])."""
    return launch("pop_table_emit", "pop_table_emit", head, table, feed,
                  precision)


def pop_dyntable_emit(head: torch.Tensor, tables: torch.Tensor,
                      feed: torch.Tensor, precision: int):
    """head int64[L]; tables int32[S, L, A+1]; feed int32[S, L] -> (head,
    syms int32[S, L], reads int32[L])."""
    return launch("pop_dyntable_emit", "pop_dyntable_emit", head, tables,
                  feed, precision)


def pop_grid_emit(head: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                  feed: torch.Tensor, edges: torch.Tensor, kind: str,
                  lat_bits: int, precision: int):
    """head int64[L]; mu/sigma float32[S, L] (unused for ``uniform``;
    sigma is the ``logistic`` scale); feed int32[S, L]; edges
    float32[K+1] -> (head, idx int32[S, L], reads int32[L])."""
    from repro_torch.kernels.ans.twin import check_kind

    check_kind(kind)
    if kind == "uniform":
        return launch("pop_grid_emit/uniform", "pop_grid_uniform", head,
                      feed, lat_bits, precision)
    return launch(f"pop_grid_emit/{kind}", "pop_grid_cdf", head, mu, sigma,
                  feed, edges, kind, lat_bits, precision)


def grid_starts(idx: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                edges: torch.Tensor, lat_bits: int, precision: int,
                kind: str = "gaussian"):
    """idx int32[S, L]; mu/sigma float32[S, L]; edges float32[K+1]; kind
    ``gaussian`` or ``logistic`` -> (start int32[S, L], freq
    int32[S, L])."""
    return launch(f"grid_starts/{kind}", "grid_starts", idx, mu, sigma,
                  edges, kind, lat_bits, precision)
