"""Codec combinators (port of ``repro.codecs.combinators``): ``Serial``,
``Repeat``, ``Shaped``, ``Chained`` and ``BBANS``. Each preserves the
push/pop inverse contract: a composite pop runs the component pops in the
reverse order of the pushes. ``TreeCodec`` and ``BitSwap`` are not ported
yet (ROADMAP queue 1, item 3).

JAX traces ``Repeat``/``Chained`` into ``lax`` loops; here they are
Python loops (PyTorch runs eagerly), with the same symbol order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

import torch

from repro_torch.core import ans
from repro_torch.core.codec import Codec


@dataclasses.dataclass(frozen=True)
class Serial(Codec):
    """A tuple of codecs over a tuple of symbols; pushes run in reverse so
    pops return natural order."""

    codecs: Tuple[Codec, ...]

    def __init__(self, codecs: Sequence[Codec]):
        object.__setattr__(self, "codecs", tuple(codecs))

    def push(self, stack: ans.ANSStack, x: Sequence[Any]) -> ans.ANSStack:
        if len(x) != len(self.codecs):
            raise ValueError(f"Serial: {len(self.codecs)} codecs, "
                             f"{len(x)} symbols")
        for codec, xi in reversed(list(zip(self.codecs, x))):
            stack = codec.push(stack, xi)
        return stack

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Tuple]:
        out = []
        for codec in self.codecs:
            stack, xi = codec.pop(stack)
            out.append(xi)
        return stack, tuple(out)


@dataclasses.dataclass(frozen=True)
class Repeat(Codec):
    """A [lanes, n] array, one position at a time: ``codec_fn(d)`` is the
    leaf for position ``d``. Pushes run n-1 .. 0, pops 0 .. n-1."""

    codec_fn: Callable[[int], Codec]
    n: int

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        for d in reversed(range(self.n)):
            stack = self.codec_fn(d).push(stack, x[:, d])
        return stack

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        cols = []
        for d in range(self.n):
            stack, v = self.codec_fn(d).pop(stack)
            cols.append(v)
        return stack, torch.stack(cols, dim=1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Shaped(Codec):
    """Present a codec over flat [lanes, k] symbols as [lanes, *shape]."""

    inner: Codec
    shape: Tuple[int, ...]

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        return self.inner.push(stack, x.reshape(x.shape[0], -1))

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        stack, flat = self.inner.pop(stack)
        return stack, flat.reshape((flat.shape[0],) + tuple(self.shape))


def check_chain_length(n: int, data: torch.Tensor) -> None:
    if data.shape[0] != n:
        raise ValueError(
            f"Chained(n={n}): data leading axis is {data.shape[0]} - a "
            "mismatch would silently code the wrong number of datapoints")


@dataclasses.dataclass(frozen=True)
class Chained(Codec):
    """The BB-ANS chain (paper section 2.3) over a leading [n, ...] axis:
    datapoint t's compressed stack is datapoint t+1's extra information.
    Decode pops in reverse and returns natural order."""

    inner: Codec
    n: int

    def push(self, stack: ans.ANSStack, data: torch.Tensor) -> ans.ANSStack:
        check_chain_length(self.n, data)
        for i in range(self.n):
            stack = self.inner.push(stack, data[i])
        return stack

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        outs = []
        for _ in range(self.n):
            stack, s = self.inner.pop(stack)
            outs.append(s)
        return stack, torch.stack(outs[::-1], dim=0)


@dataclasses.dataclass(frozen=True)
class BBANS(Codec):
    """Bits back with ANS (paper Table 1): ``push`` pops y ~ Q(y|s),
    pushes s ~ p(s|y), then pushes y ~ p(y); ``pop`` inverts it."""

    prior: Codec
    likelihood: Callable[[Any], Codec]
    posterior: Callable[[Any], Codec]

    def push(self, stack: ans.ANSStack, s: Any) -> ans.ANSStack:
        stack, y = self.posterior(s).pop(stack)
        stack = self.likelihood(y).push(stack, s)
        return self.prior.push(stack, y)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Any]:
        stack, y = self.prior.pop(stack)
        stack, s = self.likelihood(y).pop(stack)
        stack = self.posterior(s).push(stack, y)
        return stack, s
