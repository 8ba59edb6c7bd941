"""The ``Codec`` abstraction (port of ``repro.core.codec``).

A codec is a pair of exact LIFO inverses over an ``ans.ANSStack``::

    push(stack, x) -> stack          encode one symbol (per lane)
    pop(stack)     -> (stack, x)     decode it back

``pop(push(stack, x)) == (stack, x)`` bit for bit is the whole contract;
the combinators in ``repro_torch.codecs`` preserve it by construction.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

from repro_torch.core import ans


class Codec:
    """Base class for composable push/pop coders. Symbols carry a
    leading ``lanes`` axis."""

    def push(self, stack: ans.ANSStack, x: Any) -> ans.ANSStack:
        raise NotImplementedError

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Any]:
        raise NotImplementedError


class FnCodec(Codec):
    """Adapter: wrap a raw (push_fn, pop_fn) pair as a Codec, for codecs
    that drive Python-level model-step loops (the LM token stream).

    Example::

        inner = Uniform(4)
        codec = FnCodec(inner.push, inner.pop)   # same wire bytes
    """

    def __init__(self, push_fn: Callable, pop_fn: Callable):
        self._push = push_fn
        self._pop = pop_fn

    def push(self, stack: ans.ANSStack, x: Any) -> ans.ANSStack:
        return self._push(stack, x)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Any]:
        return self._pop(stack)
