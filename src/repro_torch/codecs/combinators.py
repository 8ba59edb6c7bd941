"""Codec combinators (port of ``repro.codecs.combinators``): ``Serial``,
``Repeat``, ``Shaped``, ``TreeCodec``, ``Chained``, ``BBANS`` and
``BitSwap``. Each preserves the push/pop inverse contract: a composite pop
runs the component pops in the reverse order of the pushes.

JAX traces ``Repeat``/``Chained`` into ``lax`` loops; here they are
Python loops (PyTorch runs eagerly), with the same symbol order.
``TreeCodec`` visits its leaves in ``jax.tree_util``'s order (dict keys
sorted, lists and tuples by position, ``None`` empty) through the small
flattener below: another order would write other bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Sequence, Tuple

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


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and tuples in
    ``jax.tree_util`` order: dict values by sorted key, sequences by
    position, ``None`` holding none."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree: Any, leaves: Iterator[Any]) -> Any:
    """``tree``'s structure with its leaves replaced, in ``tree_leaves``
    order, by the next items of ``leaves``."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_unflatten(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def flatten_up_to(tree: Any, x: Any) -> list:
    """The subtrees of ``x`` at the leaf positions of ``tree``, in
    ``tree_leaves`` order; raises when ``x`` lacks ``tree``'s structure."""
    if isinstance(tree, dict):
        if not isinstance(x, dict) or set(x) != set(tree):
            raise ValueError(f"TreeCodec: symbols {x!r:.80} do not match "
                             f"the codec keys {sorted(tree)}")
        return [v for k in sorted(tree) for v in flatten_up_to(tree[k], x[k])]
    if isinstance(tree, (list, tuple)):
        if not isinstance(x, (list, tuple)) or len(x) != len(tree):
            raise ValueError(f"TreeCodec: symbols {x!r:.80} do not match "
                             f"a codec sequence of {len(tree)}")
        return [v for t, xi in zip(tree, x) for v in flatten_up_to(t, xi)]
    return [] if tree is None else [x]


@dataclasses.dataclass(frozen=True)
class TreeCodec(Codec):
    """A tree of codecs (dicts, lists, tuples) over a matching tree of
    symbols; leaves push in reverse ``tree_leaves`` order, so pops return
    them in order."""

    tree: Any

    def push(self, stack: ans.ANSStack, x: Any) -> ans.ANSStack:
        pairs = list(zip(tree_leaves(self.tree), flatten_up_to(self.tree, x)))
        for codec, xi in reversed(pairs):
            stack = codec.push(stack, xi)
        return stack

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Any]:
        out = []
        for codec in tree_leaves(self.tree):
            stack, xi = codec.pop(stack)
            out.append(xi)
        return stack, tree_unflatten(self.tree, iter(out))


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


@dataclasses.dataclass(frozen=True)
class BitSwap(Codec):
    """Hierarchical bits back with interleaved pops and pushes (Bit-Swap,
    Kingma, Abbeel & Ho, 2019) over a Markov chain s <- z_1 <- ... <- z_L.

    ``layers`` is bottom-up ``(posterior_fn, likelihood_fn)`` pairs: layer
    l's context is the variable below it (``s`` for l = 1), which
    ``posterior_fn(ctx)`` codes ``z_l`` under and ``likelihood_fn(z_l)``
    codes the context under; ``prior`` codes ``z_L``. Popping z_l and at
    once pushing the level below bounds the clean bits needed by one
    layer's posterior. With one layer this is ``BBANS``.
    """

    prior: Codec
    layers: Tuple[Tuple[Callable[[Any], Codec], Callable[[Any], Codec]], ...]

    def push(self, stack: ans.ANSStack, s: Any) -> ans.ANSStack:
        ctx = s
        for posterior_fn, likelihood_fn in self.layers:
            stack, z = posterior_fn(ctx).pop(stack)
            stack = likelihood_fn(z).push(stack, ctx)
            ctx = z
        return self.prior.push(stack, ctx)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Any]:
        stack, z = self.prior.pop(stack)
        for posterior_fn, likelihood_fn in reversed(self.layers):
            stack, ctx = likelihood_fn(z).pop(stack)
            stack = posterior_fn(ctx).push(stack, z)
            z = ctx
        return stack, z
