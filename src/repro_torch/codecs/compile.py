"""Codec compiler, for the fixed-point BB-ANS path (port of the parts of
``repro.codecs.compile`` that lower ``make_bb_codec_q``).

``compile(BBANS(prior, likelihood, posterior))`` with ``FixedPointFn``
children and a ``Repeat`` of ``Uniform`` prior becomes ``_FusedBBANS``:
its push and pop replay ``BBANS``'s schedule with the quantized network
in line and every multi-symbol leg on one dispatched kernel call:

  push: pop_many_grid(gaussian posterior)   -> latent buckets y
        push_many(Bernoulli pixels | y)
        push_many(uniform prior over y)
  pop:  pop_many_grid(uniform prior)        -> y
        pop_many_dyn(Bernoulli pixels | y)  -> s
        grid_starts + push_many(gaussian posterior over y | s)

``Chained`` over it becomes ``_FusedChained``, the same schedule per
datapoint. ``Shaped`` and ``Serial`` lower their children; a combinator
defined elsewhere registers its own structural lowering
(``register_lowering``: ``stream.BlockChain`` lowers its inner codec);
the single-symbol leaves stay as they are, as in the reference. The wire is identical to the interpreted codec's (both compute
the same integers; the grid CDF is ``xla_ndtr`` on either side) and to
the reference's. Unlike the reference's lowering of 1-lane stacks
(ROADMAP H2), nothing here depends on the lane count.

Any other codec raises ``NotImplementedError`` naming the ROADMAP item
that ports its lowering.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Type

import torch

from repro_torch.core import ans
from repro_torch.core.codec import Codec
from repro_torch.core.distributions import Categorical
from repro_torch.codecs import combinators as C
from repro_torch.codecs import leaves as L
from repro_torch.codecs import quantize as Q
from repro_torch.kernels.ans import ops


def _push_uniform(stack: ans.ANSStack, idxT: torch.Tensor, bits: int,
                  precision: int) -> ans.ANSStack:
    """Push bucket indices [n, lanes] under the uniform prior, positions
    n-1 .. 0 (the LIFO order of ``Repeat``)."""
    shift = precision - bits
    start = idxT.flip(0).to(torch.int32) << shift
    return ops.push_many(stack, start, torch.full_like(start, 1 << shift),
                         precision)


def _push_gaussian(stack: ans.ANSStack, idxT: torch.Tensor,
                   muT: torch.Tensor, sigmaT: torch.Tensor, bits: int,
                   precision: int) -> ans.ANSStack:
    """Push bucket indices [n, lanes] under per-position Gaussians."""
    start, freq = ops.grid_starts(idxT, muT, sigmaT, bits, precision)
    return ops.push_many(stack, start.flip(0), freq.flip(0), precision)


def _fp_push(stack: ans.ANSStack, fx: Q.FixedPointFn, ctx: Any,
             sym: torch.Tensor) -> ans.ANSStack:
    """Push ``sym`` under the codec ``fx`` parameterizes by ``ctx``."""
    flatT = sym.reshape(sym.shape[0], -1).T
    if fx.family == "gaussian":
        mu, sigma = fx.params(ctx)
        return _push_gaussian(stack, flatT, mu.T, sigma.T, fx.bits,
                              fx.precision)
    f1 = fx.params(ctx).T.to(torch.int32)                 # [n, lanes]
    f0 = (1 << fx.precision) - f1
    is1 = flatT.bool()
    start = torch.where(is1, f0, 0)
    freq = torch.where(is1, f1, f0)
    return ops.push_many(stack, start.flip(0), freq.flip(0), fx.precision)


def _fp_pop(stack: ans.ANSStack, fx: Q.FixedPointFn,
            ctx: Any) -> Tuple[ans.ANSStack, torch.Tensor]:
    """Pop a symbol under the codec ``fx`` parameterizes by ``ctx``."""
    if fx.family == "gaussian":
        mu, sigma = fx.params(ctx)
        stack, symT = ops.pop_many_grid(stack, "gaussian", mu.T, sigma.T,
                                        fx.n, fx.bits, fx.precision)
    else:
        f1 = fx.params(ctx).T.to(torch.int32)             # [n, lanes]
        total = 1 << fx.precision
        tables = torch.stack([torch.zeros_like(f1), total - f1,
                              torch.full_like(f1, total)], dim=-1)
        stack, symT = ops.pop_many_dyn(stack, tables, fx.precision)
    return stack, symT.T


class _FusedBBANS(Codec):
    """``BBANS`` with FixedPointFn children, on the fused kernels."""

    def __init__(self, prior_bits: int, prior_precision: int,
                 posterior: Q.FixedPointFn, likelihood: Q.FixedPointFn):
        self.prior_bits, self.prior_precision = prior_bits, prior_precision
        self.posterior, self.likelihood = posterior, likelihood

    def push(self, stack: ans.ANSStack, s: torch.Tensor) -> ans.ANSStack:
        post = self.posterior
        mu, sigma = post.params(s)
        stack, yT = ops.pop_many_grid(stack, "gaussian", mu.T, sigma.T,
                                      post.n, post.bits, post.precision)
        stack = _fp_push(stack, self.likelihood, yT.T, s)
        return _push_uniform(stack, yT, self.prior_bits, self.prior_precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        post = self.posterior
        stack, yT = ops.pop_many_grid(stack, "uniform", None, None, post.n,
                                      self.prior_bits, self.prior_precision)
        stack, s = _fp_pop(stack, self.likelihood, yT.T)
        mu, sigma = post.params(s)
        stack = _push_gaussian(stack, yT, mu.T, sigma.T, post.bits,
                               post.precision)
        return stack, s


class _FusedChained(Codec):
    """``Chained`` over a ``_FusedBBANS``: the fused schedule per
    datapoint, in chain order."""

    def __init__(self, inner: _FusedBBANS, n: int):
        self.inner, self.n = inner, n

    def push(self, stack: ans.ANSStack, data: torch.Tensor) -> ans.ANSStack:
        C.check_chain_length(self.n, data)
        for i in range(self.n):
            stack = self.inner.push(stack, data[i])
        return stack

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        outs = []
        for _ in range(self.n):
            stack, s = self.inner.pop(stack)
            outs.append(s)
        return stack, torch.stack(outs[::-1], dim=0)


def _uniform_prior(prior: Codec, n_lat: int) -> Optional[Tuple[int, int]]:
    """(bits, precision) when ``prior`` is a ``Repeat`` of ``n_lat``
    identical ``Uniform`` leaves (the shape the fused schedule codes)."""
    if not isinstance(prior, C.Repeat) or prior.n != n_lat or n_lat <= 0:
        return None
    leaves = [prior.codec_fn(d) for d in range(prior.n)]
    if not all(type(lf) is L.Uniform for lf in leaves):
        return None
    specs = {(lf.bits, lf.precision) for lf in leaves}
    return specs.pop() if len(specs) == 1 else None


def _lower_bbans(codec: C.BBANS) -> Optional[_FusedBBANS]:
    post, lik = codec.posterior, codec.likelihood
    if not (isinstance(post, Q.FixedPointFn)
            and isinstance(lik, Q.FixedPointFn)
            and post.family == "gaussian"):
        return None
    spec = _uniform_prior(codec.prior, post.n)
    if spec is None:
        return None
    return _FusedBBANS(spec[0], spec[1], post, lik)


#: type -> (codec, recurse) -> lowered codec, for combinators defined
#: outside this package (``stream.BlockChain`` registers itself).
_LOWERINGS: Dict[Type, Callable[[Any, Callable], Codec]] = {}

#: leaves the compiler keeps as they are (each codes one symbol per lane)
_LEAVES = (L.Uniform, L.PointwiseCDF, L.DiscretizedGaussian, Categorical)


def register_lowering(cls: Type,
                      fn: Callable[[Any, Callable], Codec]) -> None:
    """Register ``fn(codec, recurse)``, a bit-exact rewrite of a ``cls``
    codec (typically the same class over ``recurse``-lowered children)."""
    _LOWERINGS[cls] = fn


def _lower(codec: Codec) -> Codec:
    fn = _LOWERINGS.get(type(codec))
    if fn is not None:
        return fn(codec, _lower)
    if isinstance(codec, _LEAVES):
        return codec
    if isinstance(codec, C.Shaped):
        return C.Shaped(_lower(codec.inner), codec.shape)
    if isinstance(codec, C.Serial):
        return C.Serial([_lower(c) for c in codec.codecs])
    if isinstance(codec, C.BBANS):
        fused = _lower_bbans(codec)
        if fused is not None:
            return fused
    if isinstance(codec, C.Chained) and isinstance(codec.inner, C.BBANS):
        fused = _lower_bbans(codec.inner)
        if fused is not None:
            return _FusedChained(fused, codec.n)
    raise NotImplementedError(
        f"codecs.compile: lowering {type(codec).__name__} is not ported "
        "yet; this slice lowers BBANS with FixedPointFn children and a "
        "uniform prior, alone or under Chained, and the combinators and "
        "leaves around it (float-leaf Repeat, TreeCodec and BitSwap "
        "lowerings: ROADMAP queue 1, items 1a and 1c)")


class CompiledCodec(Codec):
    """A codec lowered onto the fused kernel-backed schedule: same wire
    bytes as the source codec."""

    def __init__(self, codec: Codec):
        self.source = codec
        self.lowered = _lower(codec)

    def push(self, stack: ans.ANSStack, x: Any) -> ans.ANSStack:
        return self.lowered.push(stack, x)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Any]:
        return self.lowered.pop(stack)


def compile(codec: Codec) -> CompiledCodec:
    """Compile a codec tree into its fused program (a no-op on an already
    compiled codec). Raises ``NotImplementedError`` for trees this slice
    does not lower."""
    if isinstance(codec, CompiledCodec):
        return codec
    return CompiledCodec(codec)
