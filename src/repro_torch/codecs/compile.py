"""Codec compiler (port of ``repro.codecs.compile``): lower a ``Codec``
tree onto the kernel-backed multi-step ops, with the same wire bytes.

``Repeat`` nodes are probed - ``codec_fn`` is called for the positions -
and when the leaves are a known family with stackable parameters they
collapse into one vectorized node (``_lower_repeat``):

  * ``Uniform`` / ``DiscretizedGaussian`` / ``DiscretizedLogistic`` ->
    ``_GridRepeat``: encode computes all [n, lanes] (start, freq) pairs
    at once (``ops.grid_starts``) and makes one ``push_many`` call;
    decode is one fused bisection + pop (``ops.pop_many_grid``);
  * ``Bernoulli`` / ``Categorical`` -> ``_TableRepeat``: per-position
    cumulative-starts tables, one ``push_many`` / ``pop_many_dyn`` call.

A ``Repeat`` of any other body (heterogeneous, opaque, another leaf
family) stays interpreted, as in the reference. The tables and grid
parameters of a lowered node are the leaves' own elementwise arithmetic
over the whole grid, so the bits are those of the per-position leaves.

``BBANS`` with ``FixedPointFn`` children and a ``Repeat`` of ``Uniform``
prior becomes ``_FusedBBANS`` (the quantized network in line with every
multi-symbol leg on one dispatched call):

  push: pop_many_grid(gaussian posterior)   -> latent buckets y
        push_many(Bernoulli pixels | y)
        push_many(uniform prior over y)
  pop:  pop_many_grid(uniform prior)        -> y
        pop_many_dyn(Bernoulli pixels | y)  -> s
        grid_starts + push_many(gaussian posterior over y | s)

``BitSwap`` whose layers are all ``FixedPointFn`` pairs (Gaussian
posteriors) over the same prior becomes ``_FusedBitSwap``, the same legs
per layer in Bit-Swap's interleaved order (the fixed-point HVAE).
``Chained`` over either becomes ``_FusedChained``. Any other ``BBANS`` or
``BitSwap`` (the float VAE and HVAE) keeps its networks eager and lowers
the children they return at each call; ``Chained`` over it stays a Python
loop. A ``Repeat`` of the HVAE's ``KernelDiscretizedGaussian`` lowers as
a Gaussian ``_GridRepeat`` (families match by ``isinstance``), as in the
reference. ``Shaped``, ``Serial`` and ``TreeCodec`` lower their children;
a combinator defined elsewhere registers its own structural lowering
(``register_lowering``: ``stream.BlockChain`` lowers its inner codec);
single-symbol leaves stay as they are. Unlike the reference's lowering of
1-lane stacks (ROADMAP H2), nothing here depends on the lane count.

A codec type the compiler does not know raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import torch

from repro_torch.core import ans
from repro_torch.core.codec import Codec
from repro_torch.core.distributions import (Bernoulli, Categorical,
                                            _stable_softmax,
                                            bernoulli_freq1)
from repro_torch.codecs import combinators as C
from repro_torch.codecs import leaves as L
from repro_torch.codecs import quantize as Q
from repro_torch.kernels.ans import ops


def _push_grid(stack: ans.ANSStack, kind: str, idxT: torch.Tensor,
               muT: Optional[torch.Tensor], sigmaT: Optional[torch.Tensor],
               bits: int, precision: int) -> ans.ANSStack:
    """Push bucket indices [n, lanes] under the ``uniform`` prior or
    per-position ``gaussian`` / ``logistic`` leaves, positions n-1 .. 0
    (the LIFO order of ``Repeat``)."""
    if kind == "uniform":
        shift = precision - bits
        start = idxT.flip(0).to(torch.int32) << shift
        return ops.push_many(stack, start, torch.full_like(start, 1 << shift),
                             precision)
    start, freq = ops.grid_starts(idxT, muT, sigmaT, bits, precision,
                                  kind=kind)
    return ops.push_many(stack, start.flip(0), freq.flip(0), precision)


def _fp_push(stack: ans.ANSStack, fx: Q.FixedPointFn, ctx: Any,
             sym: torch.Tensor) -> ans.ANSStack:
    """Push ``sym`` under the codec ``fx`` parameterizes by ``ctx``."""
    flatT = sym.reshape(sym.shape[0], -1).T
    if fx.family == "gaussian":
        mu, sigma = fx.params(ctx)
        return _push_grid(stack, "gaussian", flatT, mu.T, sigma.T, fx.bits,
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
    sym = symT.T
    if fx.shape:
        sym = sym.reshape((sym.shape[0],) + tuple(fx.shape))
    return stack, sym


@dataclasses.dataclass(frozen=True)
class _GridRepeat(Codec):
    """A ``Repeat`` of grid leaves, fused. ``kind``: ``uniform`` (mu and
    sigma unused), ``gaussian`` (mu, sigma) or ``logistic`` (sigma
    carries the scale); parameters float32[n, lanes] in position order.
    Push codes positions n-1 .. 0 (the LIFO order of ``Repeat``), pop
    returns them in order, row-major [lanes, n] as ``Repeat`` does."""

    kind: str
    mu: Optional[torch.Tensor]
    sigma: Optional[torch.Tensor]
    n: int
    bits: int
    precision: int

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        return _push_grid(stack, self.kind, x.to(torch.int32).T, self.mu,
                          self.sigma, self.bits, self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        stack, symT = ops.pop_many_grid(stack, self.kind, self.mu,
                                        self.sigma, self.n, self.bits,
                                        self.precision)
        return stack, symT.T.contiguous()


@dataclasses.dataclass(frozen=True)
class _TableRepeat(Codec):
    """A ``Repeat`` of table leaves, fused: ``tables`` int32[n, lanes,
    A+1] per-position cumulative starts in position order; one
    ``push_many`` / ``pop_many_dyn`` call each way."""

    tables: torch.Tensor
    precision: int

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        sym = x.to(torch.int64).T[..., None]             # [n, lanes, 1]
        start = self.tables.gather(2, sym)[..., 0]
        nxt = self.tables.gather(2, sym + 1)[..., 0]
        return ops.push_many(stack, start.flip(0), (nxt - start).flip(0),
                             self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        stack, symT = ops.pop_many_dyn(stack, self.tables, self.precision)
        return stack, symT.T.contiguous()


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
        return _push_grid(stack, "uniform", yT, None, None, self.prior_bits,
                          self.prior_precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        post = self.posterior
        stack, yT = ops.pop_many_grid(stack, "uniform", None, None, post.n,
                                      self.prior_bits, self.prior_precision)
        stack, s = _fp_pop(stack, self.likelihood, yT.T)
        mu, sigma = post.params(s)
        stack = _push_grid(stack, "gaussian", yT, mu.T, sigma.T, post.bits,
                           post.precision)
        return stack, s


class _FusedBitSwap(Codec):
    """``BitSwap`` with FixedPointFn layers, on the fused kernels: per
    layer, bottom-up, pop_many_grid(gaussian posterior | context) then the
    context's push under the layer's likelihood; then the uniform prior
    over the top latent. Pop runs it backwards."""

    def __init__(self, prior_bits: int, prior_precision: int, n_lat: int,
                 layers: Tuple[Tuple[Q.FixedPointFn, Q.FixedPointFn], ...]):
        self.prior_bits, self.prior_precision = prior_bits, prior_precision
        self.n_lat, self.layers = n_lat, layers

    def push(self, stack: ans.ANSStack, s: torch.Tensor) -> ans.ANSStack:
        ctx = s
        for post, lik in self.layers:
            mu, sigma = post.params(ctx)
            stack, zT = ops.pop_many_grid(stack, "gaussian", mu.T, sigma.T,
                                          post.n, post.bits, post.precision)
            stack = _fp_push(stack, lik, zT.T, ctx)
            ctx = zT.T
        return _push_grid(stack, "uniform", ctx.T, None, None,
                          self.prior_bits, self.prior_precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        stack, zT = ops.pop_many_grid(stack, "uniform", None, None,
                                      self.n_lat, self.prior_bits,
                                      self.prior_precision)
        z = zT.T
        for post, lik in reversed(self.layers):
            stack, ctx = _fp_pop(stack, lik, z)
            mu, sigma = post.params(ctx)
            stack = _push_grid(stack, "gaussian", z.T, mu.T, sigma.T,
                               post.bits, post.precision)
            z = ctx
        return stack, z


class _FusedChained(Codec):
    """``Chained`` over a ``_FusedBBANS`` or ``_FusedBitSwap``: the fused
    schedule per datapoint, in chain order."""

    def __init__(self, inner: Codec, n: int):
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


def _lower_fused_bbans(codec: C.BBANS) -> Optional[_FusedBBANS]:
    post, lik = codec.posterior, codec.likelihood
    if not (isinstance(post, Q.FixedPointFn)
            and isinstance(lik, Q.FixedPointFn)
            and post.family == "gaussian"):
        return None
    spec = _uniform_prior(codec.prior, post.n)
    if spec is None:
        return None
    return _FusedBBANS(spec[0], spec[1], post, lik)


def _lower_fused_bitswap(codec: C.BitSwap) -> Optional[_FusedBitSwap]:
    layers = codec.layers
    if not layers or not all(
            isinstance(p, Q.FixedPointFn) and isinstance(lk, Q.FixedPointFn)
            and p.family == "gaussian" for p, lk in layers):
        return None
    n_lat = layers[-1][0].n
    spec = _uniform_prior(codec.prior, n_lat)
    if spec is None:
        return None
    return _FusedBitSwap(spec[0], spec[1], n_lat, tuple(layers))


#: leaf family -> (tensor parameter fields, static fields); isinstance
#: order, most derived first.
_FAMILIES = (
    (L.Uniform, (), ("bits", "precision")),
    (L.DiscretizedGaussian, ("mu", "sigma"), ("bits", "precision")),
    (L.DiscretizedLogistic, ("mu", "scale"), ("bits", "precision")),
    (Bernoulli, ("logits",), ("precision",)),
    (Categorical, ("logits",), ("precision",)),
)

#: what a probe of a position may raise when ``codec_fn`` does not take a
#: tensor of positions or a position does not exist
_PROBE_ERRORS = (TypeError, IndexError, ValueError, RuntimeError)


def _statics(leaf: Codec, names) -> tuple:
    return tuple(getattr(leaf, s) for s in names)


def _probe_params(rep: C.Repeat, leaf0: Codec, fields,
                  statics) -> Optional[List[torch.Tensor]]:
    """The per-position leaf parameters stacked to [n, lanes, ...], or
    None when the positions do not share a family and static fields (or
    a parameter is not a tensor).

    Fast path: ``codec_fn`` called once with ``arange(n)`` (elementwise
    closures such as ``mu[:, d]`` then return the whole [lanes, n] grid
    at once), checked against positions {0, n//2, n-1} probed one by one,
    in a single read from the device. Otherwise every position is probed.
    """
    n = rep.n
    first = [getattr(leaf0, name) for name in fields]
    if not all(isinstance(t, torch.Tensor) for t in first):
        return None
    device = first[0].device if first else None
    try:
        vec = rep.codec_fn(torch.arange(n, device=device))
    except _PROBE_ERRORS:
        vec = None
    out: Optional[List[torch.Tensor]] = None
    if type(vec) is type(leaf0) \
            and _statics(vec, statics) == _statics(leaf0, statics):
        out = []
        for name, t0 in zip(fields, first):
            vv = getattr(vec, name)
            want = tuple(t0.shape[:1]) + (n,) + tuple(t0.shape[1:])
            if not isinstance(vv, torch.Tensor) or tuple(vv.shape) != want:
                out = None
                break
            out.append(torch.movedim(vv, 1, 0))
    if out is not None:
        checks = []
        for d in sorted({0, n // 2, n - 1}):
            lf = rep.codec_fn(d)
            if type(lf) is not type(leaf0) or \
                    _statics(lf, statics) != _statics(leaf0, statics):
                out = None
                break
            checks += [(arr[d] == getattr(lf, nm)).all()
                       for nm, arr in zip(fields, out)]
        if out is not None and (not checks or bool(torch.stack(checks)
                                                   .all())):
            return out
    leaves = [rep.codec_fn(d) for d in range(n)]
    if not all(type(lf) is type(leaf0) for lf in leaves):
        return None
    if len({_statics(lf, statics) for lf in leaves}) != 1:
        return None
    return [torch.stack([getattr(lf, nm) for lf in leaves]) for nm in fields]


def _validate_tables(tables: torch.Tensor, precision: int,
                     what: str) -> None:
    """Frequency soundness of lowered tables (exact span, monotone
    starts, no zero-mass symbol), read from the device once, so a broken
    table fails here naming the subtree, not as a mismatch at decode."""
    total = 1 << precision
    d = tables[..., 1:] - tables[..., :-1]
    span, down, zero = torch.stack([
        (tables[..., 0] != 0).any() | (tables[..., -1] != total).any(),
        (d < 0).any(), (d < 1).any()]).tolist()
    if span:
        raise ValueError(
            f"codecs.compile: contract violation (freq-sum) in {what}: "
            f"the table does not span exactly [0, 2^{precision}]")
    if down:
        raise ValueError(
            f"codecs.compile: contract violation (starts-monotone) in "
            f"{what}: cumulative starts decrease")
    if zero:
        raise ValueError(
            f"codecs.compile: contract violation (freq-zero) in {what}: "
            "a symbol has zero frequency and would decode to a "
            "neighbour silently")


def _validate_grid_params(mu: torch.Tensor, sigma: torch.Tensor,
                          names: Tuple[str, str], what: str) -> None:
    """Finite parameters and a strictly positive scale, read once."""
    bad_mu, bad_sigma, nonpos = torch.stack([
        ~torch.isfinite(mu).all(), ~torch.isfinite(sigma).all(),
        (sigma <= 0).any()]).tolist()
    for bad, name in ((bad_mu, names[0]), (bad_sigma, names[1])):
        if bad:
            raise ValueError(
                f"codecs.compile: contract violation (starts-monotone) in "
                f"{what}: non-finite {name}")
    if nonpos:
        raise ValueError(
            f"codecs.compile: contract violation (starts-monotone) in "
            f"{what}: {names[1]} must be strictly positive (a non-positive "
            "scale flips the CDF and breaks the decode bisection)")


def _lower_repeat(rep: C.Repeat) -> Optional[Codec]:
    """The fused node of a ``Repeat`` whose leaves are a known family, or
    None (the caller keeps the interpreted ``Repeat``)."""
    if rep.n <= 0:
        return None
    try:
        leaf0 = rep.codec_fn(0)
    except _PROBE_ERRORS:
        return None
    family = next(((cls, fields, statics)
                   for cls, fields, statics in _FAMILIES
                   if isinstance(leaf0, cls)), None)
    if family is None:
        return None
    cls, fields, statics = family
    params = _probe_params(rep, leaf0, fields, statics)
    if params is None:
        return None
    what = f"Repeat[{cls.__name__}, n={rep.n}]"
    if cls is L.Uniform:
        return _GridRepeat("uniform", None, None, rep.n, leaf0.bits,
                           leaf0.precision)
    if cls in (L.DiscretizedGaussian, L.DiscretizedLogistic):
        mu, sigma = (p.to(torch.float32).contiguous() for p in params)
        _validate_grid_params(mu, sigma, fields, what)
        kind = "gaussian" if cls is L.DiscretizedGaussian else "logistic"
        return _GridRepeat(kind, mu, sigma, rep.n, leaf0.bits,
                           leaf0.precision)
    # Table families: the leaves' own elementwise arithmetic over the
    # whole [n, lanes] grid, so the bits are the per-position leaves'.
    if cls is Bernoulli:
        total = 1 << leaf0.precision
        f1 = bernoulli_freq1(params[0], leaf0.precision)
        tables = torch.stack([torch.zeros_like(f1), total - f1,
                              torch.full_like(f1, total)], dim=-1)
    else:
        tables = ans.probs_to_starts(
            _stable_softmax(params[0].to(torch.float32)), leaf0.precision)
    _validate_tables(tables, leaf0.precision, what)
    return _TableRepeat(tables.to(torch.int32).contiguous(), leaf0.precision)


#: type -> (codec, recurse) -> lowered codec, for combinators defined
#: outside this package (``stream.BlockChain`` registers itself).
_LOWERINGS: Dict[Type, Callable[[Any, Callable], Codec]] = {}

#: leaves the compiler keeps as they are (each codes one symbol per lane)
_LEAVES = (L.Uniform, L.PointwiseCDF, L.DiscretizedGaussian,
           L.DiscretizedLogistic, Bernoulli, Categorical, Q.LutBernoulli,
           _GridRepeat, _TableRepeat)


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
    if isinstance(codec, CompiledCodec):
        return codec.lowered
    if isinstance(codec, C.Repeat):
        return _lower_repeat(codec) or codec
    if isinstance(codec, C.Shaped):
        return C.Shaped(_lower(codec.inner), codec.shape)
    if isinstance(codec, C.Serial):
        return C.Serial([_lower(c) for c in codec.codecs])
    if isinstance(codec, C.TreeCodec):
        leaves = iter([_lower(c) for c in C.tree_leaves(codec.tree)])
        return C.TreeCodec(C.tree_unflatten(codec.tree, leaves))
    if isinstance(codec, C.Chained):
        inner = _lower(codec.inner)
        if isinstance(inner, (_FusedBBANS, _FusedBitSwap)):
            return _FusedChained(inner, codec.n)
        # Not fused: the chain stays a loop over datapoints, each lowering
        # its networks' leaves at call time.
        return C.Chained(inner, codec.n)
    if isinstance(codec, C.BBANS):
        fused = _lower_fused_bbans(codec)
        if fused is not None:
            return fused
        lik, post = codec.likelihood, codec.posterior
        return C.BBANS(prior=_lower(codec.prior),
                       likelihood=lambda y: _lower(lik(y)),
                       posterior=lambda s: _lower(post(s)))
    if isinstance(codec, C.BitSwap):
        fused = _lower_fused_bitswap(codec)
        if fused is not None:
            return fused
        layers = tuple((lambda ctx, _p=p: _lower(_p(ctx)),
                        lambda z, _l=lk: _lower(_l(z)))
                       for p, lk in codec.layers)
        return C.BitSwap(prior=_lower(codec.prior), layers=layers)
    raise NotImplementedError(
        f"codecs.compile: cannot lower {type(codec).__name__}; the "
        "compiler lowers Repeat, Shaped, Serial, TreeCodec, Chained, "
        "BBANS, BitSwap, the leaves, and the combinators registered with "
        "register_lowering")


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
    compiled codec). Raises ``NotImplementedError`` for a codec type the
    compiler does not know."""
    if isinstance(codec, CompiledCodec):
        return codec
    return CompiledCodec(codec)
