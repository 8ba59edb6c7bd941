"""Leaf codecs over the max-entropy bucket grid (port of
``repro.codecs.leaves``): ``Uniform``, ``PointwiseCDF``,
``DiscretizedGaussian`` and ``DiscretizedLogistic``. The logistic CDF is
``xla_ndtr.sigmoid_f32``, XLA-CPU's float32 sigmoid op for op, so its
fixed-point starts are the reference's, bit for bit."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import ans, discretize
from repro_torch.core.codec import Codec
from repro_torch.core.xla_ndtr import sigmoid_f32


@dataclasses.dataclass(frozen=True)
class Uniform(Codec):
    """Exact ``bits``-bit uniform code over {0 .. 2^bits - 1} per lane."""

    bits: int
    precision: int = ans.DEFAULT_PRECISION

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        return discretize.push_prior(stack, x, self.bits, self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        return discretize.pop_prior(stack, self.bits, self.precision)


@dataclasses.dataclass(frozen=True)
class PointwiseCDF(Codec):
    """Codec over {0 .. 2^bits - 1} from a pointwise float CDF.

    ``cdf_fn(i)`` maps int64 bucket indices to float cumulative mass; the
    fixed-point table is ``floor((2^precision - 2^bits) * cdf(i)) + i``
    (clipped to [0, 1], pinned at both ends), decoded by bisection.
    """

    cdf_fn: Callable[[torch.Tensor], torch.Tensor]
    bits: int
    precision: int = ans.DEFAULT_PRECISION

    def _starts(self) -> Callable[[torch.Tensor], torch.Tensor]:
        k = 1 << self.bits
        scale = float((1 << self.precision) - k)
        if scale <= 0:
            raise ValueError("need precision > bits")
        cdf_fn = self.cdf_fn

        def f(i: torch.Tensor) -> torch.Tensor:
            c = torch.clamp(cdf_fn(i), 0.0, 1.0)
            c = torch.where(i <= 0, torch.zeros_like(c), c)
            c = torch.where(i >= k, torch.ones_like(c), c)
            return torch.floor(c * scale).to(torch.int64) + i.to(torch.int64)

        return f

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        f = self._starts()
        x = x.to(torch.int64)
        start = f(x)
        return ans.push(stack, start, f(x + 1) - start, self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        f = self._starts()
        idx = discretize.bisect(f, ans.peek(stack, self.precision),
                                self.bits)
        start = f(idx)
        stack = ans.pop_update(stack, start, f(idx + 1) - start,
                               self.precision)
        return stack, idx.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class DiscretizedGaussian(Codec):
    """N(mu, sigma^2) over the N(0,1)-prior buckets: the posterior leaf
    (``core.discretize.push_posterior``/``pop_posterior``)."""

    mu: torch.Tensor     # float32[lanes]
    sigma: torch.Tensor  # float32[lanes]
    bits: int
    precision: int = ans.DEFAULT_PRECISION

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        return discretize.push_posterior(stack, x, self.mu, self.sigma,
                                         self.bits, self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        return discretize.pop_posterior(stack, self.mu, self.sigma,
                                        self.bits, self.precision)


def _logistic_cdf(i: torch.Tensor, mu: torch.Tensor, scale: torch.Tensor,
                  bits: int,
                  edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sigmoid((z_i - mu) * (1 / scale))`` with exact 0 / 1 at i <= 0 /
    i >= K; broadcasts over leading axes (the compiler evaluates it on
    whole [n, lanes] grids, the leaf per position). ``edges`` defaults to
    the committed edge table."""
    k = 1 << bits
    if edges is None:
        edges = discretize.edge_table(bits, i.device)
    z = edges[torch.clamp(i.long(), 0, k)]
    # The reciprocal-multiply form of the reference (bit-stable in every
    # compilation context there).
    c = sigmoid_f32((z - mu) * torch.reciprocal(scale))
    c = torch.where(i <= 0, torch.zeros_like(c), c)
    return torch.where(i >= k, torch.ones_like(c), c)


def logistic_starts_fn(mu: torch.Tensor, scale: torch.Tensor, bits: int,
                       precision: int,
                       edges: Optional[torch.Tensor] = None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pointwise fixed-point starts ``F(i)`` (int64) of
    ``DiscretizedLogistic``: ``PointwiseCDF._starts``'s clip, saturation
    and floor over the logistic CDF, shared by the leaf, the compiled
    ``Repeat`` and the kernels' plain versions."""
    k = 1 << bits
    scale_fp = float((1 << precision) - k)
    if scale_fp <= 0:
        raise ValueError("need precision > bits")
    mu = mu.float()
    scale = scale.float()

    def f(i: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(_logistic_cdf(i, mu, scale, bits, edges), 0.0, 1.0)
        c = torch.where(i <= 0, torch.zeros_like(c), c)
        c = torch.where(i >= k, torch.ones_like(c), c)
        return torch.floor(c * scale_fp).to(torch.int64) + i.to(torch.int64)

    return f


@dataclasses.dataclass(frozen=True)
class DiscretizedLogistic(Codec):
    """Logistic(mu, scale) over the N(0,1)-prior buckets; pushes and pops
    are ``PointwiseCDF``'s over ``logistic_starts_fn``."""

    mu: torch.Tensor     # float32[lanes]
    scale: torch.Tensor  # float32[lanes]
    bits: int
    precision: int = ans.DEFAULT_PRECISION

    def _starts(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return logistic_starts_fn(self.mu, self.scale, self.bits,
                                  self.precision)

    def push(self, stack: ans.ANSStack, x: torch.Tensor) -> ans.ANSStack:
        f = self._starts()
        x = x.to(torch.int64)
        start = f(x)
        return ans.push(stack, start, f(x + 1) - start, self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        f = self._starts()
        idx = discretize.bisect(f, ans.peek(stack, self.precision),
                                self.bits)
        start = f(idx)
        stack = ans.pop_update(stack, start, f(idx + 1) - start,
                               self.precision)
        return stack, idx.to(torch.int32)
