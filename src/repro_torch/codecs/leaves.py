"""Leaf codecs over the max-entropy bucket grid (port of
``repro.codecs.leaves``): ``Uniform``, ``PointwiseCDF`` and
``DiscretizedGaussian``. The logistic leaf is not ported yet (ROADMAP
queue 1, item 2)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.core import ans, discretize
from repro_torch.core.codec import Codec


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
