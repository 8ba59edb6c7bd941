"""Maximum-entropy discretization of continuous latents (paper App. B),
ported from ``repro.core.discretize``.

The latent axis is cut into ``K = 2^lat_bits`` buckets of equal mass
under N(0, 1): edges ``z_i = ndtri(i / K)``, centres
``c_i = ndtri((i + 0.5) / K)``. The prior codes uniformly; a Gaussian
posterior codes with the pointwise fixed-point CDF

    F(i) = floor((2^prec - K) * ndtr((z_i - mu) * (1 / sigma))) + i

and decodes by a ``lat_bits + 1``-step bisection.

The edge and centre tables are the reference's own float32 arrays,
committed in ``grid_tables.npz`` (``tests/golden/make_torch_fixtures.py``
writes them from ``repro.core.discretize``): recomputing them differs on
84 of 1025 entries with ``torch.special.ndtri`` and on 404 with scipy's
float64 rounded to float32. ``ndtr`` is ``xla_ndtr.ndtr``, XLA's float32
sequence, because ``torch.special.ndtr`` flips about 0.3% of starts.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core import ans
from repro_torch.core.xla_ndtr import ndtr

TABLES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "grid_tables.npz")


@functools.lru_cache(maxsize=None)
def _tables() -> dict:
    with np.load(TABLES_PATH) as z:
        return {k: z[k] for k in z.files}


def _table(kind: str, lat_bits: int) -> np.ndarray:
    name = f"{kind}_{lat_bits}"
    tables = _tables()
    if name not in tables:
        have = sorted(int(k.split("_")[1]) for k in tables
                      if k.startswith(kind))
        raise ValueError(
            f"discretize: no committed {kind} table for lat_bits="
            f"{lat_bits} (have {have}); regenerate with "
            "tests/golden/make_torch_fixtures.py")
    return tables[name]


@functools.lru_cache(maxsize=None)
def _on(kind: str, lat_bits: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_table(kind, lat_bits).copy()).to(device)


def edge_table(lat_bits: int, device: dev.DeviceLike = None) -> torch.Tensor:
    """z[i] = Phi^-1(i/K), i = 0..K, float32[K+1] (the reference's bits)."""
    return _on("edges", lat_bits, dev.resolve(device))


def centre_table(lat_bits: int, device: dev.DeviceLike = None) -> torch.Tensor:
    """c[i] = Phi^-1((i+0.5)/K), i = 0..K-1, float32[K]."""
    return _on("centres", lat_bits, dev.resolve(device))


def bucket_edge(i: torch.Tensor, lat_bits: int) -> torch.Tensor:
    k = 1 << lat_bits
    return edge_table(lat_bits, i.device)[torch.clamp(i.long(), 0, k)]


def bucket_centre(i: torch.Tensor, lat_bits: int) -> torch.Tensor:
    k = 1 << lat_bits
    return centre_table(lat_bits, i.device)[torch.clamp(i.long(), 0, k - 1)]


def _posterior_cdf(i: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                   edges: torch.Tensor, lat_bits: int) -> torch.Tensor:
    """Phi((z_i - mu) * (1/sigma)), exactly 0 at i <= 0 and 1 at i >= K."""
    k = 1 << lat_bits
    z = edges[torch.clamp(i.long(), 0, k)]
    c = ndtr((z - mu) * torch.reciprocal(sigma))
    c = torch.where(i <= 0, torch.zeros_like(c), c)
    return torch.where(i >= k, torch.ones_like(c), c)


def posterior_starts_fn(mu: torch.Tensor, sigma: torch.Tensor,
                        lat_bits: int, precision: int,
                        edges: Optional[torch.Tensor] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pointwise fixed-point CDF ``F(i)`` (int64) of a diag-Gaussian
    posterior over the prior buckets. ``edges`` defaults to the committed
    edge table; the kernels' plain versions pass the table they are
    given."""
    k = 1 << lat_bits
    scale = float((1 << precision) - k)
    if scale <= 0:
        raise ValueError("need precision > lat_bits")
    mu = mu.float()
    sigma = sigma.float()
    if edges is None:
        edges = edge_table(lat_bits, mu.device)

    def f(i: torch.Tensor) -> torch.Tensor:
        c = _posterior_cdf(i, mu, sigma, edges, lat_bits)
        return torch.floor(c * scale).to(torch.int64) + i.to(torch.int64)

    return f


def push_posterior(stack: ans.ANSStack, idx: torch.Tensor, mu: torch.Tensor,
                   sigma: torch.Tensor, lat_bits: int,
                   precision: int = ans.DEFAULT_PRECISION) -> ans.ANSStack:
    """Encode bucket indices (one per lane) under Q(y|s)."""
    f = posterior_starts_fn(mu, sigma, lat_bits, precision)
    idx = idx.to(torch.int64)
    start = f(idx)
    return ans.push(stack, start, f(idx + 1) - start, precision)


def bisect(f: Callable[[torch.Tensor], torch.Tensor], slot: torch.Tensor,
           bits: int) -> torch.Tensor:
    """Largest ``i`` in ``[0, 2^bits)`` with ``f(i) <= slot``: the
    reference's ``bits + 1`` halvings, mid = (lo + hi + 1) // 2."""
    lo = torch.zeros_like(slot)
    hi = torch.full_like(slot, 1 << bits)
    for _ in range(bits + 1):
        mid = (lo + hi + 1) // 2
        up = f(mid) <= slot
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return lo


def pop_posterior(stack: ans.ANSStack, mu: torch.Tensor, sigma: torch.Tensor,
                  lat_bits: int, precision: int = ans.DEFAULT_PRECISION
                  ) -> Tuple[ans.ANSStack, torch.Tensor]:
    """Decode bucket indices under Q(y|s): a sample from the discretized
    posterior drawn with stack bits."""
    f = posterior_starts_fn(mu, sigma, lat_bits, precision)
    idx = bisect(f, ans.peek(stack, precision), lat_bits)
    start = f(idx)
    stack = ans.pop_update(stack, start, f(idx + 1) - start, precision)
    return stack, idx.to(torch.int32)


def push_prior(stack: ans.ANSStack, idx: torch.Tensor, lat_bits: int,
               precision: int = ans.DEFAULT_PRECISION) -> ans.ANSStack:
    """Encode bucket indices under the prior: an exact uniform code."""
    shift = precision - lat_bits
    if shift < 0:
        raise ValueError("need precision >= lat_bits")
    start = idx.to(torch.int64) << shift
    return ans.push(stack, start, torch.full_like(start, 1 << shift),
                    precision)


def pop_prior(stack: ans.ANSStack, lat_bits: int,
              precision: int = ans.DEFAULT_PRECISION
              ) -> Tuple[ans.ANSStack, torch.Tensor]:
    """Decode bucket indices under the prior."""
    shift = precision - lat_bits
    idx = ans.peek(stack, precision) >> shift
    start = idx << shift
    stack = ans.pop_update(stack, start, torch.full_like(start, 1 << shift),
                           precision)
    return stack, idx.to(torch.int32)
