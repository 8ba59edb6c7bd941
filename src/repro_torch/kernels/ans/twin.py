"""Plain PyTorch versions of the ANS kernels (the port of
``repro/kernels/ans/xla.py``).

Each function takes and returns what its CUDA kernel in ``kernel.py``
takes and returns - heads int64[lanes] holding uint32 values, int32
per-step arrays, float32 grid parameters - and computes the same
integers: the loop bodies follow ``repro/kernels/ans/kernel.py``
expression for expression, in int64 masked to 32 bits (H5: torch's CPU
``uint32`` lacks the ops). The grid CDF is ``core/discretize``'s
``posterior_starts_fn``, on ``core/xla_ndtr``, so it is bit-identical to
the kernels' ``ndtr.cuh``; the logistic CDF is ``codecs/leaves``'
``logistic_starts_fn``, on ``xla_ndtr.sigmoid_f32``, bit-identical to
``xla_math.cuh``.

These are the CPU path of ``ops.py`` and the oracle ``chip_smoke.py``
holds the kernels to; nothing on the card's main path calls them.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core import ans
from repro_torch.core.discretize import (bisect, posterior_starts_fn,
                                         tabled_starts)
from repro_torch.codecs.leaves import logistic_starts_fn

GRID_KINDS = ("gaussian", "logistic", "uniform")

_M32 = ans.MASK32


def push_emit(head: torch.Tensor, starts: torch.Tensor, freqs: torch.Tensor,
              precision: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """head [L]; starts/freqs [S, L] -> (head, chunks, need) with
    chunks/need int32[S, L]."""
    steps = starts.shape[0]
    h = head.to(torch.int64)
    starts, freqs = starts.to(torch.int64), freqs.to(torch.int64)
    chunks = torch.zeros(starts.shape, dtype=torch.int32, device=h.device)
    need = torch.zeros_like(chunks)
    for t in range(steps):
        freq = freqs[t]
        n = h >= ((freq << (32 - precision)) & _M32)
        chunks[t] = torch.where(n, h & ans.MASK16, 0).to(torch.int32)
        need[t] = n.to(torch.int32)
        h = torch.where(n, h >> 16, h)
        h = (((h // freq) << precision) + h % freq + starts[t]) & _M32
    return h, chunks, need


def _read(h: torch.Tensor, r: torch.Tensor, feed: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked renormalization read: when head < 2^16 shift in the
    lane's next feed chunk."""
    need = h < ans.RANS_L
    chunk = feed.gather(0, r[None, :])[0].to(torch.int64)
    h = torch.where(need, ((h << 16) | chunk) & _M32, h)
    return h, r + need.to(torch.int64)


def pop_slots(head: torch.Tensor, precision: int) -> torch.Tensor:
    """The decode slot per lane: head [L] -> int32[L] ``head & (2^p - 1)``
    (``repro/kernels/ans/kernel.py:92 _peek_kernel``)."""
    return (head.to(torch.int64) & ((1 << precision) - 1)).to(torch.int32)


def _pop_table_step(h: torch.Tensor, table: torch.Tensor, precision: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One branchless table pop (before the read): ``sym = #(F <= slot)
    - 1``, ``start = max F <= slot``, ``next = min F > slot``; table
    int64[L, A+1] -> (head, sym int32[L])."""
    total = 1 << precision
    slot = h & (total - 1)
    le = table <= slot[:, None]
    sym = (le.sum(dim=1) - 1).to(torch.int32)
    start = torch.where(le, table, 0).amax(dim=1)
    nxt = torch.where(le, total, table).amin(dim=1)
    return ((nxt - start) * (h >> precision) + slot - start) & _M32, sym


def pop_table_emit(head: torch.Tensor, table: torch.Tensor,
                   feed: torch.Tensor, precision: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """head [L]; one static table [L, A+1]; feed [S, L] -> (head,
    syms int32[S, L], reads int32[L])."""
    h = head.to(torch.int64)
    table = table.to(torch.int64)
    r = torch.zeros_like(h)
    syms = torch.zeros(feed.shape, dtype=torch.int32, device=h.device)
    for t in range(feed.shape[0]):
        h, syms[t] = _pop_table_step(h, table, precision)
        h, r = _read(h, r, feed)
    return h, syms, r.to(torch.int32)


def pop_dyntable_emit(head: torch.Tensor, tables: torch.Tensor,
                      feed: torch.Tensor, precision: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """head [L]; tables [S, L, A+1]; feed [S, L] -> (head, syms int32[S, L],
    reads int32[L])."""
    h = head.to(torch.int64)
    tables = tables.to(torch.int64)
    r = torch.zeros_like(h)
    syms = torch.zeros(feed.shape, dtype=torch.int32, device=h.device)
    for t in range(feed.shape[0]):
        h, syms[t] = _pop_table_step(h, tables[t], precision)
        h, r = _read(h, r, feed)
    return h, syms, r.to(torch.int32)


def check_kind(kind: str) -> None:
    if kind not in GRID_KINDS:
        raise ValueError(
            f"kernels.ans: unknown grid kind {kind!r} (expected one of "
            f"{GRID_KINDS})")


def pop_grid_emit(head: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                  feed: torch.Tensor, edges: torch.Tensor, kind: str,
                  lat_bits: int, precision: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused bucketize + pop. head [L]; mu/sigma float32[S, L] (ignored
    for ``uniform``; sigma is the scale of ``logistic``); feed [S, L];
    edges float32[K+1] -> (head, idx int32[S, L], reads int32[L])."""
    check_kind(kind)
    steps = feed.shape[0]
    shift = precision - lat_bits
    h = head.to(torch.int64)
    r = torch.zeros_like(h)
    idxs = torch.zeros(feed.shape, dtype=torch.int32, device=h.device)
    for t in range(steps):
        slot = h & ((1 << precision) - 1)
        if kind == "uniform":
            idx = slot >> shift
            start = idx << shift
            freq = torch.full_like(start, 1 << shift)
        else:
            f = tabled_starts(cdf_starts_fn(kind), mu[t], sigma[t],
                              lat_bits, precision, edges)
            idx = bisect(f, slot, lat_bits)
            start = f(idx)
            freq = f(idx + 1) - start
        idxs[t] = idx.to(torch.int32)
        h = (freq * (h >> precision) + slot - start) & _M32
        h, r = _read(h, r, feed)
    return h, idxs, r.to(torch.int32)


def cdf_starts_fn(kind: str) -> Callable:
    """The pointwise starts builder of a CDF grid kind."""
    return logistic_starts_fn if kind == "logistic" else posterior_starts_fn


def grid_starts(idx: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                edges: torch.Tensor, lat_bits: int, precision: int,
                kind: str = "gaussian"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Push-side starts of the ``gaussian`` or ``logistic`` grid: (start,
    freq) int32, elementwise."""
    f = cdf_starts_fn(kind)(mu, sigma, lat_bits, precision, edges)
    i = idx.to(torch.int64)
    start = f(i)
    return start.to(torch.int32), (f(i + 1) - start).to(torch.int32)
