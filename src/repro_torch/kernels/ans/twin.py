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

import numpy as np
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


def push_reciprocal(freq: np.ndarray) -> np.ndarray:
    """The push kernel's reciprocal of each ``freq`` (``csrc/push.cu``
    ``reciprocal``), step for step in uint32 words: ``ceil(2^64 / freq)``
    as uint64 for ``2 <= freq <= 2^16``, 0 for ``freq`` 1."""
    d = np.asarray(freq, np.uint64)
    safe = np.maximum(d, np.uint64(2))
    q1 = np.uint64(_M32) // safe
    r1 = (np.uint64(_M32) - q1 * safe + np.uint64(1)) & np.uint64(_M32)
    whole = r1 == safe
    q1 = np.where(whole, q1 + np.uint64(1), q1)
    r1 = np.where(whole, np.uint64(0), r1)
    rr = r1 * r1
    m = (q1 << np.uint64(32)) + r1 * q1 + rr // safe + \
        (rr % safe != 0).astype(np.uint64)
    return np.where(d <= 1, np.uint64(0), m)


def divmod_by_reciprocal(x: np.ndarray, freq: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``(x // freq, x % freq)`` for uint32 ``x`` and ``1 <= freq <=
    2^16`` as the push kernel forms them, without a divide on the head's
    chain: ``q = floor(x m / 2^64)`` from two 32-bit products with ``m =
    push_reciprocal(freq)``, and ``r = x - q freq``. For ``freq`` 1 (``m =
    0``) the kernel adds ``x << precision`` itself, the quotient ``x``.
    Used by no path: the tests hold it to ``//`` and ``%``."""
    x = np.asarray(x, np.uint64)
    d = np.asarray(freq, np.uint64)
    m = push_reciprocal(d)
    lo = (x * (m & np.uint64(_M32))) >> np.uint64(32)
    q = (x * (m >> np.uint64(32)) + lo) >> np.uint64(32)
    q = np.where(d == 1, x, q)
    return q, x - q * d


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


#: the widest row the table-pop kernel stages whole, and the stride of
#: the sample it stages of wider rows (``csrc/pop_table.cu`` ``STAGED_A1``,
#: ``SAMPLE``)
TABLE_STAGED_A1, TABLE_SAMPLE = 4097, 16


def table_group_walk(table: torch.Tensor, slot: torch.Tensor,
                     precision: int, group: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The table-pop kernel's search (``csrc/pop_table.cu``) round for
    round: ``group`` threads a lane (8, 16 or 32; which one the kernel's
    launcher takes is its own choice, by width and lane count) walk
    the row, or above ``TABLE_STAGED_A1`` entries its every
    ``TABLE_SAMPLE``-th entry: a top round of ``group`` probes ``s0 =
    ceil(m / group)`` apart, a probe round ``ceil(s0 / group)`` apart when
    ``s0 > group - 1``, each moving to the sub-interval that
    ``popc(ballot(F <= slot)) - 1`` names, then a window of ``group``
    consecutive entries (the whole row, without the rounds above, when it
    has at most ``group - 1``); a sampled row ends with a window over the
    row's entries from the sample's block. Entries past the row read
    2^precision. table [L, A+1] (non-decreasing rows), slot [L] -> (c =
    #(F <= slot), start, next) int64[L], start and next as the kernel's
    shuffles give them (lane ``c - 1`` or 0, lane ``c`` modulo the
    group). Raises for rows that need more rounds (more than (group -
    1) group^2 entries walked), and for sampled rows at groups of 16 or
    fewer (the last window must hold a block of 16 and the entry after).
    Used by no path: the tests hold it to ``pop_table_emit``'s search
    and, through pops, to the reference's kernel."""
    a1 = table.shape[1]
    g = group
    total = 1 << precision
    table = table.to(torch.int64)
    slot = slot.to(torch.int64)[:, None]
    lanes = torch.arange(g, device=table.device)
    rows = table[:, ::TABLE_SAMPLE] if a1 > TABLE_STAGED_A1 else table
    m = rows.shape[1]
    if a1 > TABLE_STAGED_A1 and g <= TABLE_SAMPLE:
        raise ValueError(f"kernels.ans: a sampled row's last window takes "
                         f"more than {TABLE_SAMPLE} threads, got {g}")

    def at(row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        n = row.shape[1]
        got = row.gather(1, pos.clamp(0, max(n - 1, 0))) if n else \
            torch.zeros_like(pos)
        return torch.where(pos < n, got, total)

    def count(v: torch.Tensor) -> torch.Tensor:
        return (v <= slot).sum(1)

    lo = torch.zeros(table.shape[0], dtype=torch.int64, device=table.device)
    if m > g - 1:
        s0 = -(-m // g)
        top = at(rows, (lanes * s0).expand(len(lo), g))
        lo = (count(top) - 1).clamp(min=0) * s0
        if s0 > g - 1:
            s1 = -(-s0 // g)
            if s1 > g - 1:
                raise ValueError(f"kernels.ans: a walk of {g} threads "
                                 f"takes at most {(g - 1) * g * g} "
                                 f"entries, got {m}")
            lo = lo + (count(at(rows, lo[:, None] + lanes * s1)) - 1) \
                .clamp(min=0) * s1
    v = at(rows, lo[:, None] + lanes)
    cnt = count(v)
    if a1 > TABLE_STAGED_A1:
        lo = (lo + cnt - 1).clamp(min=0) * TABLE_SAMPLE
        v = at(table, lo[:, None] + lanes)
        cnt = count(v)
    below = v.gather(1, (cnt - 1).clamp(min=0)[:, None])[:, 0]
    start = torch.where(cnt > 0, below, 0)
    nxt = v.gather(1, (cnt % g)[:, None])[:, 0]
    return lo + cnt, start, nxt


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


def _reached(up: torch.Tensor, levels: int) -> torch.Tensor:
    """The leaf that ``levels`` halvings of a grid of 2^levels points
    reach, found as ``common/group_walk.cuh`` finds it: the one leaf x
    each of whose probed points has the bit x's path needs (bit i of x:
    up at the level that probes x's top bits then a one). ``up`` [L,
    points] bool -> int64[L]."""
    hit = []
    for x in range(1 << levels):
        ok = torch.ones(up.shape[0], dtype=torch.bool, device=up.device)
        for i in range(levels - 1, -1, -1):
            point = ((x >> (i + 1)) << (i + 1)) | (1 << i)
            ok &= up[:, point] == bool((x >> i) & 1)
        hit.append(ok)
    return torch.stack(hit, 1).to(torch.int64).argmax(1)


def _answered(up: torch.Tensor, m: int) -> torch.Tensor:
    """The last round's answer over points 0 .. 2^m + 1: m halvings reach
    a, then the last one moves up to a + 1 when point a + 1 is up."""
    a = _reached(up, m)
    return a + up.gather(1, (a + 1)[:, None])[:, 0].to(torch.int64)


#: the top-round levels by group width of the grid pop kernel (``csrc/
#: pop_grid.cu`` ``Shape``) and the bucketize kernel (``../bucketize/
#: csrc/bucketize.cu`` ``Walk``)
GROUP_TOP_LEVELS = {32: 6, 16: 3}


def grid_tree_walk(f: Callable[[torch.Tensor], torch.Tensor],
                   slot: torch.Tensor, bits: int, group: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grid pop and bucketize kernels' bisection (``csrc/pop_grid.cu``,
    ``../bucketize/csrc/bucketize.cu``, ``common/group_walk.cuh``) round
    for round: a top round of the tree's top ``GROUP_TOP_LEVELS[group]``
    levels (the grid pop's helper warps evaluate it ahead; the bucketize's
    group evaluates it, two points a thread at 32), then ``group`` = 16 or
    32 threads a lane walk ``discretize.bisect``'s tree, ``log2(group)``
    levels a round on one evaluation of F a thread. ``f`` maps int64
    indices [L, n] to F there (any integers: nothing assumes F monotone);
    slot [L] -> (idx, F(idx), F(idx + 1)), idx as ``discretize.bisect(f,
    slot, bits)`` gives it. Used by no path: the tests hold it to
    ``bisect`` and, over the posterior's F, to the reference's
    bucketize."""
    k = 1 << bits
    g = group.bit_length() - 1
    slot = slot.to(torch.int64)[:, None]
    lo = torch.zeros(slot.shape[0], dtype=torch.int64, device=slot.device)
    n = k
    if k + 2 > group:
        # the top round: the tree's top p levels, a grid of np points
        p = min(GROUP_TOP_LEVELS[group], bits)
        sp = k >> p
        pts = torch.arange(1 << p, device=slot.device) * sp
        up = f(pts.expand(lo.shape[0], 1 << p)) <= slot
        lo = _reached(up, p) * sp
        n = sp
        while n > group // 2:   # the rounds above the last
            step = n >> g
            pts = lo[:, None] + torch.arange(group, device=slot.device) * step
            lo = lo + _reached(f(pts) <= slot, g) * step
            n = step
    # the last round: every point lo .. lo + n + 1
    m = n.bit_length() - 1
    v = f(lo[:, None] + torch.arange(n + 2, device=slot.device))
    a = _answered(v <= slot, m)
    return (lo + a, v.gather(1, a[:, None])[:, 0],
            v.gather(1, (a + 1)[:, None])[:, 0])


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
