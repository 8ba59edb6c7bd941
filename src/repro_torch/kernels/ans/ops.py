"""Dispatched multi-step coder ops over an ``ANSStack`` (the port of
``repro/kernels/ans/ops.py``).

The sequential per-lane coder loop runs in the backend
``kernels.dispatch`` resolves - the CUDA kernel on the card, the plain
PyTorch twin or the per-step oracle on the CPU - and the irregular
stack bookkeeping stays here in PyTorch, as it stays in XLA in the
reference:

  * push: the kernel emits a dense [steps, lanes] (chunk, need) list; a
    cumsum turns it into stack positions and one scatter appends the
    chunks (``ops.py:63-74`` of the reference), the ones not kept into
    the spill column (``ans.append``), with no host sync;
  * table push: the (start, freq) of each symbol is gathered from its
    lane's static table, then pushed as above;
  * pop: each pop reads at most one chunk, in stack order, so the next
    ``steps`` chunks of every lane are gathered first (``_chunk_feed``)
    and the kernel reads them by a per-lane counter; ``_finish_pop``
    applies the counts to ``ptr`` and the underflow counter.

Every backend gives the same stack, bit for bit, as ``steps`` calls of
``repro_torch.core.ans``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import ans, discretize
from repro_torch.kernels import dispatch
from repro_torch.kernels.ans import kernel as K
from repro_torch.kernels.ans import ref as R
from repro_torch.kernels.ans import twin as T


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def push_many(stack: ans.ANSStack, starts: torch.Tensor, freqs: torch.Tensor,
              precision: int = ans.DEFAULT_PRECISION,
              backend: Optional[str] = None) -> ans.ANSStack:
    """Push ``steps`` symbols per lane; starts/freqs [steps, lanes] in
    push order. Updates ``stack.buf`` in place; never waits for the
    device."""
    steps, lanes = starts.shape
    name = dispatch.resolve("push_many", stack.device, backend)
    if name == "ref":
        return R.push_many_ref(stack, starts, freqs, precision)
    emit = K.push_emit if name == "cuda" else T.push_emit
    head, chunks, need = emit(stack.head.contiguous(), _i32(starts),
                              _i32(freqs), precision)
    need64 = need.to(torch.int64)
    pos = stack.ptr[None, :] + torch.cumsum(need64, dim=0) - need64
    emitted = need.bool()
    keep = emitted & (pos < stack.capacity)
    rows = torch.arange(lanes, device=head.device).expand(steps, lanes)
    buf = ans.append(stack.buf, rows, pos, chunks, keep)
    over = (emitted & ~keep).sum(dim=0)
    return stack.replace(head=head, buf=buf,
                         ptr=stack.ptr + need64.sum(dim=0),
                         overflows=stack.overflows + over)


def push_many_table(stack: ans.ANSStack, starts_table: torch.Tensor,
                    symbols: torch.Tensor,
                    precision: int = ans.DEFAULT_PRECISION,
                    backend: Optional[str] = None) -> ans.ANSStack:
    """Push ``steps`` symbols per lane (int[steps, lanes], push order)
    from one static per-lane cumulative-starts table [lanes, A+1]: the
    (start, freq) gather here, the pushes through ``push_many``."""
    name = dispatch.resolve("push_many_table", stack.device, backend)
    if name == "ref":
        return R.push_many_table_ref(stack, starts_table, symbols,
                                     precision)
    table = starts_table.to(torch.int64)
    sym = symbols.to(torch.int64)
    rows = torch.arange(stack.lanes, device=table.device)[None, :]
    starts = table[rows, sym]
    return push_many(stack, starts, table[rows, sym + 1] - starts,
                     precision, name)


def _chunk_feed(stack: ans.ANSStack, steps: int) -> torch.Tensor:
    """``feed[r, l]``: the ``r``-th chunk lane ``l``'s stack would serve
    (``buf[l, ptr-1-r]`` clamped at the bottom, as ``ans.pop_update``
    re-serves the bottom chunk on underflow). int32[steps, lanes]."""
    if not stack.capacity:
        return torch.zeros((steps, stack.lanes), dtype=torch.int32,
                           device=stack.device)
    t = torch.arange(steps, device=stack.device)
    cols = torch.clamp(stack.ptr[None, :] - 1 - t[:, None], 0,
                       stack.capacity - 1)
    return stack.buf.gather(1, cols.T).T.contiguous()


def _finish_pop(stack: ans.ANSStack, head: torch.Tensor, syms: torch.Tensor,
                reads: torch.Tensor) -> Tuple[ans.ANSStack, torch.Tensor]:
    reads = reads.to(torch.int64)
    under = torch.clamp(reads - stack.ptr, min=0)
    ptr = torch.clamp(stack.ptr - reads, min=0)
    return stack.replace(head=head, ptr=ptr,
                         underflows=stack.underflows + under), \
        syms.to(torch.int32)


def pop_many(stack: ans.ANSStack, starts_table: torch.Tensor, steps: int,
             precision: int = ans.DEFAULT_PRECISION,
             backend: Optional[str] = None
             ) -> Tuple[ans.ANSStack, torch.Tensor]:
    """Pop ``steps`` symbols per lane against one static per-lane
    cumulative-starts table [lanes, A+1]; returns (stack, symbols
    int32[steps, lanes]) in pop order. Reads past the bottom of a lane's
    stack re-serve its bottom chunk and count as underflows, as
    ``ans.pop_update`` does."""
    name = dispatch.resolve("pop_many", stack.device, backend)
    if name == "ref":
        return R.pop_many_ref(stack, starts_table, steps, precision)
    emit = K.pop_table_emit if name == "cuda" else T.pop_table_emit
    feed = _chunk_feed(stack, steps)
    head, syms, reads = emit(stack.head.contiguous(), _i32(starts_table),
                             feed, precision)
    return _finish_pop(stack, head, syms, reads)


def pop_slots(stack: ans.ANSStack, precision: int = ans.DEFAULT_PRECISION,
              backend: Optional[str] = None) -> torch.Tensor:
    """The decode slot ``head mod 2^precision`` of every lane, int32
    [lanes] (the reference's ``kernel.py:102 pop_slots``; ``ans.peek`` is
    the per-step form the codecs use)."""
    name = dispatch.resolve("pop_slots", stack.device, backend)
    if name == "ref":
        return ans.peek(stack, precision).to(torch.int32)
    emit = K.pop_slots if name == "cuda" else T.pop_slots
    return emit(stack.head.contiguous(), precision)


def pop_many_dyn(stack: ans.ANSStack, tables: torch.Tensor,
                 precision: int = ans.DEFAULT_PRECISION,
                 backend: Optional[str] = None
                 ) -> Tuple[ans.ANSStack, torch.Tensor]:
    """Pop ``steps`` symbols per lane against per-step cumulative-starts
    tables [steps, lanes, A+1]; returns (stack, symbols int32[steps,
    lanes]) in pop order."""
    steps = tables.shape[0]
    name = dispatch.resolve("pop_many_dyn", stack.device, backend)
    if name == "ref":
        return R.pop_many_dyn_ref(stack, tables, precision)
    emit = K.pop_dyntable_emit if name == "cuda" else T.pop_dyntable_emit
    feed = _chunk_feed(stack, steps)
    head, syms, reads = emit(stack.head.contiguous(), _i32(tables), feed,
                             precision)
    return _finish_pop(stack, head, syms, reads)


def pop_many_grid(stack: ans.ANSStack, kind: str, mu: Optional[torch.Tensor],
                  sigma: Optional[torch.Tensor], steps: int, lat_bits: int,
                  precision: int = ans.DEFAULT_PRECISION,
                  backend: Optional[str] = None
                  ) -> Tuple[ans.ANSStack, torch.Tensor]:
    """Fused bucketize + pop over the N(0,1) bucket grid: ``steps`` bucket
    indices per lane under per-step ``gaussian`` (mu, sigma [steps,
    lanes]), ``logistic`` (mu, scale) or ``uniform`` (mu/sigma unused)
    distributions."""
    T.check_kind(kind)
    name = dispatch.resolve("pop_many_grid", stack.device, backend)
    if name == "ref":
        return R.pop_many_grid_ref(stack, kind, mu, sigma, steps, lat_bits,
                                   precision)
    emit = K.pop_grid_emit if name == "cuda" else T.pop_grid_emit
    feed = _chunk_feed(stack, steps)
    if kind != "uniform":
        mu = mu.to(torch.float32).contiguous()
        sigma = sigma.to(torch.float32).contiguous()
        edges = discretize.edge_table(lat_bits, stack.device)
    else:
        mu = sigma = edges = None
    head, idx, reads = emit(stack.head.contiguous(), mu, sigma, feed, edges,
                            kind, lat_bits, precision)
    return _finish_pop(stack, head, idx, reads)


def grid_starts(idx: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
                lat_bits: int, precision: int = ans.DEFAULT_PRECISION,
                backend: Optional[str] = None, kind: str = "gaussian"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, freq) of ``gaussian`` or ``logistic`` grid buckets ``idx``
    [steps, lanes]: ``F(idx)`` and ``F(idx+1) - F(idx)``, the same CDF
    bits the pop side inverts."""
    if kind not in ("gaussian", "logistic"):
        raise ValueError(f"kernels.ans: grid_starts takes the gaussian or "
                         f"logistic kind, got {kind!r}")
    name = dispatch.resolve("grid_starts", idx.device, backend)
    if name == "ref":
        f = T.cdf_starts_fn(kind)(mu, sigma, lat_bits, precision)
        i = idx.to(torch.int64)
        start = f(i)
        return start, f(i + 1) - start
    mu = mu.to(torch.float32).contiguous()
    sigma = sigma.to(torch.float32).contiguous()
    edges = discretize.edge_table(lat_bits, idx.device)
    emit = K.grid_starts if name == "cuda" else T.grid_starts
    return emit(_i32(idx), mu, sigma, edges, lat_bits, precision, kind)
