"""Lane-vectorized rANS entropy coder in PyTorch (the port of
``repro.core.ans``).

The coder is the reference's, word for word:

  * 32-bit state per lane, normalized interval ``[2^16, 2^32)``;
  * 16-bit renormalization chunks on a per-lane stack (``buf``/``ptr``);
  * coding precision ``r <= 16``, so each push emits at most one chunk
    and each pop reads at most one: one masked emission, one masked read,
    no data-dependent loop.

Representation: PyTorch's ``uint32`` lacks ``//``, ``%``, shifts and
compares on the CPU, so heads are ``int64`` holding ``[0, 2^32)`` and
every step that could leave 32 bits is masked back (``& 0xFFFFFFFF``),
which reproduces uint32 wraparound. Chunks are ``int32`` in
``[0, 2^16)``; ``ptr``/counters are ``int64``. The CUDA kernels in
``kernels/ans`` compute on native ``uint32_t`` heads.

Unlike JAX arrays, ``buf`` is updated in place by pushes (a copy of the
whole ``[lanes, capacity]`` buffer per symbol would dominate): callers use
the stack a push returns and do not reuse the one they passed in.

Appends never wait for the device. ``buf`` is the first ``capacity``
columns of a ``[lanes, capacity + 1]`` block; the last column, which no
reader sees, is the spill column. A push scatters every chunk, sending
the ones it must not keep (no emission, or a full stack) to the spill
column, as the reference's ``mode="drop"`` scatter drops them. Boolean
indexing would instead read the mask back to the host (``nonzero``) on
every push.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core import prng

RANS_L = 1 << 16
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF
MAX_PRECISION = 16
DEFAULT_PRECISION = 16


@dataclasses.dataclass
class ANSStack:
    """State of ``lanes`` independent rANS coders.

    head: int64[lanes] in ``[2^16, 2^32)``; buf: int32[lanes, capacity]
    16-bit chunks; ptr: int64[lanes] stack depth; underflows/overflows:
    int64[lanes] counts of reads past the bottom and chunks dropped on a
    full stack (both 0 in a clean message).
    """

    head: torch.Tensor
    buf: torch.Tensor
    ptr: torch.Tensor
    underflows: torch.Tensor
    overflows: torch.Tensor

    @property
    def lanes(self) -> int:
        return self.buf.shape[0]

    @property
    def capacity(self) -> int:
        return self.buf.shape[1]

    @property
    def device(self) -> torch.device:
        return self.head.device

    def replace(self, **kw) -> "ANSStack":
        return dataclasses.replace(self, **kw)


def make_stack(lanes: int, capacity: int, key: Optional[np.ndarray] = None,
               *, device: torch.device) -> ANSStack:
    """An empty stack; with a threefry ``key``, heads uniform on
    ``[2^16, 2^32)`` drawn exactly as the reference draws them."""
    if key is None:
        head = torch.full((lanes,), RANS_L, dtype=torch.int64, device=device)
    else:
        k_hi, k_lo = prng.split(key)
        hi = prng.randint(k_hi, (lanes,), 1, 1 << 16).astype(np.int64)
        lo = prng.randint(k_lo, (lanes,), 0, 1 << 16).astype(np.int64)
        head = dev.upload((hi << 16) | lo, device)
    zeros = torch.zeros((lanes,), dtype=torch.int64, device=device)
    return ANSStack(
        head=head.to(device),
        buf=empty_buf(lanes, capacity, device),
        ptr=zeros, underflows=zeros.clone(), overflows=zeros.clone())


def empty_buf(lanes: int, capacity: int,
              device: torch.device) -> torch.Tensor:
    """int32[lanes, capacity] of zeros: the visible columns of a
    ``[lanes, capacity + 1]`` block whose last column is the spill
    column ``append`` writes dropped chunks to."""
    return torch.zeros((lanes, capacity + 1), dtype=torch.int32,
                       device=device)[:, :capacity]


def append(buf: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           chunks: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Write ``chunks`` to ``buf[rows, cols]`` where ``keep`` holds and to
    the spill column elsewhere: one scatter of every chunk, with no host
    sync. The positions kept must be distinct and inside ``buf``. Returns
    the buffer written (``buf`` itself unless it lacked a spill column;
    then a copy that has one)."""
    lanes, cap = buf.shape
    if buf.stride() == (cap + 1, 1) and \
            buf.untyped_storage().nbytes() >= \
            (buf.storage_offset() + lanes * (cap + 1)) * buf.element_size():
        block = buf.as_strided((lanes, cap + 1), (cap + 1, 1))
    else:
        block = torch.zeros((lanes, cap + 1), dtype=buf.dtype,
                            device=buf.device)
        block[:, :cap] = buf
    block[rows, torch.where(keep, cols, cap)] = chunks.to(buf.dtype)
    return block[:, :cap]


def seed_stack(stack: ANSStack, key: np.ndarray, n_chunks: int) -> ANSStack:
    """Push ``n_chunks`` uniform 16-bit chunks per lane (clean bits)."""
    chunks = prng.randint(key, (stack.lanes, n_chunks), 0, 1 << 16)
    chunks = dev.upload(chunks.astype(np.int32), stack.device)
    cols = stack.ptr[:, None] + torch.arange(n_chunks, device=stack.device)
    rows = torch.arange(stack.lanes, device=stack.device)[:, None] \
        .expand_as(cols)
    buf = append(stack.buf, rows, cols, chunks, cols < stack.capacity)
    dropped = torch.clamp(stack.ptr + n_chunks - stack.capacity, 0, n_chunks)
    return stack.replace(buf=buf, ptr=stack.ptr + n_chunks,
                         overflows=stack.overflows + dropped)


def check_precision(precision: int) -> None:
    if not 0 < precision <= MAX_PRECISION:
        raise ValueError(
            f"ans: precision must be in [1, {MAX_PRECISION}], got "
            f"{precision}")


def push(stack: ANSStack, start: torch.Tensor, freq: torch.Tensor,
         precision: int = DEFAULT_PRECISION) -> ANSStack:
    """Encode one symbol per lane given its (start, freq) at ``precision``."""
    check_precision(precision)
    head, ptr = stack.head, stack.ptr
    start, freq = start.to(torch.int64), freq.to(torch.int64)
    x_max = (freq << (32 - precision)) & MASK32
    need = head >= x_max
    write = need & (ptr < stack.capacity)
    lanes = torch.arange(stack.lanes, device=head.device)
    buf = append(stack.buf, lanes, ptr, head & MASK16, write)
    over = need & (ptr >= stack.capacity)
    ptr = ptr + need.to(torch.int64)
    head = torch.where(need, head >> 16, head)
    head = (((head // freq) << precision) + head % freq + start) & MASK32
    return stack.replace(head=head, buf=buf, ptr=ptr,
                         overflows=stack.overflows + over.to(torch.int64))


def peek(stack: ANSStack, precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """The decode slot ``head mod 2^precision`` per lane."""
    check_precision(precision)
    return stack.head & ((1 << precision) - 1)


def pop_update(stack: ANSStack, start: torch.Tensor, freq: torch.Tensor,
               precision: int = DEFAULT_PRECISION) -> ANSStack:
    """Advance the decoder once the slot's symbol is known; exactly
    inverts ``push(stack, start, freq, precision)``."""
    check_precision(precision)
    head, ptr = stack.head, stack.ptr
    start, freq = start.to(torch.int64), freq.to(torch.int64)
    slot = peek(stack, precision)
    head = (freq * (head >> precision) + slot - start) & MASK32
    need = head < RANS_L
    lanes = torch.arange(stack.lanes, device=head.device)
    read_idx = torch.clamp(ptr - 1, min=0)
    if stack.capacity:
        chunk = stack.buf[lanes, torch.clamp(read_idx, max=stack.capacity - 1)]
    else:
        chunk = torch.zeros_like(head)
    head = torch.where(need, ((head << 16) | chunk.to(torch.int64)) & MASK32,
                       head)
    under = need & (ptr <= 0)
    ptr = torch.clamp(ptr - need.to(torch.int64), min=0)
    return stack.replace(head=head, ptr=ptr,
                         underflows=stack.underflows + under.to(torch.int64))


def pop_with_table(stack: ANSStack, starts_table: torch.Tensor,
                   precision: int = DEFAULT_PRECISION
                   ) -> Tuple[ANSStack, torch.Tensor]:
    """Decode one symbol per lane from cumulative starts
    ``[lanes, A+1]``; returns (stack, symbol int32[lanes])."""
    slot = peek(stack, precision)
    table = starts_table.to(torch.int64)
    sym = torch.searchsorted(table, slot[:, None], right=True)[:, 0] - 1
    start = table.gather(1, sym[:, None])[:, 0]
    freq = table.gather(1, sym[:, None] + 1)[:, 0] - start
    return pop_update(stack, start, freq, precision), sym.to(torch.int32)


def push_with_table(stack: ANSStack, starts_table: torch.Tensor,
                    symbol: torch.Tensor,
                    precision: int = DEFAULT_PRECISION) -> ANSStack:
    """Encode one symbol per lane from cumulative starts ``[lanes, A+1]``."""
    table = starts_table.to(torch.int64)
    sym = symbol.to(torch.int64)[:, None]
    start = table.gather(1, sym)[:, 0]
    freq = table.gather(1, sym + 1)[:, 0] - start
    return push(stack, start, freq, precision)


def stack_bits(stack: ANSStack) -> int:
    """Message length in bits if flushed now (32 bits of head per lane)."""
    return int(stack.ptr.sum()) * 16 + 32 * stack.lanes


def stack_content_bits(stack: ANSStack) -> torch.Tensor:
    """Information on the stack, excluding the flush constant: 16 bits
    per chunk plus ``log2(head)`` per lane, as a float32 scalar tensor
    on the stack's device (the reference sums without x64). Reading its
    value waits for the device, so callers keep it a tensor until they
    need the number."""
    head_bits = torch.log2(stack.head.to(torch.float32))
    return stack.ptr.sum().to(torch.float32) * 16.0 + head_bits.sum()


def flatten(stack: ANSStack) -> Tuple[torch.Tensor, torch.Tensor]:
    """(message int32[lanes, cap+2] of 16-bit words, lengths int64[lanes]);
    row layout ``[head_hi16, head_lo16, chunks...]``."""
    hi = (stack.head >> 16).to(torch.int32)[:, None]
    lo = (stack.head & MASK16).to(torch.int32)[:, None]
    return torch.cat([hi, lo, stack.buf], dim=1), stack.ptr + 2


def unflatten(msg: torch.Tensor, lengths: torch.Tensor,
              capacity: Optional[int] = None) -> ANSStack:
    """Inverse of ``flatten``."""
    lanes = msg.shape[0]
    cap = capacity if capacity is not None else msg.shape[1] - 2
    msg = msg.to(torch.int64)
    head = (msg[:, 0] << 16) | msg[:, 1]
    body = msg[:, 2:2 + cap]
    buf = empty_buf(lanes, cap, msg.device)
    buf[:, :body.shape[1]] = body
    zeros = torch.zeros((lanes,), dtype=torch.int64, device=msg.device)
    return ANSStack(head=head, buf=buf,
                    ptr=lengths.to(torch.int64) - 2,
                    underflows=zeros, overflows=zeros.clone())


def check_clean(stack: ANSStack, context: str = "ANS") -> ANSStack:
    """Raise if the stack ever under- or overflowed; returns it."""
    under = int(stack.underflows.sum())
    over = int(stack.overflows.sum())
    if under:
        raise RuntimeError(
            f"{context}: {under} stack underflow(s) - pops consumed past "
            "the bottom of the stack; seed more clean bits (init_chunks)")
    if over:
        raise RuntimeError(
            f"{context}: {over} chunk(s) dropped on overflow - stack "
            "capacity too small for this message; increase capacity")
    return stack


# ---------------------------------------------------------------------------
# fixed-point CDF helpers
# ---------------------------------------------------------------------------

def cdf_to_starts(cdf: torch.Tensor,
                  precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Float CDF ``[..., A+1]`` -> starts ``floor((2^p - A) * cdf) + i``
    (int64), strictly increasing with exact total."""
    a = cdf.shape[-1] - 1
    total = 1 << precision
    if a >= total:
        raise ValueError(
            f"alphabet {a} too large for precision {precision}; "
            "use a factored codec")
    if a < 2:
        raise ValueError("degenerate alphabet (< 2 symbols): skip coding")
    scaled = torch.floor(cdf * float(total - a)).to(torch.int64)
    ramp = torch.arange(a + 1, dtype=torch.int64, device=cdf.device)
    return scaled + ramp


def cumsum_f32(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive float32 sum over the last axis, in the order XLA's CPU
    backend adds for ``jnp.cumsum``: left to right within blocks of 16,
    the block totals summed the same way recursively, and each block's
    exclusive prefix added last. (``torch.cumsum`` accumulates in float64
    on the CPU and rounds differently.)"""
    n = x.shape[-1]
    if n <= block:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    pad = torch.zeros(x.shape[:-1] + ((-n) % block,), dtype=x.dtype,
                      device=x.device)
    local = cumsum_f32(torch.cat([x, pad], dim=-1)
                       .reshape(x.shape[:-1] + (-1, block)), block)
    prefix = cumsum_f32(local[..., -1], block)[..., :-1]
    local[..., 1:, :] += prefix[..., None]
    return local.reshape(x.shape[:-1] + (-1,))[..., :n]


def sum_f32(x: torch.Tensor, block: int = 32) -> torch.Tensor:
    """float32 sum over the last axis (kept as a size-1 axis), in the
    order XLA's CPU backend adds for ``jnp.sum``: a row of at most 32 is
    summed left to right; a longer row is padded with zeros to a multiple
    of 32 - half of the padding (rounded down) in front, the rest behind -
    each block of 32 summed left to right, and the block sums reduced the
    same way, recursively."""
    n = x.shape[-1]
    if n <= block:
        acc = x[..., :1]
        for i in range(1, n):
            acc = acc + x[..., i:i + 1]
        return acc
    pad = (-n) % block
    shape = x.shape[:-1]
    x = torch.cat([x.new_zeros(shape + (pad // 2,)), x,
                   x.new_zeros(shape + (pad - pad // 2,))], dim=-1)
    parts = sum_f32(x.reshape(shape + (-1, block)), block)[..., 0]
    return sum_f32(parts, block)


def probs_to_starts(probs: torch.Tensor,
                    precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """``cdf_to_starts`` from probabilities ``[..., A]`` (reference's
    cumsum order, reciprocal-multiply normalization)."""
    cdf = cumsum_f32(probs)
    cdf = cdf * torch.reciprocal(cdf[..., -1:])
    zero = torch.zeros(cdf.shape[:-1] + (1,), dtype=cdf.dtype,
                       device=cdf.device)
    cdf = torch.clamp(torch.cat([zero, cdf], dim=-1), 0.0, 1.0)
    return cdf_to_starts(cdf, precision)
