"""Observation-model coders (port of ``repro.core.distributions``):
``Bernoulli``, ``Categorical`` over a static per-lane table, and
``FactoredCategorical`` (an LM vocabulary as chunk and offset).
BetaBinomial is not ported yet (ROADMAP queue 1, item 3).

The Bernoulli table is ``round(sigmoid(logit) * (2^p - 2)) + 1`` with
XLA-CPU's float32 sigmoid (``xla_ndtr.sigmoid_f32``) and round half to
even, as ``jnp.round`` rounds; so it is the reference's, bit for bit.

The coding table must carry the reference's bits exactly, so the float32
softmax is XLA-CPU's, op for op, as the reference evaluates it eagerly:
an exact row max and subtraction, XLA's ``exp_f32``
(``core/xla_ndtr.py``) with subnormal results flushed to zero as XLA's
CPU runtime flushes them, the row sum in XLA's reduction order
(``ans.sum_f32``), one correctly rounded ``1 / sum``, one multiply. Then
``ans.probs_to_starts`` (XLA's cumsum order, ``ans.cumsum_f32``). Every
step is an IEEE float32 op on either device, so a table built on the card
equals one built on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import ans
from repro_torch.core.codec import Codec
from repro_torch.core.xla_ndtr import _exp_f32, _flush, log_f32, sigmoid_f32


def _stable_softmax(logits: torch.Tensor) -> torch.Tensor:
    """``e * (1 / sum(e))`` with ``e = exp(logits - max)`` over the last
    axis, float32, bit for bit as the reference computes it on XLA-CPU."""
    x = logits.to(torch.float32)
    e = _flush(_exp_f32(x - x.amax(dim=-1, keepdim=True)))
    return _flush(e * torch.reciprocal(ans.sum_f32(e)))


def bernoulli_freq1(logits: torch.Tensor,
                    precision: int = ans.DEFAULT_PRECISION) -> torch.Tensor:
    """Fixed-point frequency of a 1, int64 in ``[1, 2^p - 1]``:
    ``round(sigmoid(logit) * (2^p - 2)) + 1``. Elementwise: the same bits
    for one lane or a whole [n, lanes] grid."""
    p = sigmoid_f32(logits)
    return torch.round(p * ((1 << precision) - 2)).to(torch.int64) + 1


@dataclasses.dataclass(frozen=True)
class Bernoulli(Codec):
    """Per-lane Bernoulli with success probability ``sigmoid(logit)``;
    symbols in {0, 1}."""

    logits: torch.Tensor  # float[lanes]
    precision: int = ans.DEFAULT_PRECISION

    def _freq1(self) -> torch.Tensor:
        return bernoulli_freq1(self.logits, self.precision)

    def push(self, stack: ans.ANSStack, sym: torch.Tensor) -> ans.ANSStack:
        total = 1 << self.precision
        f1 = self._freq1()
        f0 = total - f1
        is1 = sym.bool()
        start = torch.where(is1, f0, torch.zeros_like(f0))
        freq = torch.where(is1, f1, f0)
        return ans.push(stack, start, freq, self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        total = 1 << self.precision
        f1 = self._freq1()
        f0 = total - f1
        is1 = ans.peek(stack, self.precision) >= f0
        start = torch.where(is1, f0, torch.zeros_like(f0))
        freq = torch.where(is1, f1, f0)
        return (ans.pop_update(stack, start, freq, self.precision),
                is1.to(torch.int32))

    def log_prob(self, sym: torch.Tensor) -> torch.Tensor:
        """Natural-log probability of ``sym`` per lane (a rate figure,
        differentiable; not bit-matched to the reference)."""
        x = sym.to(self.logits.dtype)
        return x * torch.nn.functional.logsigmoid(self.logits) + \
            (1 - x) * torch.nn.functional.logsigmoid(-self.logits)


@dataclasses.dataclass(frozen=True)
class Categorical(Codec):
    """Per-lane categorical over an alphabet of size ``logits.shape[-1]``.

    ``logits`` float[lanes, A]; symbols int[lanes] in ``0 .. A-1``. The
    table lives on ``logits``' device.
    """

    logits: torch.Tensor
    precision: int = ans.DEFAULT_PRECISION

    def _table(self) -> torch.Tensor:
        """Cumulative starts int64[lanes, A+1]."""
        return ans.probs_to_starts(_stable_softmax(self.logits),
                                   self.precision)

    def push(self, stack: ans.ANSStack, sym: torch.Tensor) -> ans.ANSStack:
        return ans.push_with_table(stack, self._table(), sym, self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        return ans.pop_with_table(stack, self._table(), self.precision)

    def log_prob(self, sym: torch.Tensor) -> torch.Tensor:
        """Natural-log probability of ``sym`` per lane (float32; a rate
        figure, not a coding table - not bit-matched to the reference)."""
        logp = torch.log_softmax(self.logits.to(torch.float32), dim=-1)
        return logp.gather(-1, sym.to(torch.int64)[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Factored categorical (LM vocabularies beyond 2^(precision-1))
# ---------------------------------------------------------------------------

def logsumexp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis on XLA-CPU (float32), bit
    for bit: the row max (0 where it is not finite), XLA's ``exp_f32`` of
    the difference with subnormals flushed, the sum in XLA's order
    (``ans.sum_f32``), XLA's ``log_f32``, plus the max."""
    x = x.to(torch.float32)
    amax = x.amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    sumexp = ans.sum_f32(_flush(_exp_f32(x - amax)))
    return (log_f32(sumexp) + amax)[..., 0]


@dataclasses.dataclass(frozen=True)
class FactoredCategorical(Codec):
    """Categorical over a large vocabulary, coded as (chunk, offset).

    A token ``v`` is coded as ``hi = v // chunk_size`` under the chunk
    marginal (each chunk's logsumexp, ``logsumexp_f32``) after ``lo = v %
    chunk_size`` under the within-chunk conditional: ``push`` pushes lo
    then hi, so ``pop`` pops hi then lo. A vocabulary of one chunk codes
    no hi (it would carry 0 bits, and its frequency 2^precision overflows
    the fixed point). The last chunk is padded with -1e30 logits. Every
    table is the reference's, bit for bit, given the same float32 logits.
    """

    logits: torch.Tensor  # float[lanes, V]
    chunk_size: int = 256
    precision: int = ans.DEFAULT_PRECISION

    def _parts(self):
        lanes, v = self.logits.shape
        cs = self.chunk_size
        n_chunks = -(-v // cs)
        pad = n_chunks * cs - v
        logits = self.logits.to(torch.float32)
        if pad:
            logits = torch.nn.functional.pad(logits, (0, pad), value=-1e30)
        grouped = logits.reshape(lanes, n_chunks, cs)
        return grouped, logsumexp_f32(grouped), n_chunks

    def push(self, stack: ans.ANSStack, sym: torch.Tensor) -> ans.ANSStack:
        grouped, chunk_logits, n_chunks = self._parts()
        sym = sym.to(torch.int64)
        hi = sym // self.chunk_size
        lo = sym % self.chunk_size
        rows = torch.arange(grouped.shape[0], device=grouped.device)
        stack = Categorical(grouped[rows, hi], self.precision).push(stack, lo)
        if n_chunks > 1:
            stack = Categorical(chunk_logits, self.precision).push(stack, hi)
        return stack

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        grouped, chunk_logits, n_chunks = self._parts()
        rows = torch.arange(grouped.shape[0], device=grouped.device)
        if n_chunks > 1:
            stack, hi = Categorical(chunk_logits, self.precision).pop(stack)
        else:
            hi = torch.zeros((grouped.shape[0],), dtype=torch.int32,
                             device=grouped.device)
        within = Categorical(grouped[rows, hi.to(torch.int64)],
                             self.precision)
        stack, lo = within.pop(stack)
        return stack, hi * self.chunk_size + lo

    def log_prob(self, sym: torch.Tensor) -> torch.Tensor:
        """Natural-log probability of ``sym`` per lane (a rate figure, not
        bit-matched to the reference)."""
        logp = torch.log_softmax(self.logits.to(torch.float32), dim=-1)
        return logp.gather(-1, sym.to(torch.int64)[:, None])[:, 0]
