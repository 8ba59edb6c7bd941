"""Per-step oracle for the ANS kernels (the port of
``repro/kernels/ans/ref.py``): the core coder, one symbol at a time,
through ``repro_torch.core.ans`` / ``core.discretize``."""

from __future__ import annotations

import torch

from repro_torch.core import ans, discretize
from repro_torch.codecs.leaves import DiscretizedLogistic


def push_many_ref(stack: ans.ANSStack, starts: torch.Tensor,
                  freqs: torch.Tensor, precision: int) -> ans.ANSStack:
    """Sequential ``ans.push`` over the steps of starts/freqs [S, L]."""
    for t in range(starts.shape[0]):
        stack = ans.push(stack, starts[t], freqs[t], precision)
    return stack


def push_many_table_ref(stack: ans.ANSStack, starts_table: torch.Tensor,
                        symbols: torch.Tensor,
                        precision: int) -> ans.ANSStack:
    """Sequential ``ans.push_with_table`` over the steps of symbols
    [S, L] against one static table [L, A+1]."""
    for t in range(symbols.shape[0]):
        stack = ans.push_with_table(stack, starts_table, symbols[t],
                                    precision)
    return stack


def pop_many_ref(stack: ans.ANSStack, starts_table: torch.Tensor,
                 steps: int, precision: int):
    """Sequential table pops against one static table [L, A+1]; returns
    (stack, symbols int32[S, L]) in pop order."""
    syms = []
    for _ in range(steps):
        stack, sym = ans.pop_with_table(stack, starts_table, precision)
        syms.append(sym)
    return stack, torch.stack(syms).to(torch.int32)


def pop_many_dyn_ref(stack: ans.ANSStack, tables: torch.Tensor,
                     precision: int):
    """Sequential table pops against per-step tables [S, L, A+1];
    returns (stack, symbols int32[S, L]) in pop order."""
    syms = []
    for t in range(tables.shape[0]):
        stack, sym = ans.pop_with_table(stack, tables[t], precision)
        syms.append(sym)
    return stack, torch.stack(syms).to(torch.int32)


def pop_many_grid_ref(stack: ans.ANSStack, kind: str, mu, sigma, steps: int,
                      lat_bits: int, precision: int):
    """Sequential per-position grid pops (``discretize.pop_posterior`` /
    ``DiscretizedLogistic`` / ``pop_prior``); returns (stack, symbols
    int32[S, L])."""
    syms = []
    for t in range(steps):
        if kind == "gaussian":
            stack, idx = discretize.pop_posterior(stack, mu[t], sigma[t],
                                                  lat_bits, precision)
        elif kind == "logistic":
            stack, idx = DiscretizedLogistic(mu[t], sigma[t], lat_bits,
                                             precision).pop(stack)
        elif kind == "uniform":
            stack, idx = discretize.pop_prior(stack, lat_bits, precision)
        else:
            raise ValueError(f"kernels.ans.ref: unknown grid kind {kind!r}")
        syms.append(idx)
    return stack, torch.stack(syms).to(torch.int32)
