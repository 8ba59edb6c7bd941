"""Synthetic token corpora with controllable, *known* entropy (port of
``repro.data.tokens``: the same numpy code, so the same arrays for the
same seed).

Offline container: no real text corpora. For LM training and for
LM-compression benchmarks we need token streams whose statistics a model
can actually learn and whose ground-truth entropy rate we can compute, so
achieved ANS rates have an analytic reference.

``markov_corpus`` generates an order-1 Markov chain over the vocabulary
with Zipfian stationary structure and a controllable mixing temperature;
its exact entropy rate is computable from the transition matrix.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _zipf_probs(vocab: int, alpha: float, rng) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    rng.shuffle(p)
    return p / p.sum()


def make_transition_matrix(vocab: int, alpha: float = 1.2,
                           concentration: float = 40.0,
                           seed: int = 0) -> np.ndarray:
    """Row-stochastic [V, V]: Dirichlet perturbations around a Zipf base."""
    rng = np.random.default_rng(seed)
    base = _zipf_probs(vocab, alpha, rng)
    # Sparse support per row keeps generation + learning tractable.
    k = min(vocab, 64)
    rows = np.zeros((vocab, k))
    cols = np.zeros((vocab, k), np.int64)
    for v in range(vocab):
        sup = rng.choice(vocab, size=k, replace=False, p=base)
        w = rng.dirichlet(concentration * base[sup] /
                          base[sup].sum())
        rows[v], cols[v] = w, sup
    t = np.zeros((vocab, vocab))
    np.put_along_axis(t, cols, rows, axis=1)
    return t


def entropy_rate_bits(trans: np.ndarray, tol: float = 1e-10) -> float:
    """Exact entropy rate of the stationary chain, bits/token."""
    v = trans.shape[0]
    pi = np.full(v, 1.0 / v)
    for _ in range(2000):
        nxt = pi @ trans
        if np.abs(nxt - pi).max() < tol:
            break
        pi = nxt
    with np.errstate(divide="ignore", invalid="ignore"):
        logt = np.where(trans > 0, np.log2(trans), 0.0)
    return float(-(pi[:, None] * trans * logt).sum())


def markov_corpus(n_tokens: int, vocab: int = 256, seed: int = 0,
                  alpha: float = 1.2) -> Tuple[np.ndarray, float]:
    """Returns (tokens int32[n_tokens], exact entropy rate bits/token)."""
    trans = make_transition_matrix(vocab, alpha=alpha, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cdf = np.cumsum(trans, axis=1)
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.integers(vocab)
    u = rng.random(n_tokens)
    for i in range(1, n_tokens):
        toks[i] = np.searchsorted(cdf[toks[i - 1]], u[i])
    return toks, entropy_rate_bits(trans)
