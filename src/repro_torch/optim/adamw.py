"""AdamW with global-norm clipping (port of ``repro.optim.adamw``):
plain functions over parameter trees of tensors (nested dicts and
lists), the reference's update step for step.

    opt = AdamW(learning_rate=cosine_lr(1e-3, 100, steps))
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

Bias-corrected moments, decoupled weight decay, and every gradient
scaled by ``min(1, clip_norm / (global_norm + 1e-9))`` first. Updates
run under ``torch.no_grad`` and return new tensors; the inputs are not
changed.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the tensors of nested dicts and lists of the same
    layout."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if type(first) in (list, tuple):
        return type(first)(tree_map(fn, *(t[i] for t in trees))
                           for i in range(len(first)))
    return fn(*trees)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if type(tree) in (list, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class AdamWState(NamedTuple):
    step: int    # updates taken
    mu: Any      # first moment, like params
    nu: Any      # second moment, like params


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (float32)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree_leaves(tree)))


class AdamW(NamedTuple):
    learning_rate: Callable[[int], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params: Any) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p)
        return AdamWState(step=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState,
               params: Any) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (global_norm(grads) + 1e-9),
                                max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * (g * g), state.nu,
                      grads)
        t = torch.tensor(float(step), dtype=torch.float32)
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, t))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, t))
        lr = self.learning_rate(step)

        # The step scalars are 0-d CPU tensors: a CUDA op takes them as
        # arguments, with no copy to the card.
        def upd(p, m, v):
            u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return (p - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)


def constant_lr(value: float) -> Callable[[int], torch.Tensor]:
    return lambda step: torch.tensor(value, dtype=torch.float32)


def cosine_lr(peak: float, warmup: int, total: int,
              floor: float = 0.0) -> Callable[[int], torch.Tensor]:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    down to ``floor`` at ``total`` (float32, as the reference)."""
    def fn(step: int) -> torch.Tensor:
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)

    return fn
