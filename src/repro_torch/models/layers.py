"""Shared neural building blocks (port of ``repro.models.layers``):
norms, dense, embeddings, RoPE, gated MLPs. Plain functions over dicts of
tensors with the reference's shapes (``w [d_in, *d_out]``, contracted
over one axis) and dtypes: float32 parameters, compute in the config's
``compute_dtype``, norms in float32.

Initializers draw from a ``torch.Generator`` on its own device and move
the result to ``device``; they give other numbers than the reference's
``jax.random`` for the same seed, so tests carry the reference's weights
across with ``repro_torch.weights.from_jax_params``. The reference's
sharding constraints are the identity on one card and are left out;
``apply_mrope`` and ``sinusoidal_positions`` wait with the VLM and
enc-dec families (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import device as dev

Params = Dict[str, torch.Tensor]


def truncated_normal_init(gen: torch.Generator, shape: Tuple[int, ...],
                          scale: float, *, lead: Tuple[int, ...] = (),
                          device: dev.DeviceLike = None) -> torch.Tensor:
    """``[*lead, *shape]``: a normal truncated to +-2, times ``scale /
    sqrt(shape[-2])`` (the reference's fan: ``shape[-2]`` of one layer's
    shape); ``lead`` stacks layers."""
    stddev = scale / max(1.0, (shape[-2] if len(shape) > 1 else 1)) ** 0.5
    w = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * stddev).to(dev.resolve(device))


def dense_init(gen: torch.Generator, d_in: int,
               d_out: Union[Tuple[int, ...], int], bias: bool = False, *,
               lead: Tuple[int, ...] = (),
               device: dev.DeviceLike = None) -> Params:
    """``{"w": [*lead, d_in, *d_out]}`` (+ zero ``"b"``)."""
    device = dev.resolve(device)
    if isinstance(d_out, int):
        d_out = (d_out,)
    p = {"w": truncated_normal_init(gen, (d_in,) + tuple(d_out), 1.0,
                                    lead=lead, device=device)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + tuple(d_out), device=device)
    return p


def dense(p: Params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, *d_out] -> [..., *d_out]."""
    w = p["w"].to(compute_dtype)
    y = torch.tensordot(x.to(compute_dtype), w, dims=1)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm_init(d: int, *, lead: Tuple[int, ...] = (),
                 device: dev.DeviceLike = None) -> Params:
    return {"scale": torch.ones(tuple(lead) + (d,),
                                device=dev.resolve(device))}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def layernorm_init(d: int, *, lead: Tuple[int, ...] = (),
                   device: dev.DeviceLike = None) -> Params:
    device = dev.resolve(device)
    return {"scale": torch.ones(tuple(lead) + (d,), device=device),
            "bias": torch.zeros(tuple(lead) + (d,), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def norm_init(kind: str, d: int, *, lead: Tuple[int, ...] = (),
              device: dev.DeviceLike = None) -> Params:
    init = rmsnorm_init if kind == "rmsnorm" else layernorm_init
    return init(d, lead=lead, device=device)


def norm_apply(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: dev.DeviceLike = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=dev.resolve(device)) / head_dim
    # A Python base: a tensor made from it would be a host-to-device copy
    # that waits for the card on every call.
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, Dh], positions [B, S] (int) -> same shape."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, Dh/2]
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str, *,
             lead: Tuple[int, ...] = (),
             device: dev.DeviceLike = None) -> Dict[str, Params]:
    kw = dict(lead=lead, device=device)
    if act == "silu":  # gated (SwiGLU-style): wi, wg, wo
        return {"wi": dense_init(gen, d_model, d_ff, **kw),
                "wg": dense_init(gen, d_model, d_ff, **kw),
                "wo": dense_init(gen, d_ff, d_model, **kw)}
    return {"wi": dense_init(gen, d_model, d_ff, bias=True, **kw),
            "wo": dense_init(gen, d_ff, d_model, bias=True, **kw)}


def mlp_apply(p: Dict[str, Params], x: torch.Tensor, act: str,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    h = dense(p["wi"], x, compute_dtype)
    if act == "silu":
        h = F.silu(h) * dense(p["wg"], x, compute_dtype)
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return dense(p["wo"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int, *,
               device: dev.DeviceLike = None) -> Params:
    t = torch.randn((vocab, d_model), generator=gen, device=gen.device)
    return {"table": (t * 0.02).to(dev.resolve(device))}


def embed_apply(p: Params, ids: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    return p["table"][ids.to(torch.int64)].to(compute_dtype)


def unembed_apply(p: Params, x: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    return torch.einsum("...d,vd->...v", x.to(compute_dtype),
                        p["table"].to(compute_dtype))
