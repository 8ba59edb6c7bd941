"""Attention (port of ``repro.models.attention``): GQA/MQA/MHA with RoPE,
sliding windows, the flash-attention forward for long sequences, and
single-token cached decode over a bfloat16 or int8 KV cache.

Layouts, as in the reference:
  q:        [B, S, Hq, Dh]
  k/v:      [B, S, Hkv, Dh]
  KV cache: [B, T, Hkv, Dh]

``sdpa`` and the decode path are plain torch ops (the reference computes
them outside any Pallas kernel). ``sdpa_blockwise`` - the reference's
online-softmax forward - runs through ``kernels.flash.ops.flash_attention``:
the hand-written CUDA kernel on the card, its plain version on the CPU.
It is forward only: its block-recomputing backward comes with training
(ROADMAP queue 1, item 6). ``decode_attention`` writes the new token's
key and value into the caches in place (the reference donates them);
``cross_attention`` waits with the enc-dec family (item 8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import device as dev
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import layers


def attn_init(gen: torch.Generator, cfg: Any, *, lead: Tuple[int, ...] = (),
              device: dev.DeviceLike = None) -> Dict[str, Any]:
    d, dh = cfg.d_model, cfg.head_dim
    kw = dict(lead=lead, device=device)
    return {
        "wq": layers.dense_init(gen, d, (cfg.n_heads, dh), cfg.qkv_bias,
                                **kw),
        "wk": layers.dense_init(gen, d, (cfg.n_kv_heads, dh), cfg.qkv_bias,
                                **kw),
        "wv": layers.dense_init(gen, d, (cfg.n_kv_heads, dh), cfg.qkv_bias,
                                **kw),
        "wo": layers.dense_init(gen, cfg.n_heads * dh, d, **kw),
    }


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B, S, Hq, Dh] -> [B, S, Hkv, G, Dh]."""
    b, s, hq, dh = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, dh)


def _qkv(p, x, cfg, positions, compute_dtype):
    q = layers.dense(p["wq"], x, compute_dtype)
    k = layers.dense(p["wk"], x, compute_dtype)
    v = layers.dense(p["wv"], x, compute_dtype)
    if cfg.rope_kind == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_kind != "none":
        raise NotImplementedError(
            f"attention: rope_kind {cfg.rope_kind!r} waits for the VLM "
            "family (ROADMAP queue 1, item 8)")
    return q, k, v


def _mask(s_q: int, s_k: int, causal: bool,
          sliding_window: Optional[int], q_offset: int = 0, *,
          device: dev.DeviceLike = None) -> torch.Tensor:
    device = dev.resolve(device)
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    m = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if sliding_window is not None:
        m &= ki > qi - sliding_window
    return m


def sdpa(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped scaled dot-product attention.

    q [B, Sq, Hq, Dh]; k, v [B, Sk, Hkv, Dh]; mask broadcastable to
    [B, Hkv, G, Sq, Sk] or [Sq, Sk]. Softmax statistics in f32.
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = _split_gqa(q, hkv)  # [B, Sq, Hkv, G, Dh]
    scale = dh ** -0.5
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32)
    logits = logits * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, dh)


# Sequences at or above this length use the blockwise (flash-style)
# online-softmax path: O(tile^2) score memory instead of O(S^2).
BLOCKWISE_THRESHOLD = 2048


def sdpa_blockwise(q, k, v, *, causal: bool,
                   window: Optional[float] = None) -> torch.Tensor:
    """Flash-attention SDPA forward (``kernels.flash``), output in v's
    dtype. ``window`` None means no window; otherwise key ``k`` is seen
    by query ``q`` when ``k > q - window``. Raises under autograd: the
    backward waits for training (ROADMAP queue 1, item 6)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention.sdpa_blockwise is forward only in the port: its "
            "backward comes with training (ROADMAP queue 1, item 6)")
    sq, sk = q.shape[1], k.shape[1]
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be >= 1, got {window}")
    # A window that reaches past every key is no window.
    w = 0 if window is None or window >= sq + sk else int(window)
    return flash_ops.flash_attention(q, k, v, causal=causal,
                                     window=w).to(v.dtype)


# ---------------------------------------------------------------------------
# Cached decode (one new token against a KV cache)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Dh] -> (int8 values, per-vector f32 scale)."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0 + 1e-9
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def prefill_kv(p, x, cfg, positions, compute_dtype=torch.bfloat16):
    """Return (k, v) for the cache from a full prefix pass."""
    _, k, v = _qkv(p, x, cfg, positions, compute_dtype)
    return k, v


def decode_attention(p, x_t, cfg, k_cache, v_cache, cache_len: int,
                     compute_dtype=torch.bfloat16, window=None,
                     kv_scales=None):
    """One-token decode. x_t [B, 1, D]; caches [B, T, Hkv, Dh];
    ``cache_len`` (int) is the valid prefix length, the new token's
    position.

    The new token's k/v (and, for an int8 cache, its scales into
    ``kv_scales`` [B, T, Hkv, 2]) are written into the caches in place at
    ``cache_len`` - at the last slot once that is past the end, as the
    reference clamps it - then attention runs over the whole cache with
    a validity mask. Returns (attn output [B, 1, D], k_cache, v_cache), and
    ``kv_scales`` too for an int8 cache.
    """
    b, t = k_cache.shape[0], k_cache.shape[1]
    pos = torch.full((b, 1), cache_len, dtype=torch.int32,
                     device=x_t.device)
    q, k_t, v_t = _qkv(p, x_t, cfg, pos, compute_dtype)

    int8_kv = k_cache.dtype == torch.int8
    # The reference's dynamic_update_slice clamps its start: past the
    # cache's end, the last slot is overwritten.
    slot = min(cache_len, t - 1)
    if int8_kv:
        kq, ks = quantize_kv(k_t)   # ks [B, 1, Hkv, 1]
        vq, vs = quantize_kv(v_t)
        k_cache[:, slot] = kq[:, 0]
        v_cache[:, slot] = vq[:, 0]
        kv_scales[:, slot] = torch.cat([ks, vs], dim=-1)[:, 0]
        k_use = dequantize_kv(k_cache, kv_scales[..., 0:1], compute_dtype)
        v_use = dequantize_kv(v_cache, kv_scales[..., 1:2], compute_dtype)
    else:
        k_cache[:, slot] = k_t[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v_t[:, 0].to(v_cache.dtype)
        k_use = k_cache.to(compute_dtype)
        v_use = v_cache.to(compute_dtype)

    ki = torch.arange(t, device=x_t.device)[None, :]
    valid = ki <= cache_len  # slot cache_len now holds the new token
    if window is not None:
        valid &= ki > cache_len - window
    elif cfg.sliding_window is not None:
        valid &= ki > cache_len - cfg.sliding_window
    mask = valid[:, None, None, None, :]  # -> [B, Hkv, G, 1, T]
    out = sdpa(q, k_use, v_use, mask)
    out = out.reshape(b, 1, -1)
    if int8_kv:
        return (layers.dense(p["wo"], out, compute_dtype), k_cache,
                v_cache, kv_scales)
    return layers.dense(p["wo"], out, compute_dtype), k_cache, v_cache
