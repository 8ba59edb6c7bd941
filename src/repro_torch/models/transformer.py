"""The transformer backbone, dense decoder branch (port of
``repro.models.transformer``): GQA decoders with RoPE, QKV bias, tied
or separate embeddings and SwiGLU or GELU MLPs - qwen2, smollm,
mistral-nemo and stablelm.

Entry points, as in the reference:
  init(cfg, generator)                    -> params
  forward(params, cfg, tokens)            -> (logits, aux)  (prefill/eval)
  prefill(params, cfg, batch, max_len)    -> (last logits, decode state)
  init_decode_state(cfg, batch, max_len)  -> state          (KV caches)
  decode_step(params, cfg, tok, state)    -> (logits, state) (serving)

Block leaves are stacked on a leading ``[L]`` axis, as the reference
stacks them for ``lax.scan``; the layers run as a Python loop over that
axis. At or above ``attention.BLOCKWISE_THRESHOLD`` tokens, ``forward``
and ``prefill`` attend through ``attention.sdpa_blockwise`` - the flash
kernel on the card, once per layer. ``decode_step`` updates the state's
caches in place and returns the same dict with ``cache_len`` (a Python
int) advanced. MoE, RWKV6, hymba (SSM), enc-dec and M-RoPE configs raise
``NotImplementedError`` (ROADMAP queue 1, item 8); ``loss_fn`` comes
with training (item 6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import device as dev
from repro_torch.models import attention, layers

BIG_WINDOW = 1 << 30


def _compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


def check_supported(cfg) -> None:
    """Raise unless ``cfg`` is a dense decoder the port runs."""
    other = (cfg.n_experts and "moe") or \
        (cfg.mixer != "attention" and cfg.mixer) or \
        (cfg.enc_dec and "enc_dec") or \
        (cfg.rope_kind == "mrope" and "mrope (VLM)") or cfg.frontend
    if other:
        raise NotImplementedError(
            f"transformer: {cfg.name} needs the {other} family, which "
            "waits for ROADMAP queue 1, item 8 (the port has the dense "
            "decoders only)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg, generator: torch.Generator, *,
         device: dev.DeviceLike = None) -> Dict[str, Any]:
    """The reference's tree and scales: ``embed.table``, ``ln_f``, the
    ``[L]``-stacked ``blocks`` (``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``,
    ``mlp``) and, untied, ``unembed``. Drawn from ``generator`` on its own
    device (a CUDA generator draws on the card), then moved to
    ``device``, in float32 and cast to ``cfg.param_dtype`` one subtree at
    a time (a 12B model's float32 tree would not fit beside its cast on
    an 80 GB card)."""
    check_supported(cfg)
    device = dev.resolve(device)
    pd = getattr(torch, cfg.param_dtype)
    cast = lambda tree: _tree_map(lambda t: t.to(pd), tree)
    kw = dict(lead=(cfg.n_layers,), device=device)
    params: Dict[str, Any] = {
        "embed": cast(layers.embed_init(generator, cfg.vocab, cfg.d_model,
                                        device=device)),
        "ln_f": cast(layers.norm_init(cfg.norm, cfg.d_model,
                                      device=device)),
        "blocks": {
            "ln1": cast(layers.norm_init(cfg.norm, cfg.d_model, **kw)),
            "ln2": cast(layers.norm_init(cfg.norm, cfg.d_model, **kw)),
            "attn": cast(attention.attn_init(generator, cfg, **kw)),
            "mlp": cast(layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                        cfg.act, **kw)),
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = cast(layers.embed_init(
            generator, cfg.vocab, cfg.d_model, device=device))
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layers(blocks, n: int) -> List[Dict[str, Any]]:
    """The stacked block leaves as one dict of views per layer."""
    return [_tree_map(lambda t: t[i], blocks) for i in range(n)]


# ---------------------------------------------------------------------------
# Per-layer schedules
# ---------------------------------------------------------------------------

def layer_windows(cfg, n_layers: int) -> List[int]:
    """Sliding-window size per layer (BIG_WINDOW = global attention)."""
    if cfg.sliding_window is None:
        return [BIG_WINDOW] * n_layers
    if cfg.global_attn_every:
        return [BIG_WINDOW if (i % cfg.global_attn_every == 0
                               or i == n_layers - 1)
                else cfg.sliding_window for i in range(n_layers)]
    return [cfg.sliding_window] * n_layers


def _dyn_mask(s_q: int, s_k: int, window: int, causal: bool = True, *,
              device: dev.DeviceLike = None) -> torch.Tensor:
    device = dev.resolve(device)
    qi = torch.arange(s_q, device=device)[:, None]
    ki = torch.arange(s_k, device=device)[None, :]
    m = (ki <= qi) if causal else torch.ones((s_q, s_k), dtype=torch.bool,
                                             device=device)
    return m & (ki > qi - window)


def _positions(cfg, b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device
                        ).expand(b, s)


# ---------------------------------------------------------------------------
# Forward (prefill / evaluation)
# ---------------------------------------------------------------------------

def _attend(p, h, cfg, positions, window: int, dt):
    """Self-attention of one layer over the whole prefix; returns the
    output and the layer's (k, v)."""
    q, k, v = attention._qkv(p["attn"], h, cfg, positions, dt)
    s = h.shape[1]
    if s >= attention.BLOCKWISE_THRESHOLD:
        a = attention.sdpa_blockwise(q, k, v, causal=True, window=window)
    else:
        a = attention.sdpa(q, k, v, _dyn_mask(s, s, window, causal=True,
                                              device=h.device))
    a = a.reshape(*a.shape[:2], -1)
    return layers.dense(p["attn"]["wo"], a, dt), k, v


def _ffn(p, x, cfg, dt):
    h = layers.norm_apply(cfg.norm, p["ln2"], x)
    return layers.mlp_apply(p["mlp"], h, cfg.act, dt)


def _unembed(params, cfg, x, dt):
    x = layers.norm_apply(cfg.norm, params["ln_f"], x)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return layers.unembed_apply(table, x, dt)


def forward(params, cfg, tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, float]:
    """Decoder forward -> (logits [B, S, V], moe aux loss = 0.0)."""
    check_supported(cfg)
    dt = _compute_dtype(cfg)
    table = params["embed"]["table"]
    if embeds is None:
        x = layers.embed_apply(params["embed"], tokens.to(table.device), dt)
    else:
        x = embeds.to(table.device, dt)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(cfg, b, s, x.device)
    windows = layer_windows(cfg, cfg.n_layers)
    for p, w in zip(_layers(params["blocks"], cfg.n_layers), windows):
        h = layers.norm_apply(cfg.norm, p["ln1"], x)
        x = x + _attend(p, h, cfg, positions, w, dt)[0]
        x = x + _ffn(p, x, cfg, dt)
    return _unembed(params, cfg, x, dt), 0.0


# ---------------------------------------------------------------------------
# Prefill (serving): full-prefix pass that also fills per-layer caches
# ---------------------------------------------------------------------------

def prefill(params, cfg, batch: Dict[str, torch.Tensor], max_len: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prefix in parallel, returning (last-token logits [B, 1, V],
    decode state with caches filled at cache_len = S)."""
    check_supported(cfg)
    dt = _compute_dtype(cfg)
    device = params["embed"]["table"].device
    tokens = batch["tokens"].to(device)
    b, s = tokens.shape
    if "embeds" in batch:
        x = batch["embeds"].to(device, dt)
    else:
        x = layers.embed_apply(params["embed"], tokens, dt)
    positions = _positions(cfg, b, s, device)
    windows = layer_windows(cfg, cfg.n_layers)
    l, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    int8_kv = cfg.kv_cache_dtype == "int8"
    kv_dtype = torch.int8 if int8_kv else dt
    state: Dict[str, Any] = {
        "k": torch.zeros((l, b, max_len, hkv, dh), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((l, b, max_len, hkv, dh), dtype=kv_dtype,
                         device=device)}
    if int8_kv:
        state["kv_scales"] = torch.zeros((l, b, max_len, hkv, 2),
                                         device=device)
    for i, (p, w) in enumerate(zip(_layers(params["blocks"], l), windows)):
        h = layers.norm_apply(cfg.norm, p["ln1"], x)
        a, k, v = _attend(p, h, cfg, positions, w, dt)
        if int8_kv:
            # The reference quantizes the zero-padded cache: a padded slot
            # holds 0 with scale 1e-9.
            pad = torch.zeros((b, max_len - s, hkv, dh), dtype=dt,
                              device=device)
            kq, ks = attention.quantize_kv(torch.cat([k, pad], dim=1))
            vq, vs = attention.quantize_kv(torch.cat([v, pad], dim=1))
            state["k"][i], state["v"][i] = kq, vq
            state["kv_scales"][i] = torch.cat([ks, vs], dim=-1)
        else:
            state["k"][i, :, :s] = k
            state["v"][i, :, :s] = v
        x = x + a
        x = x + _ffn(p, x, cfg, dt)
    logits = _unembed(params, cfg, x[:, -1:], dt)
    state["cache_len"] = s
    return logits, state


# ---------------------------------------------------------------------------
# Decode (serving): one token against per-layer KV caches
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16, *,
                      device: dev.DeviceLike = None) -> Dict[str, Any]:
    """Allocate per-layer caches, stacked on a leading [L] axis."""
    check_supported(cfg)
    device = dev.resolve(device)
    l, dh, hkv = cfg.n_layers, cfg.head_dim, cfg.n_kv_heads
    state: Dict[str, Any] = {"cache_len": 0}
    kv_shape = (l, batch, max_len, hkv, dh)
    if cfg.kv_cache_dtype == "int8":
        state["k"] = torch.zeros(kv_shape, dtype=torch.int8, device=device)
        state["v"] = torch.zeros(kv_shape, dtype=torch.int8, device=device)
        state["kv_scales"] = torch.zeros((l, batch, max_len, hkv, 2),
                                         device=device)
    else:
        state["k"] = torch.zeros(kv_shape, dtype=dtype, device=device)
        state["v"] = torch.zeros(kv_shape, dtype=dtype, device=device)
    return state


def decode_step(params, cfg, tok: torch.Tensor, state: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tok [B, 1] -> (logits [B, 1, V], state). The caches are updated in
    place and ``cache_len`` advances."""
    dt = _compute_dtype(cfg)
    table = params["embed"]["table"]
    x = layers.embed_apply(params["embed"], tok.to(table.device), dt)
    return decode_step_embeds(params, cfg, x, state)


def decode_step_embeds(params, cfg, x: torch.Tensor, state: Dict[str, Any]
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Like ``decode_step`` but from a provided embedding [B, 1, D]."""
    check_supported(cfg)
    dt = _compute_dtype(cfg)
    x = x.to(dt)
    t = state["cache_len"]
    int8_kv = cfg.kv_cache_dtype == "int8"
    windows = layer_windows(cfg, cfg.n_layers)
    for i, (p, w) in enumerate(zip(_layers(params["blocks"], cfg.n_layers),
                                   windows)):
        h = layers.norm_apply(cfg.norm, p["ln1"], x)
        scales = state["kv_scales"][i] if int8_kv else None
        a = attention.decode_attention(
            p["attn"], h, cfg, state["k"][i], state["v"][i], t, dt,
            window=w, kv_scales=scales)[0]
        x = x + a
        x = x + _ffn(p, x, cfg, dt)
    state["cache_len"] = t + 1
    return _unembed(params, cfg, x, dt), state
