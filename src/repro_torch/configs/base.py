"""Architecture config schema and registry (port of
``repro.configs.base``).

Every LM architecture is a frozen ``ArchConfig``, registered by name by
its module in this package. ``reduced`` shrinks one to test scale with
its family's structure kept. The port has the dense decoders only
(``qwen2_0_5b``, ``smollm_360m``, ``mistral_nemo_12b``,
``stablelm_12b``); the MoE, SSM, RWKV, enc-dec and VLM configs wait for
their model code (ROADMAP queue 1, item 8). The reference's dry-run
shape cells (``SHAPES``, ``input_shapes``) wait with ``launch/dryrun``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # explicit head dim (mistral-nemo)
    qkv_bias: bool = False
    rope_kind: str = "rope"               # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t/h/w for M-RoPE
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    act: str = "silu"                     # silu | gelu
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    moe_d_ff: Optional[int] = None        # expert hidden (defaults d_ff)
    shared_expert: bool = False           # llama4: always-on shared expert
    dense_ff_parallel: bool = False       # arctic: dense MLP residual + MoE
    capacity_factor: float = 1.25
    # --- mixer ---
    mixer: str = "attention"              # attention | rwkv6 | hymba
    ssm_state: int = 16
    sliding_window: Optional[int] = None
    global_attn_every: int = 0            # hymba: full-attn layer stride
    # --- structure ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None        # audio_stub | vision_stub
    # --- numerics/training ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"              # adamw | adafactor
    remat: str = "dots"                   # none | dots | full
    loss_chunk: int = 1024                # seq chunking for the vocab loss
    grad_accum: int = 1                   # microbatches per train step
    fsdp_regather_once: bool = False      # gather params once per step
    kv_cache_dtype: str = "bfloat16"      # bfloat16 | int8 (serving)

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def is_subquadratic(self) -> bool:
        return self.mixer in ("rwkv6", "hymba")

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dh = self.d_model, self.head_dim
        attn = (self.n_heads * dh + 2 * self.n_kv_heads * dh) * d \
            + self.n_heads * dh * d
        if self.mixer == "rwkv6":
            attn = 4 * d * d  # r/k/v/out (+ small lora terms, ignored)
        dense_mlp = 3 * d * self.d_ff if self.act == "silu" \
            else 2 * d * self.d_ff
        per_layer = attn
        if self.n_experts:
            per_layer += self.n_experts * 3 * d * self.expert_d_ff
            if self.shared_expert:
                per_layer += 3 * d * self.expert_d_ff
            if self.dense_ff_parallel:
                per_layer += dense_mlp
        else:
            per_layer += dense_mlp
        if self.mixer == "hymba":
            per_layer += 2 * d * d  # ssm branch in/out (+ small ssm params)
        n_blocks = self.n_layers + self.n_enc_layers
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return n_blocks * per_layer + embed

    def active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        all_experts = (self.n_layers *
                       self.n_experts * 3 * d * self.expert_d_ff)
        routed = self.n_layers * self.top_k * 3 * d * self.expert_d_ff
        return full - all_experts + routed


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all():
    # Import for registration side effects: the dense decoders only.
    from repro_torch.configs import (mistral_nemo_12b,  # noqa: F401
                                     qwen2_0_5b, smollm_360m, stablelm_12b)


def reduced(cfg: ArchConfig, layers: int = 2, width: int = 64) -> ArchConfig:
    """Shrink a config to smoke-test scale, preserving family structure."""
    dh = 16
    n_heads = max(2, min(4, cfg.n_heads)) if cfg.n_heads else 0
    # Keep the GQA ratio >= 1 and divisible.
    n_kv = max(1, min(cfg.n_kv_heads, n_heads)) if cfg.n_heads else 0
    if n_heads and n_kv and n_heads % n_kv:
        n_kv = 1
    d_model = width
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=layers,
        n_enc_layers=min(cfg.n_enc_layers, layers) if cfg.enc_dec else 0,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=dh,
        d_ff=width * 2,
        moe_d_ff=width * 2 if cfg.n_experts else None,
        n_experts=min(cfg.n_experts, 4),
        mrope_sections=(dh // 8, dh // 8 + dh // 16, dh // 8 + dh // 16),
        vocab=257,
        sliding_window=min(cfg.sliding_window, 32)
        if cfg.sliding_window else None,
        loss_chunk=16,
        remat="none",
    )
