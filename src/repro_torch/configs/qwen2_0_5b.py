"""qwen2-0.5b [dense]: GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936,
    qkv_bias=True, tie_embeddings=True,
    rope_kind="rope", rope_theta=1000000.0,
    optimizer="adamw", remat="full", grad_accum=2, fsdp_regather_once=True,
))
