"""mistral-nemo-12b [dense]: 128k ctx, explicit head_dim=128 (!= d/H).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072,
    rope_kind="rope", rope_theta=1000000.0,
    optimizer="adamw", remat="full", grad_accum=4,
))
