"""Flash-attention forward: the hand-written CUDA kernel
(``csrc/flash_fwd.cu``, ``kernel.py``), its plain PyTorch version
(``twin.py``), the exact-SDPA oracle (``ref.py``) and the dispatched
model-layout wrapper (``ops.py``)."""
