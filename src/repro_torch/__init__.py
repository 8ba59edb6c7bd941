"""PyTorch/CUDA port of ``repro`` (BB-ANS, Townsend, Bird & Barber, ICLR
2019), for NVIDIA Hopper.

Mirrors the ``repro`` module tree where a counterpart exists and imports
``torch`` and numpy only - never ``jax`` or ``repro``. The JAX package is
the reference it is held against, byte for byte on integer-exact paths.
Entry points run on ``cuda`` unless ``device="cpu"`` is passed.
"""
