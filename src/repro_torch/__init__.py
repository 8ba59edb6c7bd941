"""PyTorch/CUDA port of ``repro`` (BB-ANS, Townsend, Bird & Barber, ICLR
2019), for NVIDIA Hopper.

Mirrors the ``repro`` module tree where a counterpart exists and imports
``torch`` and numpy only - never ``jax`` or ``repro``. The JAX package is
the reference it is held against, byte for byte on integer-exact paths.
Entry points run on ``cuda`` unless ``device="cpu"`` is passed.

    from repro_torch import codecs, shard_codec, stream
    blob = codecs.compress(codec, data, lanes=16)            # BBX1
    wire = stream.encode_stream(codec, xs, lanes=16, block_symbols=8)
    corpus = shard_codec.compress_dataset(codec, xs, n_shards=4)   # BBX3
"""
