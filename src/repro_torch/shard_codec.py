"""``repro_torch.shard_codec`` - dataset-scale lane-parallel coding (port
of ``repro.shard_codec``; the same BBX3 bytes).

The lane axis is cut into ``n_shards`` contiguous shards; each shard's
datapoints stream through their own ``stream.StreamEncoder`` on the
shard's device into one BBX2 segment, and the segments are framed as one
BBX3 corpus. Any shard decodes from its segment alone. The bytes depend
on (codec, data, n_shards, block_symbols, seed) only, never on where the
shards ran.

    blob = shard_codec.compress_dataset(codec, data, n_shards=8)
    data2 = shard_codec.decompress_dataset(codec, blob)
    xs3 = shard_codec.decompress_shard(codec, blob, shard=3)

Devices are torch devices. By default every shard runs on the current
card; the codec's own tensors (model weights, tables) must lie on the
devices the shards run on.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as dev
from repro_torch import stream
from repro_torch.core import ans
from repro_torch.core.codec import Codec
from repro_torch.stream import format as fmt
from repro_torch.stream.coder import tree_leaves, tree_map

__all__ = [
    "shard_devices", "split_lane_tree", "merge_lane_tree", "peek_chunks",
    "compress_dataset", "decompress_dataset", "decompress_shard",
    "corpus_info",
]


def shard_devices(n_shards: int) -> List[torch.device]:
    """The device of each shard: the current card for all of them.
    Raises without a card (pass ``devices=`` to run elsewhere)."""
    if n_shards < 1:
        raise ValueError("shard_codec: n_shards must be >= 1")
    return [dev.resolve(None)] * n_shards


def _lane_count(data: Any) -> int:
    return tree_leaves(data)[0].shape[1]


def split_lane_tree(data: Any, n_shards: int) -> List[Any]:
    """Time-major ``[n, lanes, ...]`` data as ``n_shards`` contiguous
    lane slices."""
    lanes = _lane_count(data)
    if n_shards < 1 or lanes % n_shards:
        raise ValueError(
            f"shard_codec: {lanes} lanes do not divide into "
            f"{n_shards} equal shards")
    per = lanes // n_shards
    return [tree_map(lambda a: a[:, s * per:(s + 1) * per], data)
            for s in range(n_shards)]


def merge_lane_tree(shards: Sequence[Any]) -> Any:
    """Per-shard ``[n, lanes_s, ...]`` trees joined along the lane axis
    (the inverse of ``split_lane_tree``), on the first shard's device."""
    shards = list(shards)
    if not shards:
        raise ValueError("shard_codec: no shards to merge")
    to = tree_leaves(shards[0])[0].device
    return tree_map(lambda *ls: torch.cat([a.to(to) for a in ls], dim=1),
                    *shards)


def peek_chunks(data: Any) -> Tuple[Any, Iterable[Any]]:
    """``(first chunk, iterable of chunks)``: a list or an iterator is a
    stream of ``[n, lanes, ...]`` chunks, anything else one chunk. The
    first chunk is peeked without losing it; an empty stream raises."""
    empty = "shard_codec: no data chunks to compress"
    if isinstance(data, list):
        if not data:
            raise ValueError(empty)
        return data[0], data
    if hasattr(data, "__next__"):
        try:
            first = next(data)
        except StopIteration:
            raise ValueError(empty) from None
        return first, itertools.chain([first], data)
    return data, [data]


def compress_dataset(codec: Codec, data: Any, *, n_shards: int,
                     block_symbols: int = 8, seed: Optional[int] = 0,
                     init_chunks: int = 32,
                     precision: int = ans.DEFAULT_PRECISION,
                     devices: Optional[Sequence[Any]] = None,
                     **encoder_kwargs) -> bytes:
    """One BBX3 corpus blob from ``[n, lanes, ...]`` data (or an iterable
    of such chunks); ``lanes`` must divide into ``n_shards``. Shard ``s``
    codes with seed ``seed + s`` (``None``: all cold). Extra
    ``encoder_kwargs`` (``capacity``, ``compile``, ``pipeline``...) go to
    every encoder."""
    first, chunks = peek_chunks(data)
    lanes = _lane_count(first)
    if lanes % n_shards:
        raise ValueError(
            f"shard_codec: {lanes} lanes do not divide into "
            f"{n_shards} equal shards")
    devs = [torch.device(d) for d in devices] if devices is not None \
        else shard_devices(n_shards)
    if len(devs) != n_shards:
        raise ValueError(f"shard_codec: got {len(devs)} devices for "
                         f"{n_shards} shards")
    encoders = [stream.StreamEncoder(
        codec, lanes=lanes // n_shards, block_symbols=block_symbols,
        seed=None if seed is None else seed + s,
        init_chunks=init_chunks, precision=precision, device=devs[s],
        **encoder_kwargs) for s in range(n_shards)]
    segments = [bytearray() for _ in range(n_shards)]
    for chunk in chunks:
        for s, shard in enumerate(split_lane_tree(chunk, n_shards)):
            segments[s].extend(encoders[s].write(shard))
    for s, enc in enumerate(encoders):
        segments[s].extend(enc.flush())
    return fmt.encode_corpus(
        [bytes(seg) for seg in segments],
        [enc.n_symbols for enc in encoders],
        lanes_per_shard=encoders[0].lanes, precision=precision)


def decompress_shard(codec: Codec, blob: bytes, shard: int,
                     **decoder_kwargs) -> Any:
    """Decode one shard of a BBX3 corpus, touching no other shard's
    bytes; ``decoder_kwargs`` (``device``, ``compile``...) go to its
    ``StreamDecoder``."""
    return stream.decode_stream(codec, fmt.corpus_segment(blob, shard),
                                **decoder_kwargs)


def decompress_dataset(codec: Codec, blob: bytes, *,
                       devices: Optional[Sequence[Any]] = None,
                       **decoder_kwargs) -> Any:
    """A whole BBX3 corpus back to ``[n, lanes, ...]``, shard by shard,
    each on its device (``devices[s]``, by default the current card)."""
    header, entries = fmt.scan_corpus(blob)
    devs = [torch.device(d) for d in devices] if devices is not None \
        else shard_devices(header.n_shards)
    outs = [stream.decode_stream(codec, blob[e.offset:e.offset + e.length],
                                 device=devs[s % len(devs)], **decoder_kwargs)
            for s, e in enumerate(entries)]
    return merge_lane_tree(outs)


def corpus_info(blob: bytes) -> dict:
    """A BBX3 corpus summarized from its framing: shard count, lane
    layout, per-shard bytes and symbols."""
    header, entries = fmt.scan_corpus(blob)
    return {
        "n_shards": header.n_shards,
        "lanes_per_shard": header.lanes_per_shard,
        "precision": header.precision,
        "total_bytes": len(blob),
        "index_bytes": fmt.CORPUS_HEADER_SIZE
        + header.n_shards * fmt.CORPUS_ENTRY_SIZE,
        "shard_bytes": [e.length for e in entries],
        "shard_symbols": [e.n_symbols for e in entries],
        "total_symbols": sum(e.n_symbols for e in entries),
    }
