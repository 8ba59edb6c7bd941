"""``BBX2`` - the chunked streaming wire format - and ``BBX3``, the
sharded corpus container framed on top of it (the port's own copy of
``repro.stream.format``, byte for byte the same wire; numpy only).

A BBX2 stream is a framed sequence of independent BBX1-style blocks:
each block carries a complete flattened ``ANSStack`` message (per-lane
``[head_hi, head_lo, chunks...]`` rows, the BBX1 payload of
``codecs/container.py``) plus the number of datapoints it codes, so any
block decodes knowing only the stream header and the codec.

Wire layout (little-endian):

    Stream header (16 bytes)
    0       4       magic  b"BBX2"
    4       1       version (=1)
    5       1       precision (informational)
    6       2       flags (reserved, 0)
    8       4       lanes (u32)
    12      4       block_symbols (u32) - nominal datapoints per block

    Block (repeated; 12 + 4*lanes + 2*sum(len) bytes each)
    0       2       marker 0xB10C (u16)
    2       2       flags (reserved, 0)
    4       4       n_symbols coded by this block (u32)
    8       4       total chunks = sum(lengths) (u32)
    12      4*lanes lengths (u32 each, in 16-bit chunks, >= 2)
    ...     2*total payload: lane l's [head_hi, head_lo, chunks...]

    Trailer (16 bytes)
    0       2       marker 0xE05D (u16)
    2       2       flags (reserved, 0)
    4       4       n_blocks (u32)
    8       8       total_symbols (u64)

A ``BBX3`` corpus (``repro_torch.shard_codec``) is a 16-byte corpus
header, an index of ``n_shards`` 24-byte entries, then ``n_shards``
complete BBX2 streams ("segments") concatenated, one per lane shard:

    Corpus header (16 bytes)
    0       4       magic  b"BBX3"
    4       1       version (=1)
    5       1       precision (informational)
    6       2       flags (reserved, 0)
    8       4       n_shards (u32)
    12      4       lanes_per_shard (u32)

    Index entry (24 bytes each)
    0       8       segment byte offset, relative to index end (u64)
    8       8       segment byte length (u64)
    16      8       n_symbols coded by the segment (u64)

The canonical spec is ``docs/FORMATS.md``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.codecs.container import (ContainerError, pack_lane_rows,
                                          unpack_lane_rows)

MAGIC = b"BBX2"
VERSION = 1
BLOCK_MARKER = 0xB10C
END_MARKER = 0xE05D

_HEADER = struct.Struct("<4sBBHII")
_BLOCK = struct.Struct("<HHII")
_TRAILER = struct.Struct("<HHIQ")

HEADER_SIZE = _HEADER.size     # 16
BLOCK_HEADER_SIZE = _BLOCK.size   # 12
TRAILER_SIZE = _TRAILER.size   # 16

CORPUS_MAGIC = b"BBX3"
CORPUS_VERSION = 1
_CORPUS_HEADER = struct.Struct("<4sBBHII")
_CORPUS_ENTRY = struct.Struct("<QQQ")

CORPUS_HEADER_SIZE = _CORPUS_HEADER.size   # 16
CORPUS_ENTRY_SIZE = _CORPUS_ENTRY.size     # 24


@dataclasses.dataclass(frozen=True)
class StreamHeader:
    lanes: int
    block_symbols: int
    precision: int
    version: int = VERSION


@dataclasses.dataclass(frozen=True)
class Block:
    """One parsed block: ``msg``/``lengths`` feed ``ans.unflatten``."""
    n_symbols: int
    msg: np.ndarray       # uint16[lanes, width]
    lengths: np.ndarray   # int32[lanes]


@dataclasses.dataclass(frozen=True)
class Trailer:
    n_blocks: int
    total_symbols: int


def encode_header(header: StreamHeader) -> bytes:
    return _HEADER.pack(MAGIC, header.version, header.precision, 0,
                        header.lanes, header.block_symbols)


def decode_header(buf: bytes, offset: int = 0
                  ) -> Optional[Tuple[StreamHeader, int]]:
    """Parse a stream header at ``offset``; None if more bytes needed."""
    if len(buf) - offset < HEADER_SIZE:
        return None
    magic, version, precision, _flags, lanes, block_symbols = \
        _HEADER.unpack_from(buf, offset)
    if magic != MAGIC:
        raise ContainerError(
            f"stream: bad magic {magic!r} at byte {offset} "
            "(not a BBX2 stream)")
    if version != VERSION:
        raise ContainerError(
            f"stream: unsupported BBX2 version {version} at byte {offset}")
    if lanes < 1 or block_symbols < 1:
        raise ContainerError(
            f"stream: corrupt header at byte {offset} "
            "(lanes/block_symbols < 1)")
    return StreamHeader(lanes=lanes, block_symbols=block_symbols,
                        precision=precision, version=version), \
        offset + HEADER_SIZE


def encode_block(n_symbols: int, msg: np.ndarray,
                 lengths: np.ndarray) -> bytes:
    """Frame one flattened stack message as a BBX2 block."""
    lengths = np.asarray(lengths)
    return b"".join([
        _BLOCK.pack(BLOCK_MARKER, 0, n_symbols, int(lengths.sum())),
        lengths.astype("<u4").tobytes(),
        pack_lane_rows(np.asarray(msg), lengths),
    ])


def encode_trailer(trailer: Trailer) -> bytes:
    return _TRAILER.pack(END_MARKER, 0, trailer.n_blocks,
                         trailer.total_symbols)


def decode_next(buf: bytes, offset: int, lanes: int):
    """Parse the next frame at ``offset``.

    Returns ``(Block, new_offset)``, ``(Trailer, new_offset)``, or
    ``None`` when the buffer does not yet hold the complete frame
    (incremental feeding). Raises on corrupt markers.
    """
    avail = len(buf) - offset
    if avail < 2:
        return None
    (marker,) = struct.unpack_from("<H", buf, offset)
    if marker == END_MARKER:
        if avail < TRAILER_SIZE:
            return None
        _m, _flags, n_blocks, total_symbols = _TRAILER.unpack_from(
            buf, offset)
        return Trailer(n_blocks, total_symbols), offset + TRAILER_SIZE
    if marker != BLOCK_MARKER:
        raise ContainerError(
            f"stream: bad frame marker 0x{marker:04X} at offset {offset} "
            "(not a block boundary)")
    if avail < BLOCK_HEADER_SIZE + 4 * lanes:
        return None
    _m, _flags, n_symbols, total = _BLOCK.unpack_from(buf, offset)
    lengths = np.frombuffer(buf, dtype="<u4", count=lanes,
                            offset=offset + BLOCK_HEADER_SIZE
                            ).astype(np.int32)
    if (lengths < 2).any():
        raise ContainerError(
            f"stream: corrupt block at byte {offset} (lane length < 2)")
    if int(lengths.sum()) != total:
        raise ContainerError(
            f"stream: corrupt block at byte {offset} (length sum mismatch)")
    payload_off = offset + BLOCK_HEADER_SIZE + 4 * lanes
    end = payload_off + 2 * total
    if len(buf) < end:
        return None
    msg = unpack_lane_rows(buf, payload_off, lengths)
    return Block(n_symbols=n_symbols, msg=msg, lengths=lengths), end


def scan(blob: bytes) -> Tuple[StreamHeader, List[int], Optional[Trailer]]:
    """Walk a complete stream: (header, block byte offsets, trailer).

    The offsets index the first byte of each block's marker - exactly
    what ``StreamDecoder.from_header`` + ``blob[offset:]`` needs for a
    mid-stream resume.

    Corruption raises ``codecs.ContainerError`` naming the byte offset
    and block index where the frame walk failed, so a bad wire byte is
    reported as *where* in the stream it sits, not as an index error
    deep inside the coder.
    """
    parsed = decode_header(blob)
    if parsed is None:
        raise ContainerError("stream: truncated (no header)")
    header, off = parsed
    offsets: List[int] = []
    trailer: Optional[Trailer] = None
    while True:
        try:
            out = decode_next(blob, off, header.lanes)
        except ContainerError as e:
            raise ContainerError(
                f"stream: scan failed at block {len(offsets)} "
                f"(byte offset {off}): {e}") from e
        if out is None:
            break
        frame, new_off = out
        if isinstance(frame, Trailer):
            trailer = frame
            break
        offsets.append(off)
        off = new_off
    return header, offsets, trailer


# ---------------------------------------------------------------------------
# BBX3 - the sharded corpus container
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CorpusHeader:
    n_shards: int
    lanes_per_shard: int
    precision: int
    version: int = CORPUS_VERSION


@dataclasses.dataclass(frozen=True)
class ShardEntry:
    """One index row: where shard ``s``'s BBX2 segment lives.

    ``offset`` is relative to the end of the index (the first segment
    byte); ``scan_corpus`` returns entries rebased to absolute blob
    offsets, so ``blob[e.offset:e.offset + e.length]`` is the segment.
    """
    offset: int
    length: int
    n_symbols: int


def encode_corpus(segments: Sequence[bytes], n_symbols: Sequence[int],
                  lanes_per_shard: int,
                  precision: int = 16) -> bytes:
    """Frame per-shard BBX2 segments as one BBX3 corpus blob.

    ``segments[s]`` must be a complete BBX2 stream over
    ``lanes_per_shard`` lanes coding ``n_symbols[s]`` datapoints.
    """
    if len(segments) != len(n_symbols) or not segments:
        raise ValueError("corpus: need one n_symbols per segment (>= 1)")
    header = _CORPUS_HEADER.pack(CORPUS_MAGIC, CORPUS_VERSION, precision,
                                 0, len(segments), lanes_per_shard)
    entries, off = [], 0
    for seg, n in zip(segments, n_symbols):
        entries.append(_CORPUS_ENTRY.pack(off, len(seg), n))
        off += len(seg)
    return b"".join([header, *entries, *segments])


def scan_corpus(blob: bytes) -> Tuple[CorpusHeader, List[ShardEntry]]:
    """Parse a BBX3 corpus: (header, index with absolute offsets).

    Touches only the header + index bytes - seeking to one shard of a
    dataset-scale corpus never reads the other shards' payload.

    Example::

        header, entries = scan_corpus(blob)
        seg0 = blob[entries[0].offset:entries[0].offset
                    + entries[0].length]       # a complete BBX2 stream
    """
    if len(blob) < CORPUS_HEADER_SIZE:
        raise ContainerError("corpus: truncated (no header)")
    magic, version, precision, _flags, n_shards, lanes = \
        _CORPUS_HEADER.unpack_from(blob, 0)
    if magic != CORPUS_MAGIC:
        raise ContainerError(
            f"corpus: bad magic {magic!r} at byte 0 (not a BBX3 corpus)")
    if version != CORPUS_VERSION:
        raise ContainerError(f"corpus: unsupported BBX3 version {version}")
    if n_shards < 1 or lanes < 1:
        raise ContainerError("corpus: corrupt header (n_shards/lanes < 1)")
    if n_shards > (len(blob) - CORPUS_HEADER_SIZE) // CORPUS_ENTRY_SIZE:
        raise ContainerError(
            f"corpus: corrupt header (n_shards={n_shards} needs a "
            "larger index than the blob holds)")
    base = CORPUS_HEADER_SIZE + n_shards * CORPUS_ENTRY_SIZE
    if len(blob) < base:
        raise ContainerError("corpus: truncated (index incomplete)")
    entries: List[ShardEntry] = []
    for s in range(n_shards):
        entry_off = CORPUS_HEADER_SIZE + s * CORPUS_ENTRY_SIZE
        off, length, n_sym = _CORPUS_ENTRY.unpack_from(blob, entry_off)
        if base + off + length > len(blob):
            raise ContainerError(
                f"corpus: truncated (shard {s} segment at byte "
                f"{base + off} extends past the blob)")
        entries.append(ShardEntry(base + off, length, n_sym))
    return CorpusHeader(n_shards=n_shards, lanes_per_shard=lanes,
                        precision=precision, version=version), entries


def corpus_segment(blob: bytes, shard: int) -> bytes:
    """Shard ``shard``'s complete BBX2 segment bytes (index-seeked).

    Example::

        seg = corpus_segment(blob, 3)
        xs3 = stream.decode_stream(codec, seg)   # shard 3, independently
    """
    _, entries = scan_corpus(blob)
    if not 0 <= shard < len(entries):
        raise ContainerError(
            f"corpus: shard {shard} out of range [0, {len(entries)})")
    e = entries[shard]
    return blob[e.offset:e.offset + e.length]


# ---------------------------------------------------------------------------
# shard -> host placement (derived, never serialized)
# ---------------------------------------------------------------------------

def shard_host(shard: int, n_shards: int, n_hosts: int) -> int:
    """The host index shard ``shard`` of an ``n_shards`` corpus is
    served by in an ``n_hosts`` cluster: round-robin over the cluster's
    host order.

    The assignment is a pure function of the BBX3 index - it is
    *derived* at routing time and **never serialized into the wire**,
    so corpus bytes stay hex-identical whether one host or N encode or
    decode them (the cluster determinism contract,
    ``tests/test_cluster.py``).

    Example::

        assert shard_host(5, n_shards=8, n_hosts=3) == 5 % 3
    """
    if n_shards < 1 or n_hosts < 1:
        raise ValueError("corpus: shard_host needs n_shards/n_hosts >= 1")
    if not 0 <= shard < n_shards:
        raise ContainerError(
            f"corpus: shard {shard} out of range [0, {n_shards})")
    return shard % n_hosts


def corpus_assignments(blob: bytes, n_hosts: int) -> List[List[int]]:
    """Per-host shard lists for a BBX3 corpus, derived from its index
    alone (``shard_host`` per entry; only header + index bytes are
    read).

    Example::

        plan = corpus_assignments(blob, n_hosts=2)
        assert sorted(s for shards in plan for s in shards) == \\
            list(range(scan_corpus(blob)[0].n_shards))
    """
    header, _ = scan_corpus(blob)
    plan: List[List[int]] = [[] for _ in range(n_hosts)]
    for s in range(header.n_shards):
        plan[shard_host(s, header.n_shards, n_hosts)].append(s)
    return plan
