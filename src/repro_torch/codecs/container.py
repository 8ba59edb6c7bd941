"""One-call container format, BBX1, byte for byte (port of
``repro.codecs.container``).

``compress(codec, data)`` sizes the stack (growing and retrying on
overflow), seeds random heads and clean bits from ``seed`` with the
reference's threefry draws, pushes, and frames::

    offset  size        field
    0       4           magic  b"BBX1"
    4       1           version (=1)
    5       1           precision (informational)
    6       2           flags (reserved, 0)
    8       4           lanes (u32)
    12      4*lanes     lengths (u32 each, in 16-bit chunks, >= 2)
    ...     2*sum(len)  payload: lane l's [head_hi, head_lo, chunks...]

``decompress(codec, blob)`` needs only the codec and the blob.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core import ans, prng
from repro_torch.core.codec import Codec

_MAGIC = b"BBX1"
_VERSION = 1
_HEADER = struct.Struct("<4sBBHI")
_MAX_LANES = 1 << 24


class ContainerError(ValueError):
    """A blob failed header or framing validation (corrupt, truncated, or
    not a BBX1 container)."""


def fresh_stack(lanes: int, capacity: int, seed: Optional[int] = 0,
                init_chunks: int = 0, *,
                device: dev.DeviceLike = None) -> ans.ANSStack:
    """A ready-to-code stack: random heads and ``init_chunks`` clean
    16-bit chunks per lane, from ``seed`` exactly as the reference draws
    them (``seed=None``: head 2^16, no clean bits)."""
    device = dev.resolve(device)
    if seed is None:
        if init_chunks:
            raise ValueError(
                "fresh_stack: init_chunks requires a seed - clean bits "
                "are derived from it (pass seed=<int> or init_chunks=0)")
        return ans.make_stack(lanes, capacity, device=device)
    k_head, k_bits = prng.split(prng.PRNGKey(seed))
    stack = ans.make_stack(lanes, capacity, key=k_head, device=device)
    if init_chunks:
        stack = ans.seed_stack(stack, k_bits, init_chunks)
    return stack


def _on(data: Any, device: torch.device) -> Any:
    """``data`` (an array, or a tuple/list of them as ``Serial`` codes)
    as tensors on ``device``."""
    if isinstance(data, (tuple, list)):
        return type(data)(_on(x, device) for x in data)
    return dev.as_tensor(data, device)


def _numel(data: Any) -> int:
    if isinstance(data, (tuple, list)):
        return sum(_numel(x) for x in data)
    return data.numel()


def _default_capacity(data: Any, lanes: int, init_chunks: int) -> int:
    return max(256, _numel(data) // max(lanes, 1) + init_chunks + 64)


def compress(codec: Codec, data: Any, *, lanes: int,
             seed: Optional[int] = 0, init_chunks: int = 32,
             capacity: Optional[int] = None, max_retries: int = 6,
             precision: int = ans.DEFAULT_PRECISION,
             with_info: bool = False, device: dev.DeviceLike = None
             ) -> Union[bytes, Tuple[bytes, Dict[str, Any]]]:
    """Encode ``data`` (leading ``lanes`` axis; [n, lanes, ...] under
    ``Chained``; a tuple under ``Serial``) into a self-contained blob. On
    overflow the capacity doubles and on underflow the clean-bit supply
    quadruples, then the encode reruns; a corrupt blob is never returned.

    ``with_info=True`` returns ``(blob, info)`` with ``net_bits``, the
    information the encode added (the quantity that matches -ELBO).
    """
    device = dev.resolve(device)
    data = _on(data, device)
    cap = capacity or _default_capacity(data, lanes, init_chunks)
    chunks = 0 if seed is None else init_chunks
    for attempt in range(max_retries):
        stack0 = fresh_stack(lanes, cap, seed, chunks, device=device)
        bits_before = ans.stack_content_bits(stack0)
        stack = codec.push(stack0, data)
        over = int(stack.overflows.sum())
        under = int(stack.underflows.sum())
        if not over and not under:
            blob = _pack(stack, precision)
            if not with_info:
                return blob
            return blob, {
                "capacity": cap, "init_chunks": chunks, "seed": seed,
                "net_bits": float(ans.stack_content_bits(stack))
                - float(bits_before),
                "retries": attempt, **blob_info(blob)}
        if over:
            cap *= 2
        if under:
            if seed is None:
                raise RuntimeError(
                    "codecs.compress: stack underflow with seed=None - "
                    "this codec pops initial bits (bits-back); pass a "
                    "seed so clean bits can be supplied")
            chunks = max(32, chunks * 4)
    raise RuntimeError(
        f"codecs.compress: could not encode cleanly after {max_retries} "
        f"attempts (last capacity={cap}, init_chunks={chunks})")


def decompress(codec: Codec, blob: bytes, *,
               device: dev.DeviceLike = None) -> Any:
    """Decode a ``compress`` blob back to the original data, bit-exactly."""
    device = dev.resolve(device)
    msg, lengths, _ = _unpack(blob)
    stack = ans.unflatten(torch.from_numpy(msg.astype(np.int32)).to(device),
                          torch.from_numpy(lengths.astype(np.int64))
                          .to(device))
    stack, data = codec.pop(stack)
    ans.check_clean(stack, "codecs.decompress")
    return data


def blob_info(blob: bytes) -> Dict[str, Any]:
    """Parse a blob header: lanes, lengths, payload/header sizes in bits."""
    msg, lengths, precision = _unpack(blob)
    payload_bits = int(np.sum(lengths)) * 16
    return {
        "lanes": int(msg.shape[0]),
        "lengths": lengths,
        "precision": precision,
        "payload_bits": payload_bits,
        "header_bits": (len(blob) - payload_bits // 8) * 8,
        "total_bits": len(blob) * 8,
    }


def pack_lane_rows(msg: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate per-lane ``msg[l, :lengths[l]]`` rows into wire bytes
    (little-endian u16 chunks): the payload of a BBX1 blob and of a BBX2
    block."""
    msg = np.asarray(msg).astype("<u2", copy=False)
    lengths = np.asarray(lengths)
    # Row-major boolean selection = the lane rows, in lane order.
    rows = np.arange(msg.shape[1])[None, :] < lengths[:, None]
    return msg[rows].tobytes()


def unpack_lane_rows(buf: bytes, offset: int,
                     lengths: np.ndarray) -> np.ndarray:
    """Inverse of ``pack_lane_rows``: the padded uint16[lanes, width]
    message from the concatenated rows at ``offset`` in ``buf``."""
    lengths = np.asarray(lengths)
    total = int(lengths.sum())
    if len(buf) < offset + 2 * total:
        raise ValueError("codecs: truncated payload (lane rows short)")
    flat = np.frombuffer(buf, dtype="<u2", count=total, offset=offset)
    width = int(lengths.max()) if lengths.size else 0
    msg = np.zeros((lengths.shape[0], width), np.uint16)
    msg[np.arange(width)[None, :] < lengths[:, None]] = flat
    return msg


def _pack(stack: ans.ANSStack, precision: int) -> bytes:
    msg, lengths = ans.flatten(stack)
    lengths = lengths.cpu().numpy()
    return b"".join([_HEADER.pack(_MAGIC, _VERSION, precision, 0,
                                  len(lengths)),
                     lengths.astype("<u4").tobytes(),
                     pack_lane_rows(msg.cpu().numpy(), lengths)])


def _unpack(blob: bytes) -> Tuple[np.ndarray, np.ndarray, int]:
    if len(blob) < _HEADER.size:
        raise ContainerError("codecs: truncated blob (no header)")
    magic, version, precision, _flags, lanes = _HEADER.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise ContainerError(
            f"codecs: bad magic {magic!r} (not a BBX1 blob)")
    if version != _VERSION:
        raise ContainerError(
            f"codecs: unsupported container version {version}")
    if not 0 < precision <= ans.MAX_PRECISION:
        raise ContainerError(
            f"codecs: corrupt header (precision {precision} outside "
            f"[1, {ans.MAX_PRECISION}])")
    if not 0 < lanes <= _MAX_LANES:
        raise ContainerError(
            f"codecs: corrupt header (lane count {lanes})")
    off = _HEADER.size
    if len(blob) < off + 4 * lanes:
        raise ContainerError(
            f"codecs: truncated blob (header promises {lanes} lane "
            "lengths but the lengths block is short)")
    lengths = np.frombuffer(blob, dtype="<u4", count=lanes,
                            offset=off).astype(np.int64)
    if (lengths < 2).any():
        raise ContainerError("codecs: corrupt header (lane length < 2; "
                             "every lane carries a 2-chunk head flush)")
    off += 4 * lanes
    need = 2 * int(lengths.sum())
    if len(blob) - off != need:
        raise ContainerError(
            f"codecs: payload is {len(blob) - off} bytes but the lane "
            f"lengths sum to {need} (truncated or trailing garbage)")
    msg = unpack_lane_rows(blob, off, lengths)
    return msg, lengths.astype(np.int32), precision
