"""Incremental ``StreamEncoder``/``StreamDecoder`` over the BBX2 format
(port of ``repro.stream.coder``; the same wire, byte for byte).

The encoder takes time-major ``[n, lanes, ...]`` datapoints (a tensor,
or a tuple/list of them), buffers them and cuts the stream into blocks
of ``block_symbols`` datapoints. Each block is coded on a fresh
``ANSStack`` and framed on its own, so blocks decode independently:

  * block ``b+1`` starts from block ``b``'s final heads (carried on the
    encoder side only), so the head churn telescopes away;
  * bits-back codecs draw ``init_chunks`` clean chunks per block, seeded
    from ``fold_in(PRNGKey(seed), b)``; on overflow the capacity doubles
    and on underflow the clean-bit supply quadruples, and the block is
    coded again.

Within a block datapoints are pushed in reverse, so the decoder pops them
in natural order.

Fast paths, all with the same bytes: a static-table ``Categorical``
codes a whole block through ``kernels.ans.ops.push_many_table`` /
``pop_many`` (the ``pop_table_emit`` kernel on the card) with
``use_kernel=True``; ``compile=True`` lowers each block through
``codecs.compile`` (``BlockChain`` lowers its inner codec).

``pipeline=True`` keeps the reference's contract
(``repro/stream/coder.py:30-40``): block ``b+1``'s push is dispatched
against block ``b``'s final heads before ``b``'s overflow and underflow
counts are read; if ``b`` has to be redone, so is ``b+1``. The bytes are
those of the synchronous path.

Entry points take ``device=`` (``None`` means the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core import ans, prng
from repro_torch.core.codec import Codec
from repro_torch.core.distributions import Categorical
from repro_torch.codecs.compile import compile as compile_codec
from repro_torch.codecs.compile import register_lowering
from repro_torch.kernels.ans import ops as ans_ops
from repro_torch.stream import format as fmt

BlockCodecFn = Callable[[int], Codec]


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the tensors of one or more trees of tuples and lists
    (the datapoint structures ``Serial`` codes) with the same layout."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *kids) for kids in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [leaf for kid in tree for leaf in tree_leaves(kid)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class _PendingBlock:
    """A pushed block whose overflow/underflow counts are not read yet
    (``pipeline=True``); kept whole so it can be redone."""

    xs: Any
    k: int
    stack: ans.ANSStack
    bits_before: torch.Tensor
    cap: int
    chunks: int


@dataclasses.dataclass(frozen=True)
class EncoderSnapshot:
    """Resumable ``StreamEncoder`` state at a block boundary: the carried
    heads, the block counter (which pins the per-block clean bits), the
    grow-and-retry state and the wire offset. Plain Python values, the
    reference's fields."""

    lanes: int
    block_symbols: int
    precision: int
    seed: Optional[int]
    init_chunks: int
    capacity: Optional[int]
    n_blocks: int
    n_symbols: int
    wire_bytes: int
    net_bits: float
    started: bool
    heads: Optional[Tuple[int, ...]]   # carried per-lane heads, or None


@dataclasses.dataclass(frozen=True)
class BlockChain(Codec):
    """Chain ``inner`` over a leading time axis ``[k, lanes, ...]``:
    pushes datapoints in reverse so pops run in natural order."""

    inner: Codec
    k: int

    def push(self, stack: ans.ANSStack, xs: Any) -> ans.ANSStack:
        for t in reversed(range(self.k)):
            stack = self.inner.push(stack, tree_map(lambda a: a[t], xs))
        return stack

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, Any]:
        outs = []
        for _ in range(self.k):
            stack, x = self.inner.pop(stack)
            outs.append(x)
        return stack, tree_map(lambda *ls: torch.stack(ls, dim=0), *outs)


@dataclasses.dataclass(frozen=True)
class KernelTableBlock(Codec):
    """A block of ``k`` static-table categorical symbols (int[k, lanes],
    time-major) in one ``push_many_table`` / ``pop_many`` call: the same
    bytes as ``BlockChain(Categorical(...), k)``; ``kernels.dispatch``
    chooses the backend (the kernel on the card)."""

    table: torch.Tensor   # int64[lanes, A+1]
    k: int
    precision: int = ans.DEFAULT_PRECISION

    def push(self, stack: ans.ANSStack, xs: torch.Tensor) -> ans.ANSStack:
        return ans_ops.push_many_table(stack, self.table, xs.flip(0),
                                       self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        return ans_ops.pop_many(stack, self.table, self.k, self.precision)


# A BlockChain lowers by lowering its inner codec; the kernel block is
# already in its compiled form.
register_lowering(BlockChain, lambda c, rec: BlockChain(rec(c.inner), c.k))
register_lowering(KernelTableBlock, lambda c, rec: c)


def _resolve_block_codec(codec: Optional[Codec],
                         block_codec_fn: Optional[BlockCodecFn],
                         use_kernel: bool, compile: bool) -> BlockCodecFn:
    if block_codec_fn is None:
        if codec is None:
            raise ValueError("stream: pass a per-datapoint codec or a "
                             "block_codec_fn")
        if use_kernel and isinstance(codec, Categorical):
            table, prec = codec._table(), codec.precision
            block_codec_fn = lambda k: KernelTableBlock(table, k, prec)
        else:
            block_codec_fn = lambda k: BlockChain(codec, k)
    if not compile:
        return block_codec_fn
    # One lowered codec per block size (the ragged last block has its own).
    base, programs = block_codec_fn, {}

    def compiled_fn(k: int) -> Codec:
        if k not in programs:
            programs[k] = compile_codec(base(k))
        return programs[k]

    return compiled_fn


def _faults(stack: ans.ANSStack) -> Tuple[int, int]:
    """(overflows, underflows) of a coded block, in one read from the
    device: the one wait per block that grow-and-retry needs."""
    over, under = torch.stack([stack.overflows.sum(),
                               stack.underflows.sum()]).tolist()
    return over, under


def _refuse_verify(verify: bool, where: str) -> None:
    if verify:
        raise NotImplementedError(
            f"{where}(verify=True) needs the codec contract verifier "
            "(repro.analysis), which the port does not have yet (ROADMAP "
            "queue 1, item 11)")


class StreamEncoder:
    """Chunked streaming encoder: ``write`` returns the bytes that became
    final (the header first, then completed blocks), ``flush`` the
    ragged last block and the trailer. Flushing twice is a no-op;
    writing after a flush raises.

    ``seed=None`` starts cold (direct coding); an integer seed gives
    random first heads and the per-block clean bits of bits-back codecs.
    """

    def __init__(self, codec: Optional[Codec] = None, *, lanes: int,
                 block_symbols: int,
                 block_codec_fn: Optional[BlockCodecFn] = None,
                 seed: Optional[int] = 0, init_chunks: int = 0,
                 precision: int = ans.DEFAULT_PRECISION,
                 capacity: Optional[int] = None, max_retries: int = 6,
                 use_kernel: bool = True, compile: bool = False,
                 verify: bool = False, pipeline: bool = False,
                 device: dev.DeviceLike = None):
        if lanes < 1 or block_symbols < 1:
            raise ValueError("stream: lanes and block_symbols must be >= 1")
        if seed is None and init_chunks:
            raise ValueError("stream: init_chunks requires a seed (clean "
                             "bits are derived from it)")
        _refuse_verify(verify, "StreamEncoder")
        self.device = dev.resolve(device)
        self._block_codec_fn = _resolve_block_codec(codec, block_codec_fn,
                                                    use_kernel, compile)
        self.lanes = lanes
        self.block_symbols = block_symbols
        self.precision = precision
        self._seed = seed
        self._init_chunks = init_chunks
        self._capacity = capacity
        self._max_retries = max_retries
        self._buffer: List[Any] = []
        self._heads: Optional[torch.Tensor] = None
        self._pipeline = pipeline
        self._pending: Optional[_PendingBlock] = None
        self._started = False
        self._finished = False
        self.n_blocks = 0
        self.n_symbols = 0
        self.net_bits = 0.0
        self.wire_bytes = 0

    # -- input ---------------------------------------------------------------

    def write(self, data: Any) -> bytes:
        """Append time-major ``[n, lanes, ...]`` datapoints; returns the
        bytes that became final (b"" if no block completed)."""
        if self._finished:
            raise RuntimeError("stream: write after flush")
        data = tree_map(lambda a: dev.as_tensor(a, self.device), data)
        leaves = tree_leaves(data)
        n = leaves[0].shape[0]
        for leaf in leaves:
            if (leaf.dim() < 2 or leaf.shape[0] != n
                    or leaf.shape[1] != self.lanes):
                raise ValueError(
                    f"stream: data leaves must be [n, lanes={self.lanes}, "
                    f"...]; got {tuple(leaf.shape)}")
        for t in range(n):
            self._buffer.append(tree_map(lambda a: a[t], data))
        out = [self._header_bytes()]
        while len(self._buffer) >= self.block_symbols:
            block = self._buffer[:self.block_symbols]
            self._buffer = self._buffer[self.block_symbols:]
            if self._pipeline:
                out.append(self._encode_block_pipelined(block))
            else:
                out.append(self._encode_block(block))
        return self._emit(b"".join(out))

    def flush(self) -> bytes:
        """Emit the ragged last block (if any) and the trailer."""
        if self._finished:
            return b""
        out = [self._header_bytes()]
        if self._pending is not None:
            out.append(self._finalize_pending()[0])
        if self._buffer:
            block, self._buffer = self._buffer, []
            out.append(self._encode_block(block))
        out.append(fmt.encode_trailer(
            fmt.Trailer(self.n_blocks, self.n_symbols)))
        self._finished = True
        return self._emit(b"".join(out))

    def drain(self) -> bytes:
        """The bytes of a ``pipeline=True`` encoder's in-flight block (b""
        when none is); call before ``snapshot``."""
        if self._pending is None:
            return b""
        return self._emit(self._finalize_pending()[0])

    @property
    def buffered_symbols(self) -> int:
        """Datapoints written but not on the wire yet (0 exactly at block
        boundaries, where ``snapshot`` is legal)."""
        return len(self._buffer)

    # -- checkpoint / resume -------------------------------------------------

    def snapshot(self) -> EncoderSnapshot:
        """Resumable state at the current block boundary; legal with no
        buffered datapoints, no block in flight and before ``flush``."""
        if self._finished:
            raise RuntimeError("stream: snapshot after flush")
        if self._pending is not None:
            raise RuntimeError(
                "stream: snapshot with a pipelined block in flight - "
                "call drain() first (its bytes belong on the wire)")
        if self._buffer:
            raise RuntimeError(
                f"stream: snapshot mid-block ({len(self._buffer)} "
                "datapoints buffered) - write a multiple of "
                "block_symbols, or flush instead")
        heads = (tuple(int(h) for h in self._heads.cpu().tolist())
                 if self._heads is not None else None)
        return EncoderSnapshot(
            lanes=self.lanes, block_symbols=self.block_symbols,
            precision=self.precision, seed=self._seed,
            init_chunks=self._init_chunks, capacity=self._capacity,
            n_blocks=self.n_blocks, n_symbols=self.n_symbols,
            wire_bytes=self.wire_bytes, net_bits=self.net_bits,
            started=self._started, heads=heads)

    @classmethod
    def resume(cls, codec: Optional[Codec], snap: EncoderSnapshot,
               **kwargs) -> "StreamEncoder":
        """An encoder that continues a ``snapshot()``'s byte stream
        exactly; ``kwargs`` are execution choices (``use_kernel``,
        ``compile``, ``pipeline``, ``device``...)."""
        enc = cls(codec, lanes=snap.lanes, block_symbols=snap.block_symbols,
                  precision=snap.precision, seed=snap.seed,
                  init_chunks=snap.init_chunks, capacity=snap.capacity,
                  **kwargs)
        enc._started = snap.started
        enc.n_blocks = snap.n_blocks
        enc.n_symbols = snap.n_symbols
        enc.wire_bytes = snap.wire_bytes
        enc.net_bits = snap.net_bits
        if snap.heads is not None:
            if len(snap.heads) != snap.lanes:
                raise ValueError(
                    f"stream: snapshot heads have {len(snap.heads)} "
                    f"lanes, expected {snap.lanes}")
            enc._heads = torch.tensor(snap.heads, dtype=torch.int64,
                                      device=enc.device)
        return enc

    # -- internals -----------------------------------------------------------

    def _emit(self, payload: bytes) -> bytes:
        self.wire_bytes += len(payload)
        return payload

    def _header_bytes(self) -> bytes:
        if self._started:
            return b""
        self._started = True
        return fmt.encode_header(fmt.StreamHeader(
            lanes=self.lanes, block_symbols=self.block_symbols,
            precision=self.precision))

    def _default_capacity(self, block: List[Any]) -> int:
        per_lane = sum(int(np.prod(leaf.shape[1:]))
                       for leaf in tree_leaves(block[0]))
        return max(256, self.block_symbols * per_lane
                   + self._init_chunks + 64)

    def _block_stack(self, capacity: int, chunks: int, block_index: int,
                     heads: Optional[torch.Tensor]) -> ans.ANSStack:
        key = (prng.fold_in(prng.PRNGKey(self._seed), block_index)
               if self._seed is not None else None)
        if heads is not None:
            stack = ans.make_stack(self.lanes, capacity, device=self.device)
            stack = stack.replace(head=heads.clone())
        elif key is not None:
            k_head, _ = prng.split(key)
            stack = ans.make_stack(self.lanes, capacity, key=k_head,
                                   device=self.device)
        else:
            stack = ans.make_stack(self.lanes, capacity, device=self.device)
        if chunks:
            _, k_bits = prng.split(key)
            stack = ans.seed_stack(stack, k_bits, chunks)
        return stack

    def _push_once(self, xs: Any, k: int, cap: int, chunks: int,
                   heads: Optional[torch.Tensor],
                   block_index: int) -> Tuple[ans.ANSStack, torch.Tensor]:
        """Push one block onto a fresh stack; nothing here waits for the
        device (the content bits stay a tensor until ``_commit``)."""
        codec = self._block_codec_fn(k)
        stack0 = self._block_stack(cap, chunks, block_index, heads)
        bits_before = ans.stack_content_bits(stack0)
        return codec.push(stack0, xs), bits_before

    def _grow(self, over: int, under: int, cap: int,
              chunks: int) -> Tuple[int, int]:
        if over:
            cap *= 2
        if under:
            if self._seed is None:
                raise RuntimeError(
                    "stream: stack underflow with seed=None - this "
                    "codec pops initial bits (bits-back); pass a seed "
                    "so per-block clean bits can be supplied")
            chunks = max(32, chunks * 4)
        return cap, chunks

    def _commit(self, stack: ans.ANSStack, bits_before: torch.Tensor,
                k: int, cap: int, chunks: int) -> bytes:
        self.net_bits += (float(ans.stack_content_bits(stack))
                          - float(bits_before))
        self._heads = stack.head
        self._capacity, self._init_chunks = cap, chunks
        msg, lengths = ans.flatten(stack)
        lengths = lengths.cpu().numpy()
        # Only the used columns leave the card.
        width = int(lengths.max())
        self.n_blocks += 1
        self.n_symbols += k
        return fmt.encode_block(k, msg[:, :width].cpu().numpy(), lengths)

    def _encode_sync(self, xs: Any, k: int, cap: int, chunks: int,
                     retries: int) -> bytes:
        for _ in range(retries):
            stack, bits_before = self._push_once(
                xs, k, cap, chunks, self._heads, self.n_blocks)
            over, under = _faults(stack)
            if not over and not under:
                return self._commit(stack, bits_before, k, cap, chunks)
            cap, chunks = self._grow(over, under, cap, chunks)
        raise RuntimeError(
            f"stream: could not encode block cleanly after "
            f"{self._max_retries} attempts (capacity={cap}, "
            f"init_chunks={chunks})")

    def _stacked(self, block: List[Any]) -> Any:
        return tree_map(lambda *ls: torch.stack(ls, dim=0), *block)

    def _encode_block(self, block: List[Any]) -> bytes:
        cap = self._capacity or self._default_capacity(block)
        return self._encode_sync(self._stacked(block), len(block), cap,
                                 self._init_chunks, self._max_retries)

    def _finalize_pending(self) -> Tuple[bytes, bool]:
        """Read the in-flight block's counts; returns (its bytes, whether
        it had to be redone with a grown capacity or clean-bit supply)."""
        pend = self._pending
        self._pending = None
        over, under = _faults(pend.stack)
        if not over and not under:
            return self._commit(pend.stack, pend.bits_before, pend.k,
                                pend.cap, pend.chunks), False
        cap, chunks = self._grow(over, under, pend.cap, pend.chunks)
        return self._encode_sync(pend.xs, pend.k, cap, chunks,
                                 self._max_retries - 1), True

    def _encode_block_pipelined(self, block: List[Any]) -> bytes:
        """Push block ``b+1`` from the in-flight block ``b``'s final
        heads, then read ``b``'s counts; returns ``b``'s bytes (b"" for
        the first block)."""
        k, xs = len(block), self._stacked(block)
        cap = self._capacity or self._default_capacity(block)
        chunks = self._init_chunks
        if self._pending is None:
            stack, bits = self._push_once(xs, k, cap, chunks, self._heads,
                                          self.n_blocks)
            self._pending = _PendingBlock(xs, k, stack, bits, cap, chunks)
            return b""
        stack, bits = self._push_once(xs, k, cap, chunks,
                                      self._pending.stack.head,
                                      self.n_blocks + 1)
        done, retried = self._finalize_pending()
        if retried:
            # Block b was redone, so b+1 started from stale heads: redo it
            # from the corrected ones.
            cap = self._capacity or cap
            chunks = self._init_chunks
            stack, bits = self._push_once(xs, k, cap, chunks, self._heads,
                                          self.n_blocks)
        self._pending = _PendingBlock(xs, k, stack, bits, cap, chunks)
        return done


class StreamDecoder:
    """Incremental BBX2 decoder: feed bytes in any pieces, collect the
    decoded blocks (time-major ``[k, lanes, ...]``) as they complete.
    With ``header=`` (from ``format.scan``) the feed may start at any
    block boundary."""

    def __init__(self, codec: Optional[Codec] = None, *,
                 block_codec_fn: Optional[BlockCodecFn] = None,
                 header: Optional[fmt.StreamHeader] = None,
                 use_kernel: bool = True, verify_trailer: bool = True,
                 compile: bool = False, verify: bool = False,
                 device: dev.DeviceLike = None):
        _refuse_verify(verify, "StreamDecoder")
        self.device = dev.resolve(device)
        self._block_codec_fn = _resolve_block_codec(codec, block_codec_fn,
                                                    use_kernel, compile)
        self._header = header
        self._verify_trailer = verify_trailer
        self._buf = bytearray()
        self._finished = False
        self.n_blocks = 0
        self.n_symbols = 0
        self.trailer: Optional[fmt.Trailer] = None

    @property
    def header(self) -> Optional[fmt.StreamHeader]:
        return self._header

    @property
    def finished(self) -> bool:
        return self._finished

    def read(self, chunk: bytes = b"") -> List[Any]:
        """Feed bytes; returns the blocks they completed."""
        self._buf.extend(chunk)
        out: List[Any] = []
        if self._header is None:
            parsed = fmt.decode_header(bytes(self._buf))
            if parsed is None:
                return out
            self._header, off = parsed
            del self._buf[:off]
        while not self._finished:
            res = fmt.decode_next(bytes(self._buf), 0, self._header.lanes)
            if res is None:
                break
            frame, off = res
            del self._buf[:off]
            if isinstance(frame, fmt.Trailer):
                self.trailer = frame
                self._finished = True
                if self._verify_trailer and (
                        frame.n_blocks != self.n_blocks
                        or frame.total_symbols != self.n_symbols):
                    raise ValueError(
                        f"stream: trailer mismatch (saw {self.n_blocks} "
                        f"blocks/{self.n_symbols} symbols, trailer says "
                        f"{frame.n_blocks}/{frame.total_symbols}) - "
                        "stream truncated or resumed mid-way")
                break
            out.append(self._decode_block(frame))
        return out

    def _decode_block(self, block: fmt.Block) -> Any:
        # A few spare slots for the bits-back posterior re-pushes of a
        # chunk-less block.
        msg = torch.from_numpy(block.msg.astype(np.int32)).to(self.device)
        lengths = torch.from_numpy(block.lengths.astype(np.int64)) \
            .to(self.device)
        stack = ans.unflatten(msg, lengths,
                              capacity=max(block.msg.shape[1] - 2, 8))
        stack, xs = self._block_codec_fn(block.n_symbols).pop(stack)
        over, under = _faults(stack)
        if under or over:
            raise ValueError(
                f"stream: corrupt block {self.n_blocks} "
                f"({under} underflows, {over} overflows during decode)")
        self.n_blocks += 1
        self.n_symbols += block.n_symbols
        return xs


# ---------------------------------------------------------------------------
# One-call conveniences
# ---------------------------------------------------------------------------

def encode_stream(codec: Optional[Codec], data: Any, *, lanes: int,
                  block_symbols: int, **kwargs) -> bytes:
    """The whole of ``data`` through one ``StreamEncoder``."""
    enc = StreamEncoder(codec, lanes=lanes, block_symbols=block_symbols,
                        **kwargs)
    return enc.write(data) + enc.flush()


def _concat_blocks(blocks: List[Any]) -> Any:
    if not blocks:
        return None
    return tree_map(lambda *ls: torch.cat(ls, dim=0), *blocks)


def decode_stream(codec: Optional[Codec], blob: bytes, **kwargs) -> Any:
    """A complete BBX2 stream back to time-major ``[n, lanes, ...]``;
    raises if the trailer is missing."""
    dec = StreamDecoder(codec, **kwargs)
    blocks = dec.read(blob)
    if not dec.finished:
        raise ValueError("stream: truncated (no trailer)")
    return _concat_blocks(blocks)


def decode_from_offset(codec: Optional[Codec], blob: bytes, offset: int,
                       **kwargs) -> Any:
    """Decode from the block boundary at byte ``offset`` on (offsets from
    ``format.scan``); reads the header from the front of ``blob`` and no
    payload byte before ``offset``, and skips the trailer count check."""
    parsed = fmt.decode_header(blob)
    if parsed is None:
        raise ValueError("stream: truncated (no header)")
    dec = StreamDecoder(codec, header=parsed[0], verify_trailer=False,
                        **kwargs)
    return _concat_blocks(dec.read(blob[offset:]))
