"""``repro_torch.stream`` - the BBX2 block stream and the BBX3 corpus
framing (port of ``repro.stream``, less the dynamic batcher, which comes
with the serving engine)::

    enc = stream.StreamEncoder(codec, lanes=16, block_symbols=64)
    wire = enc.write(xs) + enc.flush()       # xs [n, 16, ...]
    xs2 = stream.decode_stream(codec, wire)
    tail = stream.decode_from_offset(codec, wire, off)
"""

from repro_torch.stream import format  # noqa: F401  (BBX2 + BBX3)
from repro_torch.stream.coder import (BlockChain, EncoderSnapshot,
                                      KernelTableBlock, StreamDecoder,
                                      StreamEncoder, decode_from_offset,
                                      decode_stream, encode_stream)
from repro_torch.stream.format import (corpus_assignments, corpus_segment,
                                       encode_corpus, scan_corpus,
                                       shard_host)

__all__ = [
    "format",
    "BlockChain", "KernelTableBlock",
    "StreamEncoder", "StreamDecoder", "EncoderSnapshot",
    "encode_stream", "decode_stream", "decode_from_offset",
    "encode_corpus", "scan_corpus", "corpus_segment",
    "shard_host", "corpus_assignments",
]
