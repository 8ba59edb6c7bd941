"""The LM serving engine (port of ``repro.serve.engine.Engine``):
prefill/decode sessions, greedy generation, and token-stream compression,
one-shot (BBX1) and streamed (BBX2).

PyTorch runs eagerly, so there is no compiled ``prefill_step`` or
``serve_step``: ``Engine(jit=...)`` accepts the argument and ignores it.
The decode step updates a session's caches in place (the reference
donates them). The multi-request service (``serve_many``/
``decompress_many``), lane admission (``try_admit``/``retire``) and the
codec engines wait for the batcher (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import codecs, stream
from repro_torch import device as dev
from repro_torch.core import lm_codec
from repro_torch.core.codec import FnCodec
from repro_torch.models import transformer


class Engine:
    """The LM serving engine: sessionful generation plus the token
    compression service.

    Example::

        eng = Engine(params, cfg, max_len=128)
        toks = eng.generate(batch, n_tokens=16)      # greedy continue
        blob = eng.compress(token_streams)           # lossless LM-ANS

    ``params`` live on ``device`` (``None``: the card); inputs are moved
    there.
    """

    def __init__(self, params, cfg, max_len: int = 2048, jit: bool = True,
                 *, device: dev.DeviceLike = None):
        transformer.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.device = dev.resolve(device)

    # -- session ------------------------------------------------------------

    def start(self, batch: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill the prompt; returns (last logits [B,1,V], session)."""
        batch = {k: dev.as_tensor(v, self.device) for k, v in batch.items()}
        return transformer.prefill(self.params, self.cfg, batch,
                                   self.max_len)

    def step(self, tok: torch.Tensor, session: Dict[str, Any]):
        return transformer.decode_step(self.params, self.cfg,
                                       dev.as_tensor(tok, self.device),
                                       session)

    def generate(self, batch: Dict[str, torch.Tensor], n_tokens: int
                 ) -> torch.Tensor:
        """Greedy continuation of the prompt; int32 [B, n_tokens]."""
        logits, session = self.start(batch)
        toks = []
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        for _ in range(n_tokens):
            toks.append(tok[:, 0])
            logits, session = self.step(tok, session)
            tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
        return torch.stack(toks, dim=1)

    # -- compression service --------------------------------------------------

    def compress(self, tokens: torch.Tensor, capacity_factor: float = 1.5
                 ) -> bytes:
        """Losslessly compress token streams [lanes, N] with the LM into a
        BBX1 container blob. Direct coding needs no clean bits, so the
        stack starts cold (``seed=None``) and the blob is deterministic."""
        lanes, n = tokens.shape
        codec = lm_codec.TokenStream(self.params, self.cfg, n)
        return codecs.compress(
            codec, tokens, lanes=lanes, seed=None, init_chunks=0,
            capacity=int(n * capacity_factor) + 8, device=self.device)

    def decompress(self, blob: bytes, n: int) -> torch.Tensor:
        codec = lm_codec.TokenStream(self.params, self.cfg, n)
        return codecs.decompress(codec, blob, device=self.device)

    # -- streaming service ----------------------------------------------------

    def _block_codec_fn(self):
        """BBX2 block codec: TokenStream over one block, transposed to
        the stream layer's time-major [k, lanes] layout."""
        def fn(k: int):
            inner = lm_codec.TokenStream(self.params, self.cfg, k)

            def push(stack, xs):
                return inner.push(stack, xs.T.to(torch.int32))

            def pop(stack):
                stack, toks = inner.pop(stack)
                return stack, toks.T

            return FnCodec(push, pop)
        return fn

    def compress_stream(self, tokens: torch.Tensor, *,
                        block_symbols: int = 64,
                        capacity_factor: float = 1.5) -> bytes:
        """Chunked-streaming compress of token streams [lanes, N] into a
        BBX2 blob: every ``block_symbols`` tokens a lane become an
        independently decodable block (``stream.decode_from_offset``
        resumes at any block). The LM context is block-local."""
        lanes, n = tokens.shape
        enc = stream.StreamEncoder(
            block_codec_fn=self._block_codec_fn(),
            lanes=lanes, block_symbols=block_symbols, seed=None,
            capacity=int(block_symbols * capacity_factor) + 8,
            device=self.device)
        return enc.write(dev.as_tensor(tokens, self.device).T) + enc.flush()

    def decompress_stream(self, blob: bytes) -> Optional[torch.Tensor]:
        """Decode a ``compress_stream`` blob back to [lanes, N]."""
        out = stream.decode_stream(None, blob,
                                   block_codec_fn=self._block_codec_fn(),
                                   device=self.device)
        return out.T if out is not None else out
