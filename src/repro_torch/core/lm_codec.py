"""Lossless token-stream compression with an LM backbone (port of
``repro.core.lm_codec``): direct ANS coding with the LM's next-token
distribution, the latent-free special case of BB-ANS.

DETERMINISM CONTRACT: encoder and decoder must derive bit-identical
coding tables. A teacher-forced parallel ``forward`` and the incremental
cached decode are equal in exact arithmetic but not in float, and one
differing bit in a logit can move a table boundary and corrupt the
stream. So both sides compute every logit through the same
``transformer.decode_step`` at the same shapes (lanes, cache length),
token by token. On the card cuBLAS picks its kernel by shape, so a blob
decodes on the kind of device, and at the lane count, it was encoded
with (ROADMAP H10). The tokens are coded with ``FactoredCategorical``
(chunks of 256), whose tables equal the reference's for equal float32
logits.

The masked variants (``encode_tokens_masked``/``decode_tokens_masked``)
need ``ans.select_lanes`` and wait for the batcher (ROADMAP queue 1,
item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import torch

from repro_torch.core import ans
from repro_torch.core.codec import Codec
from repro_torch.core.distributions import FactoredCategorical
from repro_torch.models import transformer

BOS = 0


def _device(params) -> torch.device:
    return params["embed"]["table"].device


def collect_decoder_logits(params: Any, cfg: Any,
                           tokens: torch.Tensor) -> List[torch.Tensor]:
    """Teacher-forced logits, float32 [lanes, V] per position, through the
    decoder's own step."""
    lanes, n = tokens.shape
    device = _device(params)
    tokens = tokens.to(device)
    state = transformer.init_decode_state(cfg, lanes, max_len=n,
                                          device=device)
    tok = torch.full((lanes, 1), BOS, dtype=torch.int32, device=device)
    out = []
    for t in range(n):
        logits, state = transformer.decode_step(params, cfg, tok, state)
        out.append(logits[:, 0].to(torch.float32))
        tok = tokens[:, t:t + 1]
    return out


def encode_tokens(params: Any, cfg: Any, tokens: torch.Tensor,
                  stack: ans.ANSStack,
                  precision: int = ans.DEFAULT_PRECISION) -> ans.ANSStack:
    """tokens int[lanes, N] -> stack with N symbols/lane pushed, in
    reverse order so that the decoder pops them forward."""
    n = tokens.shape[1]
    logits = collect_decoder_logits(params, cfg, tokens)
    tokens = tokens.to(stack.device)
    for t in reversed(range(n)):
        stack = FactoredCategorical(logits[t], precision=precision).push(
            stack, tokens[:, t])
    return stack


def decode_tokens(params: Any, cfg: Any, stack: ans.ANSStack, n: int,
                  precision: int = ans.DEFAULT_PRECISION
                  ) -> Tuple[ans.ANSStack, torch.Tensor]:
    """Pop n tokens/lane, regenerating the logits autoregressively
    through the step the encoder used."""
    lanes = stack.lanes
    device = _device(params)
    state = transformer.init_decode_state(cfg, lanes, max_len=n,
                                          device=device)
    tok = torch.full((lanes, 1), BOS, dtype=torch.int32, device=device)
    out = []
    for _ in range(n):
        logits, state = transformer.decode_step(params, cfg, tok, state)
        stack, sym = FactoredCategorical(
            logits[:, 0].to(torch.float32), precision=precision).pop(stack)
        out.append(sym)
        tok = sym[:, None].to(torch.int32)
    return stack, torch.stack(out, dim=1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class TokenStream(Codec):
    """Token-stream coding as a ``Codec``; the symbol is int[lanes, n].

        blob = codecs.compress(TokenStream(params, cfg, n), tokens,
                               lanes=lanes, seed=None, init_chunks=0)
    """

    params: Any
    cfg: Any
    n: int
    precision: int = ans.DEFAULT_PRECISION

    def push(self, stack: ans.ANSStack, tokens: torch.Tensor
             ) -> ans.ANSStack:
        return encode_tokens(self.params, self.cfg, tokens, stack,
                             self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        return decode_tokens(self.params, self.cfg, stack, self.n,
                             self.precision)


def expected_bits(params: Any, cfg: Any, tokens: torch.Tensor) -> float:
    """Cross-entropy of the model on the stream, bits (the coding bound),
    from the parallel teacher-forced forward (analysis only)."""
    tokens = tokens.to(_device(params))
    inp = torch.cat([torch.full((tokens.shape[0], 1), BOS,
                                dtype=tokens.dtype, device=tokens.device),
                     tokens[:, :-1]], dim=1)
    logits, _ = transformer.forward(params, cfg, inp)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tgt = logp.gather(-1, tokens[..., None].to(torch.int64))[..., 0]
    return float(-tgt.sum() / math.log(2.0))
