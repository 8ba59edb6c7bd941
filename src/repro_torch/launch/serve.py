"""Serving/compression launcher (port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen2-0.5b --mode compress``
trains nothing: it builds a reduced model (``reduced(get(arch))``, vocab
256) on random weights from ``--seed``, runs the compression service end
to end on a synthetic Markov corpus and reports rates; ``--mode stream``
runs the chunked BBX2 streaming path and checks a mid-stream resume;
``--mode generate`` runs batched greedy decoding. It prints the
reference's lines. The other modes (``serve-many``, ``hvae``,
``gateway``, ``cluster``) need the batcher, the codec engines and the
gateway and raise ``NotImplementedError`` (ROADMAP queue 1, item 5).

It runs on the card; ``--device cpu`` runs the plain PyTorch path. The
SIGINT flush of open streams comes with the gateway (item 5).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import codecs, stream
from repro_torch import device as dev
from repro_torch.configs import base as cfg_base
from repro_torch.data import tokens as tok_data
from repro_torch.models import transformer
from repro_torch.serve.engine import Engine

MODES = ("compress", "stream", "serve-many", "generate", "hvae", "gateway",
         "cluster")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--mode", default="compress", choices=MODES)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--block-symbols", type=int, default=16)
    ap.add_argument("--requests", type=int, default=12,
                    help="number of client streams for --mode serve-many")
    ap.add_argument("--hosts", type=int, default=2,
                    help="gateway hosts for --mode cluster")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compile", action="store_true",
                    help="route codecs through codecs.compile (the "
                         "gateway and hvae modes)")
    ap.add_argument("--kv-dtype", default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.mode not in ("compress", "stream", "generate"):
        raise NotImplementedError(
            f"launch.serve: --mode {args.mode} needs the batcher, the codec "
            "engines and the gateway (ROADMAP queue 1, item 5)")

    device = dev.resolve(args.device)
    cfg = dataclasses.replace(
        cfg_base.reduced(cfg_base.get(args.arch)),
        vocab=256, kv_cache_dtype=args.kv_dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init(cfg, gen, device=device)
    eng = Engine(params, cfg, max_len=args.tokens, jit=False, device=device)

    if args.mode == "generate":
        prompt = {"tokens": torch.from_numpy(
            np.random.default_rng(args.seed).integers(
                0, cfg.vocab, (args.lanes, 8)).astype(np.int32))}
        t0 = time.perf_counter()
        out = eng.generate(prompt, args.tokens)
        dt = time.perf_counter() - t0
        print(f"generated {tuple(out.shape)} in {dt:.2f}s "
              f"({out.numel() / dt:.1f} tok/s, untrained weights)")
        return

    corpus, entropy = tok_data.markov_corpus(
        50_000, vocab=cfg.vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed + 1)
    starts = rng.integers(0, len(corpus) - args.tokens, args.lanes)
    toks = torch.from_numpy(
        np.stack([corpus[s:s + args.tokens] for s in starts])
        .astype(np.int32)).to(device)

    if args.mode == "stream":
        t0 = time.perf_counter()
        blob = eng.compress_stream(toks, block_symbols=args.block_symbols)
        enc = time.perf_counter() - t0
        header, offsets, trailer = stream.format.scan(blob)
        out = eng.decompress_stream(blob)
        ok = bool(torch.equal(out, toks))
        print(f"corpus entropy {entropy:.3f} bits/tok; streamed "
              f"{len(blob) * 8 / toks.numel():.3f} wire bits/tok over "
              f"{len(offsets)} blocks; lossless={ok}; encode {enc:.2f}s")
        if len(offsets) > 1:
            tail = stream.decode_from_offset(
                None, blob, offsets[1],
                block_codec_fn=eng._block_codec_fn(), device=device)
            ok2 = bool(torch.equal(tail.T, toks[:, args.block_symbols:]))
            print(f"mid-stream resume from block 1 "
                  f"(byte {offsets[1]}): lossless={ok2}")
        return

    t0 = time.perf_counter()
    blob = eng.compress(toks)
    enc = time.perf_counter() - t0
    bits = codecs.blob_info(blob)["payload_bits"]
    out = eng.decompress(blob, args.tokens)
    ok = bool(torch.equal(out, toks))
    print(f"corpus entropy {entropy:.3f} bits/tok; achieved "
          f"{bits / toks.numel():.3f} bits/tok (untrained model: ~log2 V); "
          f"lossless={ok}; encode {enc:.2f}s")


if __name__ == "__main__":
    main()
