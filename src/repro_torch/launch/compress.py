"""Dataset compression launcher - the Table-1 reproduction CLI (port of
``repro.launch.compress``).

``python -m repro_torch.launch.compress`` trains the paper's VAE on
synthetic binarized MNIST with AdamW, then streams the test corpus
through the lane-sharded BB-ANS pipeline (``repro_torch.shard_codec``),
compiled onto the card's kernels, and ends with the paper's Table-1
comparison - BB-ANS bits/dim against gzip, bz2, lzma and per-image PNG -
and a lossless full decode. It exits with an error unless the decode is
lossless and BB-ANS beats gzip and bz2.

    PYTHONPATH=src python -m repro_torch.launch.compress \\
        --arch vae-bernoulli --images 512 --train-steps 400

It runs on the card (``--shards`` defaults to the number of visible
cards; every shard is placed on the current one). The functions take
``device=`` (``None`` means the card); the tests call them with
``device="cpu"``. ``--arch vae-beta_binomial`` and ``hvae-small2`` are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch import shard_codec
from repro_torch.codecs import Codec
from repro_torch.data import baselines as baseline_lib
from repro_torch.data import synthetic_mnist
from repro_torch.models import vae as vae_lib
from repro_torch.optim import adamw

ARCHS = ("vae-bernoulli", "vae-beta_binomial", "hvae-small2")


def _check_arch(arch: str) -> None:
    if arch == "vae-beta_binomial":
        raise NotImplementedError(
            "--arch vae-beta_binomial: the BetaBinomial likelihood is not "
            "ported yet (ROADMAP queue 1, item 3)")
    if arch == "hvae-small2":
        raise NotImplementedError(
            "--arch hvae-small2: the HVAE and Bit-Swap are not ported yet "
            "(ROADMAP queue 1, item 4)")
    if arch not in ARCHS:
        raise ValueError(f"unknown --arch {arch!r}; choose from {ARCHS}")


def train_dataset_model(arch: str, *, steps: int, seed: int = 0,
                        n_train: int = 8000, batch: int = 128,
                        lr: float = 1e-3, device: dev.DeviceLike = None
                        ) -> Tuple[Callable[..., Codec], bool, float]:
    """Train the model behind ``--arch``; returns ``(per-datapoint codec
    factory, binary?, test -ELBO in bits/dim)``. The factory builds the
    codec on the weights' device, or on ``device=`` when given.

    The reference's steps: the same synthetic digits, the batches drawn
    by numpy ``default_rng(seed)``, AdamW under ``cosine_lr(lr, 100,
    steps)``, the -ELBO averaged over four noise draws on 1024 test
    images. The initial weights and the noise come from torch generators
    seeded ``seed``, ``seed + 1`` and ``seed + 2``, so they are not the
    reference's numbers.
    """
    _check_arch(arch)
    device = dev.resolve(device)
    cfg = vae_lib.paper_config("bernoulli")
    train_imgs, _ = synthetic_mnist.load("train", n_train, seed)
    train_imgs = synthetic_mnist.binarize(train_imgs, seed)
    test_imgs, _ = synthetic_mnist.load("test", 1024, seed)
    test_imgs = synthetic_mnist.binarize(test_imgs, seed + 1)
    params = vae_lib.init(cfg, torch.Generator().manual_seed(seed),
                          device=device)
    opt = adamw.AdamW(learning_rate=adamw.cosine_lr(lr, 100, steps))
    state = opt.init(params)
    train = dev.upload(train_imgs.astype(np.int32), device)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = dev.upload(rng.integers(0, len(train_imgs), batch), device)
        live = adamw.tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
        loss = vae_lib.loss(live, cfg, noise, train[idx])
        grads = iter(torch.autograd.grad(loss, adamw.tree_leaves(live)))
        grads = adamw.tree_map(lambda _: next(grads), live)
        params, state = opt.update(grads, state, live)
    test = dev.upload(test_imgs.astype(np.int32), device)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        elbo = float(np.mean([float(vae_lib.elbo_bits_per_dim(
            params, cfg, gen, test)) for _ in range(4)]))
    def make_codec(device: dev.DeviceLike = None) -> Codec:
        on = params if device is None else adamw.tree_map(
            lambda t: t.to(dev.resolve(device)), params)
        return vae_lib.make_bb_codec(on, cfg)

    return make_codec, True, elbo


def load_corpus(arch: str, n_images: int, lanes: int, seed: int = 123,
                device: dev.DeviceLike = None
                ) -> Tuple[np.ndarray, torch.Tensor, bool]:
    """The benchmark corpus: ``(images uint8 [n, 784], data int32
    [n // lanes, lanes, 784] on ``device``, binary?)``."""
    _check_arch(arch)
    imgs, _ = synthetic_mnist.load("test", n_images, seed)
    imgs = synthetic_mnist.binarize(imgs, seed)
    data = dev.upload(imgs.reshape(-1, lanes, 784).astype(np.int32),
                      dev.resolve(device))
    return imgs, data, True


def compress_corpus(codec: Codec, data: Any, *, n_shards: int,
                    block_symbols: int, seed: int, init_chunks: int = 32,
                    compile: bool = True,
                    device: dev.DeviceLike = None) -> bytes:
    """``shard_codec.compress_dataset`` with the CLI's defaults, every
    shard on ``device``."""
    return shard_codec.compress_dataset(
        codec, data, n_shards=n_shards, block_symbols=block_symbols,
        seed=seed, init_chunks=init_chunks, compile=compile,
        devices=[dev.resolve(device)] * n_shards)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on the card; returns the figures it printed, the blob,
    the corpus and the codec factory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vae-bernoulli", choices=ARCHS)
    ap.add_argument("--images", type=int, default=512,
                    help="test images to compress (the 'full set')")
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--lanes", type=int, default=8,
                    help="total ANS lanes (must divide by --shards)")
    ap.add_argument("--shards", type=int, default=0,
                    help="lane shards / BBX3 segments (0 = one per "
                         "visible card)")
    ap.add_argument("--block-symbols", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-compile", action="store_true",
                    help="skip codecs.compile (slow interpreted path)")
    ap.add_argument("--skip-decode", action="store_true",
                    help="skip the lossless full-decode verification")
    args = ap.parse_args(argv)

    device = dev.resolve(None)
    n_shards = args.shards or torch.cuda.device_count()
    if args.lanes % n_shards:
        raise SystemExit(f"--lanes {args.lanes} must divide into "
                         f"{n_shards} shards")
    if args.images % args.lanes:
        raise SystemExit(f"--images {args.images} must be a multiple "
                         f"of --lanes {args.lanes}")
    print(f"device={torch.cuda.get_device_name(device)} shards={n_shards} "
          f"lanes={args.lanes} arch={args.arch}", flush=True)

    t0 = time.perf_counter()
    make_codec, binary, elbo = train_dataset_model(
        args.arch, steps=args.train_steps, seed=args.seed, device=device)
    train_s = time.perf_counter() - t0
    print(f"trained in {train_s:.1f}s; test -ELBO = {elbo:.4f} bits/dim",
          flush=True)

    imgs, data, _ = load_corpus(args.arch, args.images, args.lanes,
                                device=device)
    codec = make_codec()
    t0 = time.perf_counter()
    blob = compress_corpus(codec, data, n_shards=n_shards,
                           block_symbols=args.block_symbols, seed=args.seed,
                           compile=not args.no_compile, device=device)
    t_enc = time.perf_counter() - t0
    bpd = len(blob) * 8 / imgs.size
    info = shard_codec.corpus_info(blob)
    print(f"encoded {args.images} images in {t_enc:.2f}s "
          f"({args.images / t_enc:.1f} images/s): {len(blob)} wire bytes "
          f"over {info['n_shards']} shards", flush=True)
    out = {"train_s": train_s, "elbo_bpd": elbo, "wire_bpd": bpd,
           "encode_images_per_s": args.images / t_enc, "blob": blob,
           "data": data, "make_codec": make_codec}

    if not args.skip_decode:
        t0 = time.perf_counter()
        back = shard_codec.decompress_dataset(
            codec, blob, devices=[device] * n_shards,
            compile=not args.no_compile)
        ok = bool(torch.equal(back, data))
        t_dec = time.perf_counter() - t0
        out["decode_images_per_s"] = args.images / t_dec
        print(f"decoded in {t_dec:.2f}s ({args.images / t_dec:.1f} "
              f"images/s); lossless={ok}", flush=True)
        if not ok:
            raise SystemExit("decode mismatch - corrupt corpus")

    rates = baseline_lib.baseline_rates(imgs, binary, with_png=True)
    out["baselines"] = rates
    print("\nTable 1 (bits/dim, lower is better; "
          f"{args.images} synthetic-MNIST images"
          f"{', binarized' if binary else ''}):")
    rows = [("BB-ANS (sharded, wire)", bpd), ("-ELBO bound", elbo)]
    rows += sorted(rates.items(), key=lambda kv: kv[1])
    for name, rate in rows:
        marker = "  <- this work" if name.startswith("BB-ANS") else ""
        print(f"  {name:24s} {rate:.4f}{marker}")
    worse = [k for k in ("gzip", "bz2") if rates[k] <= bpd]
    if worse:
        raise SystemExit(f"BB-ANS did not beat {worse} - "
                         "train longer (--train-steps)")
    print(f"\nBB-ANS beats gzip by "
          f"{(1 - bpd / rates['gzip']) * 100:.1f}% and bz2 by "
          f"{(1 - bpd / rates['bz2']) * 100:.1f}%", flush=True)
    return out


if __name__ == "__main__":
    main()
