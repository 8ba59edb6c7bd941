#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each on a line of its own; any failure exits non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``src/repro_torch/kernels``
     (``torch.utils.cpp_extension.load``; ninja runs the compilers in
     parallel);
  3. every kernel against its plain PyTorch version (``twin.py``, on the
     same seeded inputs on the card) at 4096 lanes and the main paths'
     step counts: mismatch count, CUDA-event time of kernel and plain
     version, and the least time the card could take (bytes over HBM rate
     or flops over the FP32 rate);
  4. the committed golden blobs ``tests/golden/bbx1_vae_fixedpoint.bin``,
     ``bbx2_stream.bin`` and ``bbx3_corpus.bin`` re-encoded on the card
     hex for hex and decoded losslessly;
  5. the one-shot path: the paper's 784-100-40 fixed-point VAE (random
     weights from a seed) under BB-ANS, ``codecs.compile(Chained(...))``,
     1024 lanes x 8 images per lane of synthetic binarized MNIST,
     compressed and decompressed on the card; lossless, and the card's
     blob at 256 lanes equals the CPU twin's. Then five more encodes and
     decodes, timed with CUDA events: median and spread in images/s;
  6. the BBX2 stream: the same model through ``stream.StreamEncoder``
     (``compile=True, pipeline=True``), 1024 lanes, blocks of 8 images,
     4 blocks; lossless, five timed reruns, and the card's wire at 64
     lanes (2 blocks) equals the CPU twin's;
  7. the BBX3 corpus: the same model, 2 lane shards on the one card
     (``shard_codec``), 2 blocks; lossless, and card == CPU twin at 64
     lanes (a ragged block of 4 images);
  8. the static-table Categorical stream: 4096 lanes, 256 symbols, blocks
     of 64, 4 blocks, through the table-pop kernel (``use_kernel=True``);
     lossless, the same bytes as ``use_kernel=False`` on the card and as
     the CPU twin at 64 lanes.

Each path (phases 5-8) runs with the kernel launch counts set to 0 just
before it and read just after, and fails if one of its kernels was not
launched.

The line before the last holds the per-kernel JSON record; the last line
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` trace of
one more encode + decode of phases 5, 6 and 8 (device busy share, time
per kernel and per host op; the full tables go to
``build/smoke/profile_<phase>.txt``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "golden")
OUT_DIR = os.path.join(ROOT, "build", "smoke")

LANES = 4096          # kernel checks
PATH_LANES = 1024     # VAE paths
TWIN_LANES = 256      # card blob == CPU twin blob, one-shot path
CHAIN = 8             # images per lane, one-shot path
REPS = 5              # timed reruns of a path
BLOCK = 8             # images per block, VAE stream and corpus
BLOCKS = 4            # blocks per lane, VAE stream
STREAM_TWIN_LANES = 64
CAT_LANES, CAT_A, CAT_BLOCK, CAT_BLOCKS = 4096, 256, 64, 4
TABLE_STEPS = CAT_BLOCK   # pop_table_emit check: one block's pops

VAE_KERNELS = ("push_emit", "pop_dyntable_emit", "pop_grid_emit/gaussian",
               "pop_grid_emit/uniform", "grid_starts")
CAT_KERNELS = ("push_emit", "pop_table_emit")

# H100 SXM published peaks (NVIDIA data sheet; at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Float operations of one F(i) = floor(ndtr((z_i - mu) / sigma) * scale)
# + i in kernels/common/ndtr.cuh, an fma counted as 2: 3 (x, z, 1/z) + 42
# (erfc polynomials, 21 fma) + 22 (exp) + 5 (erfc tail) + 23 (erf: 10 fma,
# x*x, x*P, divide) + 3 (branch tails, * 0.5) + 4 (standardize, scale,
# floor).
FLOPS_PER_F = 102

REPLACES = {
    "push_emit": "src/repro/kernels/ans/kernel.py:35",
    "pop_slots": "src/repro/kernels/ans/kernel.py:92",
    "pop_table_emit": "src/repro/kernels/ans/kernel.py:120",
    "pop_dyntable_emit": "src/repro/kernels/ans/kernel.py:196",
    "pop_grid_emit/gaussian": "src/repro/kernels/ans/kernel.py:266",
    "pop_grid_emit/uniform": "src/repro/kernels/ans/kernel.py:266",
    "grid_starts": "src/repro/codecs/compile.py:357",
}
SOURCES = {
    "push_emit": "src/repro_torch/kernels/ans/csrc/push.cu",
    "pop_slots": "src/repro_torch/kernels/ans/csrc/peek.cu",
    "pop_table_emit": "src/repro_torch/kernels/ans/csrc/pop_table.cu",
    "pop_dyntable_emit": "src/repro_torch/kernels/ans/csrc/pop_dyntable.cu",
    "pop_grid_emit/gaussian": "src/repro_torch/kernels/ans/csrc/pop_grid.cu",
    "pop_grid_emit/uniform": "src/repro_torch/kernels/ans/csrc/pop_grid.cu",
    "grid_starts": "src/repro_torch/kernels/ans/csrc/grid_starts.cu",
}


T0 = time.perf_counter()


def say(*args) -> None:
    print(*args, flush=True)


def stamp(what: str) -> None:
    say(f"time: {what} done at {time.perf_counter() - T0:.1f} s")


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_span(fn) -> tuple:
    """(``fn()``, milliseconds between CUDA events recorded just before
    and just after it)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_err(a, b) -> tuple:
    """(largest absolute difference, count of differing entries) over
    paired integer outputs."""
    import torch
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    worst, bad = 0, 0
    for x, y in zip(a, b):
        d = (x.cpu().to(torch.int64) - y.cpu().to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
        bad += int((d != 0).sum())
    return worst, bad


def kernel_inputs(seed: int = 0):
    """Seeded inputs at the main paths' step counts: 784 Bernoulli pixel
    steps (push and dyntable pop), 40 latent steps (grid pops, starts),
    one Categorical block of 64 pops against 257-entry tables."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    L, P, S = LANES, 784, 40
    head = torch.from_numpy(rng.integers(1 << 16, 1 << 32, L,
                                         dtype=np.int64))
    f1 = rng.integers(1, (1 << 16) - 1, (P, L))
    sym = rng.integers(0, 2, (P, L))
    f0 = (1 << 16) - f1
    starts = np.where(sym == 1, f0, 0)
    freqs = np.where(sym == 1, f1, f0)
    tables = np.stack([np.zeros_like(f1), f0, np.full_like(f1, 1 << 16)],
                      axis=-1)
    feed_p = rng.integers(0, 1 << 16, (P, L))
    feed_s = rng.integers(0, 1 << 16, (S, L))
    mu = rng.normal(0.0, 1.5, (S, L)).astype(np.float32)
    sigma = np.exp(rng.uniform(-4.0, 1.0, (S, L))).astype(np.float32)
    idx = rng.integers(0, 1 << 10, (S, L))
    w = rng.integers(1, 100, (L, CAT_A)) * (rng.random((L, CAT_A)) > 0.1)
    w[:, 0] += 1
    cdf = np.floor(np.cumsum(w, 1) / w.sum(1, keepdims=True) * (1 << 16))
    table = np.concatenate([np.zeros((L, 1)), cdf], 1)
    table[:, -1] = 1 << 16
    feed_t = rng.integers(0, 1 << 16, (TABLE_STEPS, L))
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return {"head": head, "starts": i32(starts), "freqs": i32(freqs),
            "tables": i32(tables), "feed_p": i32(feed_p),
            "feed_s": i32(feed_s), "mu": torch.from_numpy(mu),
            "sigma": torch.from_numpy(sigma), "idx": i32(idx),
            "table": i32(table), "feed_t": i32(feed_t)}


def run(mod, name: str, d, e):
    """Kernel ``name`` from ``mod`` (``kernel`` or ``twin``) on inputs
    ``d`` with bucket edges ``e``."""
    if name == "push_emit":
        return mod.push_emit(d["head"], d["starts"], d["freqs"], 16)
    if name == "pop_slots":
        return mod.pop_slots(d["head"], 16)
    if name == "pop_table_emit":
        return mod.pop_table_emit(d["head"], d["table"], d["feed_t"], 16)
    if name == "pop_dyntable_emit":
        return mod.pop_dyntable_emit(d["head"], d["tables"], d["feed_p"], 16)
    if name == "pop_grid_emit/gaussian":
        return mod.pop_grid_emit(d["head"], d["mu"], d["sigma"], d["feed_s"],
                                 e, "gaussian", 10, 16)
    if name == "pop_grid_emit/uniform":
        return mod.pop_grid_emit(d["head"], None, None, d["feed_s"], None,
                                 "uniform", 10, 16)
    return mod.grid_starts(d["idx"], d["mu"], d["sigma"], e, 10, 16)


def work(name: str, out) -> tuple:
    """(bytes, flops) the call must move and do: each input read once,
    each output written once; the feed counted as far as it was read."""
    L, P, S = LANES, 784, 40
    reads = 4 * int(out[2].sum()) \
        if name.startswith("pop") and name != "pop_slots" else 0
    if name == "push_emit":
        return 16 * P * L + 16 * L, 0
    if name == "pop_slots":
        return 12 * L, 0
    if name == "pop_table_emit":
        return 4 * (CAT_A + 1) * L + 4 * TABLE_STEPS * L + reads + 20 * L, 0
    if name == "pop_dyntable_emit":
        return 12 * P * L + 4 * P * L + reads + 20 * L, 0
    if name == "pop_grid_emit/gaussian":
        steps_f = (10 + 3) * FLOPS_PER_F      # bisection, start, freq
        return 12 * S * L + reads + 20 * L + 4 * 1025, steps_f * S * L
    if name == "pop_grid_emit/uniform":
        return 4 * S * L + reads + 20 * L, 0
    return 20 * S * L + 4 * 1025, 2 * FLOPS_PER_F * S * L


def check_kernels():
    """Phase 3: each kernel vs its plain version on the same inputs on the
    card; returns records."""
    from repro_torch.core import discretize
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    gpu = {k: v.cuda() for k, v in kernel_inputs().items()}
    e_gpu = discretize.edge_table(10, "cuda")
    records, failed = [], False
    for name in REPLACES:
        got = run(K, name, gpu, e_gpu)
        worst, bad = max_err(got, run(T, name, gpu, e_gpu))
        ms = cuda_ms(lambda: run(K, name, gpu, e_gpu), 20)
        plain_ms = cuda_span(lambda: run(T, name, gpu, e_gpu))[1]
        nbytes, flops = work(name, got)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        rec = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "operations" if t_ops > t_bytes else "bytes",
               "library_ms": None}
        records.append(rec)
        say(f"phase 3: {name}: mismatches {bad}, max_abs_err {worst}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
        failed |= bad != 0
    if failed:
        raise SystemExit("phase 3: a kernel disagrees with its plain version")
    return records


def golden_vae(device: str):
    """(codec, data(n)) of ``tests/golden/make_golden.py``: the (36, 24, 6)
    quantized VAE on its committed parameters, 4 lanes."""
    import numpy as np
    import torch
    from repro_torch import weights
    from repro_torch.models import vae

    params = weights.from_jax_params(
        dict(np.load(os.path.join(GOLDEN, "vae_fixedpoint_params.npz"))),
        device=device)
    codec = vae.make_bb_codec_q(params, vae.VAEConfig(36, 24, 6))
    data = lambda n: torch.from_numpy(np.random.default_rng(1234).integers(
        0, 2, (n, 4, 36))).to(torch.int32)
    return codec, data


def check_golden() -> None:
    """Phase 4: the committed VAE blobs - one-shot, stream and corpus -
    re-encoded and decoded on the card."""
    from repro_torch import codecs, shard_codec, stream

    codec, data = golden_vae("cuda")
    fused = codecs.compile(codec)
    kw = dict(seed=0, init_chunks=16, capacity=512)
    cases = {
        "bbx1_vae_fixedpoint": (
            data(1)[0],
            lambda x: codecs.compress(fused, x, lanes=4, device="cuda",
                                      **kw),
            lambda b: codecs.decompress(fused, b, device="cuda")),
        "bbx2_stream": (
            data(6),
            lambda x: stream.encode_stream(
                codec, x, lanes=4, block_symbols=2, compile=True,
                pipeline=True, device="cuda", **kw),
            lambda b: stream.decode_stream(codec, b, compile=True,
                                           device="cuda")),
        "bbx3_corpus": (
            data(4),
            lambda x: shard_codec.compress_dataset(
                codec, x, n_shards=2, block_symbols=2,
                devices=["cuda"] * 2, **kw),
            lambda b: shard_codec.decompress_dataset(
                codec, b, devices=["cuda"] * 2)),
    }
    failed = False
    for name, (x, encode, decode) in cases.items():
        with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as f:
            golden = f.read()
        blob = encode(x.cuda())
        same = blob.hex() == golden.hex()
        lossless = bool((decode(golden).cpu() == x).all())
        say(f"phase 4: golden {name} re-encoded on the card: "
            f"{'hex-identical' if same else 'DIFFERS'} ({len(blob)} bytes); "
            f"decoded {'losslessly' if lossless else 'WRONGLY'}")
        failed |= not (same and lossless)
    if failed:
        raise SystemExit("phase 4 failed")


def counted(phase: str, kernels, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; fails when one of ``kernels`` was not launched. Returns
    (``fn()``'s result, the counts)."""
    from repro_torch.kernels.ans import kernel as K

    K.reset_launches()
    out = fn()
    launches = dict(K.LAUNCHES)
    say(f"{phase}: launches {json.dumps(launches)}")
    missing = [k for k in kernels if not launches[k]]
    if missing:
        raise SystemExit(f"{phase}: kernels not launched: {missing}")
    return out, launches


def rates(n: int, encode, decode) -> tuple:
    """Median and min-max items/s of ``REPS`` CUDA-event-timed runs of
    ``encode()`` and of ``decode(blob)``."""
    blob = encode()
    enc = sorted(n / cuda_span(encode)[1] * 1e3 for _ in range(REPS))
    dec = sorted(n / cuda_span(lambda: decode(blob))[1] * 1e3
                 for _ in range(REPS))
    fmt = lambda r: f"{r[REPS // 2]:.1f} ({r[0]:.1f}-{r[-1]:.1f})"
    return fmt(enc), fmt(dec)


def paper_vae(device: str, params=None):
    """The paper's 784-100-40 fixed-point VAE on random weights from a
    seed (``params`` moved to ``device`` when given)."""
    import torch
    from repro_torch.models import vae

    cfg = vae.paper_config("bernoulli")
    if params is None:
        params = vae.init(cfg, torch.Generator().manual_seed(0),
                          device=device)
    else:
        params = {k: {n: t.to(device) for n, t in v.items()}
                  for k, v in params.items()}
    return params, vae.make_bb_codec_q(params, cfg)


def mnist(n_images: int, lanes: int):
    """Synthetic binarized MNIST as int32 [n_images // lanes, lanes, 784]
    on the card: ``CHAIN * PATH_LANES`` distinct digits (rendering costs
    a few ms each on the host), repeated, then binarized stochastically
    over the whole array, so every binary image is drawn afresh."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic_mnist

    distinct = CHAIN * PATH_LANES
    grey = np.concatenate([synthetic_mnist.load("test", n=1024, seed=s)[0]
                           for s in range(-(-distinct // 1024))])[:distinct]
    grey = np.tile(grey, (-(-n_images // distinct), 1))[:n_images]
    data = synthetic_mnist.binarize(grey, seed=0)
    return torch.from_numpy(data.reshape(-1, lanes, 784)).to(torch.int32) \
        .cuda()


def twin_check(phase: str, lanes: int, card_blob: bytes,
               encode_cpu) -> None:
    t0 = time.perf_counter()
    same = card_blob == encode_cpu()
    say(f"{phase}: {lanes}-lane wire, card vs CPU twin: "
        f"{'identical' if same else 'DIFFERENT'} ({len(card_blob)} bytes; "
        f"CPU twin {time.perf_counter() - t0:.1f} s)")
    if not same:
        raise SystemExit(f"{phase}: card and CPU twin wrote different bytes")


def stream_path(card: str, params, data):
    """Phase 6: the paper's VAE as a BBX2 stream over ``data``
    [BLOCK * BLOCKS, PATH_LANES, 784]; returns (launch counts, encode,
    decode)."""
    from repro_torch import stream

    _, codec = paper_vae("cuda", params)
    kw = dict(block_symbols=BLOCK, seed=0, init_chunks=32, compile=True,
              pipeline=True)
    encode = lambda: stream.encode_stream(codec, data, lanes=PATH_LANES,
                                          device="cuda", **kw)
    decode = lambda b: stream.decode_stream(codec, b, compile=True,
                                            device="cuda")
    (wire, back), launches = counted(
        "phase 6", VAE_KERNELS, lambda: (lambda w: (w, decode(w)))(encode()))
    lossless = bool((back == data).all())
    say(f"phase 6: BBX2 stream, 784-100-40 fixed-point VAE, {PATH_LANES} "
        f"lanes x {BLOCKS} blocks of {BLOCK} images: {len(wire)} bytes, "
        f"{8 * len(wire) / data.numel():.4f} bits/dim, lossless {lossless}")
    if not lossless:
        raise SystemExit("phase 6: the stream did not decode losslessly")
    enc, dec = rates(data.shape[0] * PATH_LANES, encode, decode)
    say(f"phase 6: {REPS} more runs, images/s median (min-max): encode "
        f"{enc}, decode {dec} on {card}")
    # The CPU twin's cost is per chain step, not per lane: 2 blocks.
    sub = data[:2 * BLOCK, :STREAM_TWIN_LANES].contiguous()
    card_wire = stream.encode_stream(codec, sub, lanes=STREAM_TWIN_LANES,
                                     device="cuda", **kw)
    _, codec_cpu = paper_vae("cpu", params)
    twin_check("phase 6", STREAM_TWIN_LANES, card_wire,
               lambda: stream.encode_stream(
                   codec_cpu, sub.cpu(), lanes=STREAM_TWIN_LANES,
                   device="cpu", **kw))
    return launches, encode, decode


def corpus_path(card: str, params, data):
    """Phase 7: the paper's VAE as a 2-shard BBX3 corpus on the one card,
    over ``data`` [2 * BLOCK, PATH_LANES, 784]; returns launch counts."""
    from repro_torch import shard_codec

    _, codec = paper_vae("cuda", params)
    kw = dict(n_shards=2, block_symbols=BLOCK, seed=0, compile=True,
              pipeline=True)
    (blob, back), launches = counted("phase 7", VAE_KERNELS, lambda: (
        lambda b: (b, shard_codec.decompress_dataset(
            codec, b, devices=["cuda"] * 2, compile=True)))(
        shard_codec.compress_dataset(codec, data, devices=["cuda"] * 2,
                                     **kw)))
    lossless = bool((back == data).all())
    info = shard_codec.corpus_info(blob)
    say(f"phase 7: BBX3 corpus, 2 shards of {info['lanes_per_shard']} "
        f"lanes on {card}: {len(blob)} bytes, {info['total_symbols']} "
        f"images, lossless {lossless}")
    if not lossless:
        raise SystemExit("phase 7: the corpus did not decode losslessly")
    sub = data[:BLOCK // 2, :STREAM_TWIN_LANES].contiguous()  # ragged
    card_blob = shard_codec.compress_dataset(codec, sub,
                                             devices=["cuda"] * 2, **kw)
    _, codec_cpu = paper_vae("cpu", params)
    twin_check("phase 7", STREAM_TWIN_LANES, card_blob,
               lambda: shard_codec.compress_dataset(
                   codec_cpu, sub.cpu(), devices=["cpu"] * 2, **kw))
    return launches


def categorical_path(card: str):
    """Phase 8: a static-table Categorical stream through the table-pop
    kernel; returns (launch counts, encode, decode)."""
    import numpy as np
    import torch
    from repro_torch import codecs, stream

    rng = np.random.default_rng(8)
    logits = rng.normal(0.0, 2.0, (CAT_LANES, CAT_A)).astype(np.float32)
    p = np.exp(logits - logits.max(1, keepdims=True))
    cdf = np.cumsum(p / p.sum(1, keepdims=True), 1)
    u = rng.random((CAT_BLOCK * CAT_BLOCKS, CAT_LANES))
    data = torch.from_numpy(np.stack(
        [np.minimum(np.searchsorted(cdf[l], u[:, l]), CAT_A - 1)
         for l in range(CAT_LANES)], 1).astype(np.int32)).cuda()
    codec = codecs.Categorical(torch.from_numpy(logits).cuda())
    kw = dict(block_symbols=CAT_BLOCK, seed=0, pipeline=True)
    encode = lambda: stream.encode_stream(codec, data, lanes=CAT_LANES,
                                          device="cuda", **kw)
    decode = lambda b: stream.decode_stream(codec, b, device="cuda")
    (wire, back), launches = counted(
        "phase 8", CAT_KERNELS, lambda: (lambda w: (w, decode(w)))(encode()))
    lossless = bool((back == data).all())
    say(f"phase 8: static-table Categorical stream, {CAT_LANES} lanes x "
        f"{CAT_BLOCKS} blocks of {CAT_BLOCK}, A = {CAT_A}: {len(wire)} "
        f"bytes, {8 * len(wire) / data.numel():.4f} bits/symbol, lossless "
        f"{lossless}")
    t0 = time.perf_counter()
    plain = stream.encode_stream(codec, data, lanes=CAT_LANES,
                                 use_kernel=False, device="cuda", **kw)
    say(f"phase 8: use_kernel=False on the card: "
        f"{'identical' if plain == wire else 'DIFFERENT'} bytes "
        f"({time.perf_counter() - t0:.1f} s)")
    if not lossless or plain != wire:
        raise SystemExit("phase 8 failed")
    enc, dec = rates(data.numel(), encode, decode)
    say(f"phase 8: {REPS} more runs, symbols/s median (min-max): encode "
        f"{enc}, decode {dec} on {card}")
    sub = data[:, :STREAM_TWIN_LANES].contiguous()
    sub_codec = codecs.Categorical(codec.logits[:STREAM_TWIN_LANES])
    card_wire = stream.encode_stream(sub_codec, sub, lanes=STREAM_TWIN_LANES,
                                     device="cuda", **kw)
    cpu_codec = codecs.Categorical(sub_codec.logits.cpu())
    twin_check("phase 8", STREAM_TWIN_LANES, card_wire,
               lambda: stream.encode_stream(
                   cpu_codec, sub.cpu(), lanes=STREAM_TWIN_LANES,
                   device="cpu", **kw))
    return launches, encode, decode


def main_path(card: str, data):
    """Phase 5 on ``data`` [CHAIN, PATH_LANES, 784]; returns (launch
    counts, encode, decode, params)."""
    from repro_torch import codecs

    params, codec = paper_vae("cuda")
    codec = codecs.compile(codecs.Chained(codec, CHAIN))
    encode = lambda: codecs.compress(codec, data, lanes=PATH_LANES, seed=0,
                                     device="cuda")
    decode = lambda b: codecs.decompress(codec, b, device="cuda")

    def run():
        blob, enc_ms = cuda_span(encode)
        back, dec_ms = cuda_span(lambda: decode(blob))
        return blob, back, enc_ms, dec_ms

    (blob, back, enc_ms, dec_ms), launches = counted("phase 5", VAE_KERNELS,
                                                     run)
    lossless = bool((back == data).all())
    say(f"phase 5: 784-100-40 fixed-point VAE, {PATH_LANES} lanes x "
        f"{CHAIN} images: {len(blob)} bytes, "
        f"{8 * len(blob) / data.numel():.4f} bits/dim, lossless {lossless}; "
        f"first run: encode {enc_ms:.2f} ms, decode {dec_ms:.2f} ms on "
        f"{card}")
    if not lossless:
        raise SystemExit("phase 5: the blob did not decode losslessly")
    enc, dec = rates(CHAIN * PATH_LANES, encode, decode)
    say(f"phase 5: {REPS} more runs, images/s median (min-max): encode "
        f"{enc}, decode {dec} on {card}")
    sub = data[:, :TWIN_LANES].contiguous()
    card_blob = codecs.compress(codec, sub, lanes=TWIN_LANES, seed=0,
                                device="cuda")
    codec_cpu = codecs.compile(codecs.Chained(paper_vae("cpu", params)[1],
                                              CHAIN))
    twin_check("phase 5", TWIN_LANES, card_blob, lambda: codecs.compress(
        codec_cpu, sub.cpu(), lanes=TWIN_LANES, seed=0, device="cpu"))
    return launches, encode, decode, params


def profile(label: str, encode, decode) -> None:
    """One traced ``encode()`` + ``decode(blob)`` of a path: wall time,
    device busy time (the sum of the kernels' and copies' device times)
    and the top kernels and host ops; the full tables go to
    ``build/smoke/profile_<label>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = encode()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode(blob)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    # Device time is the kernels' and copies' own; an operator's entry
    # repeats the time of the kernels it launched.
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev(e) for e in on_card) / 1e3
    wall_ms = (t2 - t0) * 1e3
    top = sorted(on_card, key=dev, reverse=True)[:6]
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:6]
    key = "self_device_time_total" if events and hasattr(
        events[0], "self_device_time_total") else "self_cuda_time_total"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        f.write(events.table(sort_by=key, row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    say(f"profile {label}: encode {(t1 - t0) * 1e3:.2f} ms + decode "
        f"{(t2 - t1) * 1e3:.2f} ms wall (traced), device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of wall")
    say(f"profile {label}: device " + "; ".join(
        f"{e.key[:40]} {dev(e) / 1e3:.2f} ms x{e.count}" for e in top))
    say(f"profile {label}: host " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms x{e.count}"
        for e in host))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    try:
        from repro_torch.kernels.ans import kernel as K
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"phase 1: {smi}")
    say(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    K.build()
    say(f"phase 2: built {len(K.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")

    records = check_kernels()
    stamp("phase 3")
    check_golden()
    stamp("phase 4")
    images = mnist(PATH_LANES * BLOCK * BLOCKS, PATH_LANES)
    stamp("images")
    by_path, traced = {}, {}
    by_path["vae_oneshot"], *traced["phase5"], params = main_path(
        smi, images[:CHAIN])
    stamp("phase 5")
    by_path["vae_stream"], *traced["phase6"] = stream_path(smi, params,
                                                           images)
    stamp("phase 6")
    by_path["vae_corpus"] = corpus_path(smi, params, images[:2 * BLOCK])
    stamp("phase 7")
    by_path["categorical_stream"], *traced["phase8"] = categorical_path(smi)
    stamp("phase 8")
    if "--profile" in sys.argv[1:]:
        for label, (encode, decode) in traced.items():
            profile(label, encode, decode)
    for rec in records:
        counts = {p: c[rec["name"]] for p, c in by_path.items()
                  if c[rec["name"]]}
        rec["launches"] = sum(counts.values())
        rec["launches_by_path"] = counts
    say(f"card: {smi}")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
