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
     or flops over the FP32 rate). The posterior bucketize also at 4097
     lanes and lat_bits 12, with slots at 0 and 2^16 - 1, mu in [-8, 8]
     and sigma in [1e-3, 30];
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
     lanes (2 blocks) equals the CPU twin's. One more pipelined encoder
     pushes its first block inside ``torch.cuda.set_sync_debug_mode(
     "error")``: the push must not wait for the card, and the stream it
     then writes must be phase 6's;
  7. the BBX3 corpus: the same model, 2 lane shards on the one card
     (``shard_codec``), 2 blocks; lossless, and card == CPU twin at 64
     lanes (a ragged block of 4 images);
  8. the static-table Categorical stream: 4096 lanes, 256 symbols, blocks
     of 64, 4 blocks, through the table-pop kernel (``use_kernel=True``);
     lossless, the same bytes as ``use_kernel=False`` on the card and as
     the CPU twin at 64 lanes;
  9. the logistic path: ``codecs.compile``d BBX2 stream of
     ``Repeat(DiscretizedLogistic(mu[:, d], scale[:, d], 10), 40)``,
     4096 lanes x 4 blocks of 8 (mu, scale from numpy seed 9; scale in
     [0.05, 2]); lossless, the compiled wire equals the eager wire on the
     card and the CPU twin's at 64 lanes; median symbols/s;
 10. the Table-1 CLI, ``repro_torch.launch.compress.main`` with ``--arch
     vae-bernoulli --images 8192 --lanes 1024 --shards 1 --train-steps
     4000`` (the float 784-100-40 VAE trained with AdamW, compressed as a
     BBX3 corpus, decoded, held to gzip and bz2 by the CLI's own gate);
     then its eager wire equals its compiled wire on the card over the
     8 chain steps at 1024 lanes, and the card's bits/dim at 64 lanes is
     within 2% of the CPU twin's (float bytes differ between devices);
 11. the fixed-point HVAE at hvae-base2 widths (2 levels, ch 48, z_ch 4,
     2 residual blocks; random weights from a seed) under Bit-Swap,
     ``codecs.compile(Chained(make_bitswap_codec_q(...), 4))``, 1024 lanes
     x 4 28 x 28 digits as BBX1: lossless, five timed reruns, and at 4
     lanes over the first image the eager codec's blob and the CPU twin's
     equal the card's;
 12. the float HVAE at the same widths with ``use_bucketize_kernel=True``
     (eager; one bucketize launch per latent position), 256 lanes x 2
     images: lossless, the same bytes as the plain eager codec and the
     compiled one on the card, and exactly 2 x 784 x 2 bucketize launches
     to encode and 784 x 2 to decode;
 13. the Table-1 CLI on ``--arch hvae-small2`` (trained by the CLI, a BBX3
     corpus, its gate against gzip and bz2), then the card's bits/dim
     against the CPU twin's at 8 lanes over 2 chain steps, within 2%.

Each path (phases 5-13) runs with the kernel launch counts set to 0 just
before it and read just after, and fails if one of its kernels was not
launched.

The line before the last holds the per-kernel JSON record; the last line
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` trace of
one more encode + decode of phases 5, 6, 8, 9, 11 and 12 (phase 12 over
one image; device busy share, time
per kernel and per host op, the count of ``aten::nonzero``, which must be
0 in phases 5 and 6; the full tables go to
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
LOG_LANES, LOG_DIMS, LOG_BLOCK, LOG_BLOCKS = 4096, 40, 8, 4
# The CLI's gate (BB-ANS below gzip and bz2) at 8 images per lane: each
# lane carries 32 clean-bit chunks and a head, 576 bits over 8 x 784
# pixels (0.09 bits/dim), so the model must reach about 0.37 bits/dim
# where bz2 gives 0.4697 on this corpus. The reference CLI's 400 steps
# leave it at 0.4243 and the wire at 0.5185, and the gate fails (the CLI
# on an H100); 4000 steps reach 0.3511 and 0.4470.
CLI_IMAGES, CLI_STEPS = 8192, 4000
# Card against CPU twin on the float VAE: float bytes may differ (cuBLAS
# and the CPU round differently), and one differing bucket moves the
# bits-back path, which moves the rate about as much as another seed.
TWIN_RATE_TOL = 0.02
TABLE_STEPS = CAT_BLOCK   # pop_table_emit check: one block's pops
# The bucketize check: the HVAE's grid (lat_bits 10, precision 16) at
# LANES, and the largest committed grid at a lane count off the block
# size.
BK_CASES = ((LANES, 10), (LANES + 1, 12))
# Phases 11 and 12: hvae-base2 widths on 28 x 28 digits.
HV_LANES, HV_CHAIN = 1024, 4
HVF_LANES, HVF_CHAIN = 256, 2
# The eager fixed-point codec and the CPU twin run every latent position
# one after another (784 per level), so they are held to the card's
# bytes at a few lanes over the first image.
HV_CHECK_LANES = 4
# Clean chunks per lane for the HVAE blobs: the first posterior pop of a
# 28 x 28 image pops up to 784 latents of at most 10 bits (490 chunks),
# and a retried encode would count its launches twice.
HV_INIT_CHUNKS = 1024
# Phase 13: the CLI on hvae-small2. A block starts from fresh clean bits
# (the first posterior pop of 392 latents takes up to 512 chunks, 8192
# bits, after the stream's grow-and-retry), so the gate against bz2 needs
# long blocks: 256 images a lane in one block at 32 lanes spread them to
# 0.04 bits/dim. (At 64 lanes and blocks of 128, 0.08: wire 0.4570
# against bz2 0.4697 after 4000 steps, -ELBO 0.3762, on an H100.)
CLI13_IMAGES, CLI13_LANES, CLI13_BLOCK, CLI13_STEPS = 8192, 32, 256, 4000
CLI13_TWIN_LANES, CLI13_TWIN_STEPS = 8, 2

VAE_KERNELS = ("push_emit", "pop_dyntable_emit", "pop_grid_emit/gaussian",
               "pop_grid_emit/uniform", "grid_starts/gaussian")
LOGISTIC_KERNELS = ("push_emit", "pop_grid_emit/logistic",
                    "grid_starts/logistic")
CAT_KERNELS = ("push_emit", "pop_table_emit")
HVAE_EAGER_KERNELS = ("bucketize", "grid_starts/gaussian")

# H100 SXM published peaks (NVIDIA data sheet; at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Float operations of one F(i) = floor(ndtr((z_i - mu) / sigma) * scale)
# + i in kernels/common/ndtr.cuh, an fma counted as 2: 3 (x, z, 1/z) + 42
# (erfc polynomials, 21 fma) + 22 (exp) + 5 (erfc tail) + 23 (erf: 10 fma,
# x*x, x*P, divide) + 3 (branch tails, * 0.5) + 4 (standardize, scale,
# floor).
FLOPS_PER_F = 102
# The same for the logistic F(i) = floor(sigmoid((z_i - mu) / s) * scale)
# + i in kernels/common/xla_math.cuh: 2 (standardize) + 22 (exp) + 2 (1 +
# e, the division) + 2 (scale, floor).
FLOPS_PER_F_LOGISTIC = 28

REPLACES = {
    "push_emit": "src/repro/kernels/ans/kernel.py:35",
    "pop_slots": "src/repro/kernels/ans/kernel.py:92",
    "pop_table_emit": "src/repro/kernels/ans/kernel.py:120",
    "pop_dyntable_emit": "src/repro/kernels/ans/kernel.py:196",
    "pop_grid_emit/gaussian": "src/repro/kernels/ans/kernel.py:266",
    "pop_grid_emit/uniform": "src/repro/kernels/ans/kernel.py:266",
    "pop_grid_emit/logistic": "src/repro/kernels/ans/kernel.py:266",
    "grid_starts/gaussian": "src/repro/codecs/compile.py:357",
    "grid_starts/logistic": "src/repro/codecs/compile.py:97",
    "bucketize": "src/repro/kernels/bucketize/kernel.py:37",
}
SOURCES = {
    "push_emit": "src/repro_torch/kernels/ans/csrc/push.cu",
    "pop_slots": "src/repro_torch/kernels/ans/csrc/peek.cu",
    "pop_table_emit": "src/repro_torch/kernels/ans/csrc/pop_table.cu",
    "pop_dyntable_emit": "src/repro_torch/kernels/ans/csrc/pop_dyntable.cu",
    "pop_grid_emit/gaussian": "src/repro_torch/kernels/ans/csrc/pop_grid.cu",
    "pop_grid_emit/uniform": "src/repro_torch/kernels/ans/csrc/pop_grid.cu",
    "pop_grid_emit/logistic": "src/repro_torch/kernels/ans/csrc/pop_grid.cu",
    "grid_starts/gaussian": "src/repro_torch/kernels/ans/csrc/grid_starts.cu",
    "grid_starts/logistic": "src/repro_torch/kernels/ans/csrc/grid_starts.cu",
    "bucketize": "src/repro_torch/kernels/bucketize/csrc/bucketize.cu",
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
    mu_l, scale = logistic_params(L)
    return {"head": head, "starts": i32(starts), "freqs": i32(freqs),
            "tables": i32(tables), "feed_p": i32(feed_p),
            "feed_s": i32(feed_s), "mu": torch.from_numpy(mu),
            "sigma": torch.from_numpy(sigma), "idx": i32(idx),
            "table": i32(table), "feed_t": i32(feed_t),
            "mu_l": torch.from_numpy(mu_l.T.copy()),
            "scale": torch.from_numpy(scale.T.copy())}


def logistic_params(lanes: int):
    """Phase 9's logistic parameters, (mu, scale) float32[lanes, 40] from
    numpy seed 9, scale in [0.05, 2]."""
    import numpy as np
    rng = np.random.default_rng(9)
    mu = rng.normal(0.0, 1.0, (lanes, LOG_DIMS)).astype(np.float32)
    scale = rng.uniform(0.05, 2.0, (lanes, LOG_DIMS)).astype(np.float32)
    return mu, scale


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
    if name == "pop_grid_emit/logistic":
        return mod.pop_grid_emit(d["head"], d["mu_l"], d["scale"],
                                 d["feed_s"], e, "logistic", 10, 16)
    if name == "grid_starts/logistic":
        return mod.grid_starts(d["idx"], d["mu_l"], d["scale"], e, 10, 16,
                               "logistic")
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
    if name.startswith("pop_grid_emit/") and not name.endswith("uniform"):
        per_f = FLOPS_PER_F if name.endswith("gaussian") \
            else FLOPS_PER_F_LOGISTIC
        steps_f = (10 + 3) * per_f            # bisection, start, freq
        return 12 * S * L + reads + 20 * L + 4 * 1025, steps_f * S * L
    if name == "pop_grid_emit/uniform":
        return 4 * S * L + reads + 20 * L, 0
    per_f = FLOPS_PER_F if name.endswith("gaussian") \
        else FLOPS_PER_F_LOGISTIC
    return 20 * S * L + 4 * 1025, 2 * per_f * S * L


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
        if name == "bucketize":
            continue
        got = run(K, name, gpu, e_gpu)
        worst, bad = max_err(got, run(T, name, gpu, e_gpu))
        ms = cuda_ms(lambda: run(K, name, gpu, e_gpu), 20)
        plain_ms = cuda_span(lambda: run(T, name, gpu, e_gpu))[1]
        records.append(record(name, worst, bad, ms, plain_ms,
                              *work(name, got)))
        failed |= bad != 0
    rec, bad = check_bucketize()
    records.append(rec)
    if failed or bad:
        raise SystemExit("phase 3: a kernel disagrees with its plain version")
    return records


def record(name: str, worst: int, bad: int, ms: float, plain_ms: float,
           nbytes: int, flops: int, note: str = "") -> dict:
    """Phase 3's record of kernel ``name`` and its line."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    rec = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name], "launches": 0,
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": None}
    say(f"phase 3: {name}{note}: mismatches {bad}, max_abs_err {worst}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def bucketize_inputs(lanes: int):
    """Seeded (slot, mu, sigma) on the card: slots over [0, 2^16) with 0
    and 2^16 - 1 among them, mu over [-8, 8] and sigma log-uniform over
    [1e-3, 30], each range's ends included."""
    import numpy as np
    import torch
    rng = np.random.default_rng(lanes)
    slot = rng.integers(0, 1 << 16, lanes)
    slot[:2] = (0, (1 << 16) - 1)
    mu = rng.uniform(-8.0, 8.0, lanes)
    mu[2:4] = (-8.0, 8.0)
    sigma = np.exp(rng.uniform(np.log(1e-3), np.log(30.0), lanes))
    sigma[4:6] = (1e-3, 30.0)
    return (torch.from_numpy(slot.astype(np.int32)).cuda(),
            torch.from_numpy(mu.astype(np.float32)).cuda(),
            torch.from_numpy(sigma.astype(np.float32)).cuda())


def check_bucketize() -> tuple:
    """Phase 3 for the posterior bucketize: each of ``BK_CASES`` against
    the plain version; returns (the record of the first case, the
    mismatch count over all)."""
    from repro_torch.core import discretize
    from repro_torch.kernels.bucketize import kernel as BK
    from repro_torch.kernels.bucketize import twin as BT

    first, bad_all = None, 0
    for lanes, lat_bits in BK_CASES:
        slot, mu, sigma = bucketize_inputs(lanes)
        edges = discretize.edge_table(lat_bits, "cuda")
        call = lambda mod: mod.bucketize(slot, mu, sigma, edges, lat_bits,
                                         16)
        worst, bad = max_err(call(BK), call(BT))
        ms = cuda_ms(lambda: call(BK), 20)
        plain_ms = cuda_span(lambda: call(BT))[1]
        # Each lane reads slot, mu, sigma and writes idx, start, freq;
        # lat_bits + 1 bisection steps and the two ends evaluate F.
        rec = record("bucketize", worst, bad, ms, plain_ms,
                     24 * lanes + 4 * ((1 << lat_bits) + 1),
                     (lat_bits + 3) * FLOPS_PER_F * lanes,
                     f" ({lanes} lanes, lat_bits {lat_bits})")
        first = first or rec
        bad_all += bad
    return first, bad_all


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
    sync_free_push(codec, data, wire, kw)
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


def sync_free_push(codec, data, wire: bytes, kw: dict) -> None:
    """A pipelined encoder's first block push inside
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    operation that waits for the card; the rest of the stream outside it,
    and the whole must be ``wire``."""
    import torch
    from repro_torch import stream

    enc = stream.StreamEncoder(codec, lanes=PATH_LANES, device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        head = enc.write(data[:BLOCK])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = head + enc.write(data[BLOCK:]) + enc.flush() == wire
    say(f"phase 6: a pipelined block push under set_sync_debug_mode(error) "
        f"waited for nothing; the stream it began is "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise SystemExit("phase 6: the sync-free push wrote other bytes")


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


def logistic_path(card: str):
    """Phase 9: a compiled BBX2 stream of discretized-logistic symbols
    through the logistic grid kernels; returns (launch counts, encode,
    decode)."""
    import numpy as np
    import torch
    from repro_torch import codecs, stream
    from repro_torch.core import discretize

    mu_np, scale_np = logistic_params(LOG_LANES)
    rng = np.random.default_rng(10)
    n = LOG_BLOCK * LOG_BLOCKS
    u = rng.uniform(1e-6, 1 - 1e-6, (n, LOG_LANES, LOG_DIMS))
    z = mu_np[None] + scale_np[None] * np.log(u / (1 - u))
    edges = discretize.edge_table(10, "cpu").numpy()
    data = torch.from_numpy(np.clip(np.searchsorted(edges, z) - 1, 0, 1023)
                            .astype(np.int32)).cuda()

    def leaf_codec(mu, scale):
        return codecs.Repeat(lambda d: codecs.DiscretizedLogistic(
            mu[:, d], scale[:, d], 10), LOG_DIMS)

    codec = leaf_codec(torch.from_numpy(mu_np).cuda(),
                       torch.from_numpy(scale_np).cuda())
    kw = dict(block_symbols=LOG_BLOCK, seed=0, pipeline=True)
    encode = lambda: stream.encode_stream(codec, data, lanes=LOG_LANES,
                                          compile=True, device="cuda", **kw)
    decode = lambda b: stream.decode_stream(codec, b, compile=True,
                                            device="cuda")
    (wire, back), launches = counted(
        "phase 9", LOGISTIC_KERNELS,
        lambda: (lambda w: (w, decode(w)))(encode()))
    lossless = bool((back == data).all())
    say(f"phase 9: compiled logistic stream, {LOG_LANES} lanes x "
        f"{LOG_BLOCKS} blocks of {LOG_BLOCK} x {LOG_DIMS} symbols: "
        f"{len(wire)} bytes, {8 * len(wire) / data.numel():.4f} "
        f"bits/symbol, lossless {lossless}")
    t0 = time.perf_counter()
    eager = stream.encode_stream(codec, data, lanes=LOG_LANES, compile=False,
                                 device="cuda", **kw)
    say(f"phase 9: eager wire on the card: "
        f"{'identical' if eager == wire else 'DIFFERENT'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not lossless or eager != wire:
        raise SystemExit("phase 9 failed")
    enc, dec = rates(data.numel(), encode, decode)
    say(f"phase 9: {REPS} more runs, symbols/s median (min-max): encode "
        f"{enc}, decode {dec} on {card}")
    sub = data[:, :STREAM_TWIN_LANES].contiguous()
    m, s_ = (torch.from_numpy(a[:STREAM_TWIN_LANES].copy())
             for a in (mu_np, scale_np))
    card_wire = stream.encode_stream(
        leaf_codec(m.cuda(), s_.cuda()), sub, lanes=STREAM_TWIN_LANES,
        compile=True, device="cuda", **kw)
    twin_check("phase 9", STREAM_TWIN_LANES, card_wire,
               lambda: stream.encode_stream(
                   leaf_codec(m, s_), sub.cpu(), lanes=STREAM_TWIN_LANES,
                   compile=True, device="cpu", **kw))
    return launches, encode, decode


def cli_path(card: str):
    """Phase 10: the Table-1 CLI on the float VAE, then its eager wire
    against its compiled wire on the card and its rate against the CPU
    twin's; returns launch counts."""
    import torch
    from repro_torch import codecs
    from repro_torch.launch import compress as cli

    args = ["--arch", "vae-bernoulli", "--images", str(CLI_IMAGES),
            "--lanes", str(PATH_LANES), "--shards", "1", "--train-steps",
            str(CLI_STEPS)]
    say(f"phase 10: python -m repro_torch.launch.compress {' '.join(args)}")
    out, launches = counted("phase 10", VAE_KERNELS, lambda: cli.main(args))
    say(f"phase 10: trained {CLI_STEPS} steps in {out['train_s']:.2f} s; "
        f"-ELBO {out['elbo_bpd']:.4f} bits/dim, wire "
        f"{out['wire_bpd']:.4f}, gzip {out['baselines']['gzip']:.4f}, bz2 "
        f"{out['baselines']['bz2']:.4f}; encode "
        f"{out['encode_images_per_s']:.1f} images/s, decode "
        f"{out['decode_images_per_s']:.1f} images/s (host clock, "
        f"with the corpus framing) on {card}")
    data, steps = out["data"], CLI_IMAGES // PATH_LANES
    chain = codecs.Chained(out["make_codec"](), steps)
    kw = dict(lanes=PATH_LANES, seed=0, device="cuda")
    compiled = codecs.compress(codecs.compile(chain), data, **kw)
    t0 = time.perf_counter()
    eager = codecs.compress(chain, data, **kw)
    say(f"phase 10: float VAE, {steps} chain steps at {PATH_LANES} lanes: "
        f"eager wire {'==' if eager == compiled else '!='} compiled wire "
        f"on the card ({len(compiled)} bytes; eager "
        f"{time.perf_counter() - t0:.1f} s)")
    if eager != compiled:
        raise SystemExit("phase 10: eager and compiled wires differ")
    sub = data[:, :STREAM_TWIN_LANES].contiguous()
    twin = codecs.compile(codecs.Chained(out["make_codec"]("cpu"), steps))
    on_card = codecs.compress(codecs.compile(chain), sub,
                              lanes=STREAM_TWIN_LANES, seed=0, device="cuda")
    t0 = time.perf_counter()
    on_cpu = codecs.compress(twin, sub.cpu(), lanes=STREAM_TWIN_LANES,
                             seed=0, device="cpu")
    bpd = [8 * len(b) / sub.numel() for b in (on_card, on_cpu)]
    close = abs(bpd[0] - bpd[1]) <= TWIN_RATE_TOL * bpd[1]
    say(f"phase 10: {STREAM_TWIN_LANES}-lane bits/dim, card {bpd[0]:.4f} "
        f"vs CPU twin {bpd[1]:.4f} (bytes "
        f"{'identical' if on_card == on_cpu else 'different'}; tolerance "
        f"{TWIN_RATE_TOL:.0%}; CPU twin {time.perf_counter() - t0:.1f} s)")
    if not close:
        raise SystemExit("phase 10: card and CPU twin rates disagree")
    return launches


def base2_hvae(device: str, params=None):
    """(config, weights) of hvae-base2: random from a seed, or ``params``
    moved to ``device``."""
    import torch
    from repro_torch.configs import hvae_img
    from repro_torch.models import hvae
    from repro_torch.optim.adamw import tree_map

    cfg = hvae_img.BASE2
    if params is None:
        return cfg, hvae.init(cfg, torch.Generator().manual_seed(0),
                              device=device)
    return cfg, tree_map(lambda t: t.to(device), params)


def hvae_fixed_path(card: str, images):
    """Phase 11: the fixed-point HVAE under Bit-Swap, compiled, as BBX1
    over ``images`` [HV_CHAIN, HV_LANES, 784]; returns (launch counts,
    encode, decode)."""
    from repro_torch import codecs
    from repro_torch.models import hvae

    hw = (28, 28)
    data = images.reshape(HV_CHAIN, HV_LANES, *hw)
    cfg, params = base2_hvae("cuda")
    codec = codecs.compile(codecs.Chained(
        hvae.make_bitswap_codec_q(params, cfg, hw), HV_CHAIN))
    kw = dict(seed=0, init_chunks=HV_INIT_CHUNKS, device="cuda")
    encode = lambda: codecs.compress(codec, data, lanes=HV_LANES, **kw)
    decode = lambda b: codecs.decompress(codec, b, device="cuda")
    (blob, back), launches = counted(
        "phase 11", VAE_KERNELS, lambda: (lambda b: (b, decode(b)))(encode()))
    lossless = bool((back == data).all())
    say(f"phase 11: fixed-point HVAE (hvae-base2 widths), {HV_LANES} lanes "
        f"x {HV_CHAIN} images: {len(blob)} bytes, "
        f"{8 * len(blob) / data.numel():.4f} bits/dim, lossless {lossless}")
    if not lossless:
        raise SystemExit("phase 11: the blob did not decode losslessly")
    enc, dec = rates(HV_CHAIN * HV_LANES, encode, decode)
    say(f"phase 11: {REPS} more runs, images/s median (min-max): encode "
        f"{enc}, decode {dec} on {card}")
    sub = data[:1, :HV_CHECK_LANES].contiguous()
    chain = lambda c: codecs.Chained(c, 1)
    t0 = time.perf_counter()
    eager_blob = codecs.compress(chain(codec.source.inner), sub,
                                 lanes=HV_CHECK_LANES, **kw)
    t_eager = time.perf_counter() - t0
    fused_blob = codecs.compress(codecs.compile(chain(codec.source.inner)),
                                 sub, lanes=HV_CHECK_LANES, **kw)
    say(f"phase 11: {HV_CHECK_LANES}-lane first image, eager wire "
        f"{'==' if eager_blob == fused_blob else '!='} compiled wire on "
        f"the card ({len(fused_blob)} bytes; eager {t_eager:.1f} s)")
    if eager_blob != fused_blob:
        raise SystemExit("phase 11: eager and compiled wires differ")
    cfg, cpu_params = base2_hvae("cpu", params)
    twin = codecs.compile(chain(hvae.make_bitswap_codec_q(cpu_params, cfg,
                                                          hw)))
    kw_cpu = dict(kw, device="cpu")
    twin_check("phase 11", HV_CHECK_LANES, fused_blob, lambda: codecs.compress(
        twin, sub.cpu(), lanes=HV_CHECK_LANES, **kw_cpu))
    return launches, encode, decode


def hvae_float_path(card: str, images):
    """Phase 12: the float HVAE through the bucketize kernel, eager, over
    ``images`` [HVF_CHAIN, HVF_LANES, 784]; returns (launch counts by
    direction, a one-image encode, its decode)."""
    from repro_torch import codecs
    from repro_torch.models import hvae

    hw = (28, 28)
    data = images.reshape(HVF_CHAIN, HVF_LANES, *hw)
    cfg, params = base2_hvae("cuda")
    make = lambda n, **opt: codecs.Chained(
        hvae.make_bitswap_codec(params, cfg, hw, **opt), n)
    codec = make(HVF_CHAIN, use_bucketize_kernel=True)
    kw = dict(lanes=HVF_LANES, seed=0, init_chunks=HV_INIT_CHUNKS,
              device="cuda")
    n_lat = 14 * 14 * cfg.z_ch
    t0 = time.perf_counter()
    (blob, info), enc = counted("phase 12 encode", HVAE_EAGER_KERNELS,
                                lambda: codecs.compress(codec, data,
                                                        with_info=True, **kw))
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, dec = counted("phase 12 decode", HVAE_EAGER_KERNELS,
                        lambda: codecs.decompress(codec, blob, device="cuda"))
    t_dec = time.perf_counter() - t0
    lossless = bool((back == data).all())
    want = (cfg.levels * n_lat * HVF_CHAIN, n_lat * HVF_CHAIN)
    say(f"phase 12: float HVAE (hvae-base2 widths) through the bucketize "
        f"kernel, {HVF_LANES} lanes x {HVF_CHAIN} images: {len(blob)} "
        f"bytes, {8 * len(blob) / data.numel():.4f} bits/dim, lossless "
        f"{lossless}, retries {info['retries']}; bucketize launches encode "
        f"{enc['bucketize']}, decode {dec['bucketize']} (want {want[0]}, "
        f"{want[1]}); encode {t_enc:.2f} s, decode {t_dec:.2f} s (host "
        f"clock) on {card}")
    if not lossless or (enc["bucketize"], dec["bucketize"]) != want:
        raise SystemExit("phase 12 failed")
    t0 = time.perf_counter()
    plain = codecs.compress(make(HVF_CHAIN), data, **kw)
    t_plain = time.perf_counter() - t0
    compiled = codecs.compress(make(HVF_CHAIN, compiled=True), data, **kw)
    say(f"phase 12: plain eager wire {'==' if plain == blob else '!='}, "
        f"compiled wire {'==' if compiled == blob else '!='} the kernel "
        f"codec's on the card (plain {t_plain:.1f} s)")
    if plain != blob or compiled != blob:
        raise SystemExit("phase 12: the three codecs wrote different bytes")
    one = make(1, use_bucketize_kernel=True)
    encode = lambda: codecs.compress(one, data[:1], **kw)
    decode = lambda b: codecs.decompress(one, b, device="cuda")
    return {"encode": enc, "decode": dec}, encode, decode


def hvae_cli_path(card: str):
    """Phase 13: the Table-1 CLI on hvae-small2, then its card rate
    against the CPU twin's; returns launch counts."""
    from repro_torch import codecs
    from repro_torch.launch import compress as cli

    args = ["--arch", "hvae-small2", "--images", str(CLI13_IMAGES),
            "--lanes", str(CLI13_LANES), "--shards", "1", "--train-steps",
            str(CLI13_STEPS), "--block-symbols", str(CLI13_BLOCK)]
    say(f"phase 13: python -m repro_torch.launch.compress {' '.join(args)}")
    out, launches = counted("phase 13", VAE_KERNELS, lambda: cli.main(args))
    say(f"phase 13: trained {CLI13_STEPS} steps in {out['train_s']:.2f} s; "
        f"-ELBO {out['elbo_bpd']:.4f} bits/dim, wire "
        f"{out['wire_bpd']:.4f}, gzip {out['baselines']['gzip']:.4f}, bz2 "
        f"{out['baselines']['bz2']:.4f}; encode "
        f"{out['encode_images_per_s']:.1f} images/s, decode "
        f"{out['decode_images_per_s']:.1f} images/s (host clock, "
        f"with the corpus framing) on {card}")
    sub = out["data"][:CLI13_TWIN_STEPS, :CLI13_TWIN_LANES].contiguous()
    kw = dict(lanes=CLI13_TWIN_LANES, seed=0, init_chunks=HV_INIT_CHUNKS)
    chain = lambda c: codecs.compile(codecs.Chained(c, CLI13_TWIN_STEPS))
    on_card = codecs.compress(chain(out["make_codec"]()), sub,
                              device="cuda", **kw)
    t0 = time.perf_counter()
    on_cpu = codecs.compress(chain(out["make_codec"]("cpu")), sub.cpu(),
                             device="cpu", **kw)
    bpd = [8 * len(b) / sub.numel() for b in (on_card, on_cpu)]
    close = abs(bpd[0] - bpd[1]) <= TWIN_RATE_TOL * bpd[1]
    say(f"phase 13: {CLI13_TWIN_LANES}-lane {CLI13_TWIN_STEPS}-image "
        f"bits/dim, card {bpd[0]:.4f} vs CPU twin {bpd[1]:.4f} (bytes "
        f"{'identical' if on_card == on_cpu else 'different'}; tolerance "
        f"{TWIN_RATE_TOL:.0%}; CPU twin {time.perf_counter() - t0:.1f} s)")
    if not close:
        raise SystemExit("phase 13: card and CPU twin rates disagree")
    return launches


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


def profile(label: str, encode, decode) -> int:
    """One traced ``encode()`` + ``decode(blob)`` of a path: wall time,
    device busy time (the sum of the kernels' and copies' device times)
    and the top kernels and host ops; the full tables go to
    ``build/smoke/profile_<label>.txt``. Returns the count of
    ``aten::nonzero`` (a host sync) in the trace."""
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
    nonzero = sum(e.count for e in events if e.key == "aten::nonzero")
    say(f"profile {label}: aten::nonzero x{nonzero}")
    return nonzero


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
    by_path["logistic_stream"], *traced["phase9"] = logistic_path(smi)
    stamp("phase 9")
    by_path["table1_cli"] = cli_path(smi)
    stamp("phase 10")
    by_path["hvae_fixed"], *traced["phase11"] = hvae_fixed_path(
        smi, images[:HV_CHAIN])
    stamp("phase 11")
    counts, *traced["phase12"] = hvae_float_path(
        smi, images[:HVF_CHAIN, :HVF_LANES])
    by_path["hvae_float_encode"] = counts["encode"]
    by_path["hvae_float_decode"] = counts["decode"]
    stamp("phase 12")
    by_path["hvae_cli"] = hvae_cli_path(smi)
    stamp("phase 13")
    if "--profile" in sys.argv[1:]:
        syncs = {label: profile(label, encode, decode)
                 for label, (encode, decode) in traced.items()}
        if syncs["phase5"] or syncs["phase6"]:
            raise SystemExit("profile: the VAE paths still sync through "
                             "aten::nonzero")
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
