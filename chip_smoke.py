#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each on a line of its own; any failure exits non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``src/repro_torch/kernels``
     (``torch.utils.cpp_extension.load``; ninja runs the compilers in
     parallel);
  3. every kernel against its plain PyTorch version (``twin.py`` on CPU
     copies of the same seeded inputs) at 4096 lanes and the main path's
     step counts: mismatch count, CUDA-event time of kernel and plain
     version, and the least time the card could take (bytes over HBM rate
     or flops over the FP32 rate);
  4. the committed golden blob ``tests/golden/bbx1_vae_fixedpoint.bin``
     re-encoded on the card hex for hex and decoded losslessly;
  5. the main path: the paper's 784-100-40 fixed-point VAE (random
     weights from a seed) under BB-ANS, ``codecs.compile(Chained(...))``,
     1024 lanes x 8 images per lane of synthetic binarized MNIST,
     compressed and decompressed on the card with the kernel launch
     counts reset just before and read just after; lossless, and the
     card's blob at 256 lanes equals the CPU twin's. Then five more
     encodes and decodes, timed with CUDA events: median and spread in
     images/s.

The line before the last holds the per-kernel JSON record; the last line
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` trace of
one more encode + decode of the main path (device busy share, time per
kernel and per host op; the full tables go to
``build/smoke/profile.txt``).
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
PATH_LANES = 1024     # main path
TWIN_LANES = 256      # card blob == CPU twin blob
CHAIN = 8             # images per lane
REPS = 5              # timed reruns of the main path

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
    "pop_dyntable_emit": "src/repro/kernels/ans/kernel.py:196",
    "pop_grid_emit/gaussian": "src/repro/kernels/ans/kernel.py:266",
    "pop_grid_emit/uniform": "src/repro/kernels/ans/kernel.py:266",
    "grid_starts": "src/repro/codecs/compile.py:357",
}
SOURCES = {
    "push_emit": "src/repro_torch/kernels/ans/csrc/push.cu",
    "pop_dyntable_emit": "src/repro_torch/kernels/ans/csrc/pop_dyntable.cu",
    "pop_grid_emit/gaussian": "src/repro_torch/kernels/ans/csrc/pop_grid.cu",
    "pop_grid_emit/uniform": "src/repro_torch/kernels/ans/csrc/pop_grid.cu",
    "grid_starts": "src/repro_torch/kernels/ans/csrc/grid_starts.cu",
}


def say(*args) -> None:
    print(*args, flush=True)


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
    worst, bad = 0, 0
    for x, y in zip(a, b):
        d = (x.cpu().to(torch.int64) - y.cpu().to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
        bad += int((d != 0).sum())
    return worst, bad


def kernel_inputs(seed: int = 0):
    """Seeded inputs at the main path's step counts: 784 Bernoulli pixel
    steps (push and dyntable pop), 40 latent steps (grid pops, starts)."""
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
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return {"head": head, "starts": i32(starts), "freqs": i32(freqs),
            "tables": i32(tables), "feed_p": i32(feed_p),
            "feed_s": i32(feed_s), "mu": torch.from_numpy(mu),
            "sigma": torch.from_numpy(sigma), "idx": i32(idx)}


def run(mod, name: str, d, e):
    """Kernel ``name`` from ``mod`` (``kernel`` or ``twin``) on inputs
    ``d`` with bucket edges ``e``."""
    if name == "push_emit":
        return mod.push_emit(d["head"], d["starts"], d["freqs"], 16)
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
    reads = 4 * int(out[2].sum()) if name.startswith("pop") else 0
    if name == "push_emit":
        return 16 * P * L + 16 * L, 0
    if name == "pop_dyntable_emit":
        return 12 * P * L + 4 * P * L + reads + 20 * L, 0
    if name == "pop_grid_emit/gaussian":
        steps_f = (10 + 3) * FLOPS_PER_F      # bisection, start, freq
        return 12 * S * L + reads + 20 * L + 4 * 1025, steps_f * S * L
    if name == "pop_grid_emit/uniform":
        return 4 * S * L + reads + 20 * L, 0
    return 20 * S * L + 4 * 1025, 2 * FLOPS_PER_F * S * L


def check_kernels():
    """Phase 3: each kernel vs its plain version; returns records."""
    import torch
    from repro_torch.core import discretize
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    cpu = kernel_inputs()
    gpu = {k: v.cuda() for k, v in cpu.items()}
    e_cpu = discretize.edge_table(10, "cpu")
    e_gpu = discretize.edge_table(10, "cuda")
    records, failed = [], False
    for name in REPLACES:
        got = run(K, name, gpu, e_gpu)
        torch.cuda.synchronize()
        worst, bad = max_err(got, run(T, name, cpu, e_cpu))
        ms = cuda_ms(lambda: run(K, name, gpu, e_gpu), 20)
        plain_ms = cuda_ms(lambda: run(T, name, gpu, e_gpu), 1)
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


def check_golden() -> None:
    """Phase 4: the committed fixed-point VAE blob, on the card."""
    import numpy as np
    import torch
    from repro_torch import codecs, weights
    from repro_torch.models import vae

    cfg = vae.VAEConfig(input_dim=36, hidden=24, latent=6)
    params = weights.from_jax_params(
        dict(np.load(os.path.join(GOLDEN, "vae_fixedpoint_params.npz"))),
        device="cuda")
    codec = vae.make_bb_codec_q(params, cfg, compiled=True)
    data = np.random.default_rng(1234).integers(0, 2, (1, 4, 36))[0]
    data = torch.from_numpy(data).to(torch.int32)
    with open(os.path.join(GOLDEN, "bbx1_vae_fixedpoint.bin"), "rb") as f:
        golden = f.read()
    blob = codecs.compress(codec, data, lanes=4, seed=0, init_chunks=16,
                           capacity=512, device="cuda")
    same = blob.hex() == golden.hex()
    back = codecs.decompress(codec, golden, device="cuda").cpu()
    lossless = bool((back == data).all())
    say(f"phase 4: golden bbx1_vae_fixedpoint re-encoded on the card: "
        f"{'hex-identical' if same else 'DIFFERS'} ({len(blob)} bytes); "
        f"decoded {'losslessly' if lossless else 'WRONGLY'}")
    if not (same and lossless):
        raise SystemExit("phase 4 failed")


def main_path(card: str):
    """Phase 5; returns (launch counts of the run, codec, data)."""
    import numpy as np
    import torch
    from repro_torch import codecs
    from repro_torch.data import synthetic_mnist
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.models import vae

    cfg = vae.paper_config("bernoulli")
    params = vae.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    codec = codecs.compile(codecs.Chained(vae.make_bb_codec_q(params, cfg),
                                          CHAIN))
    n = CHAIN * PATH_LANES
    images = np.concatenate([
        synthetic_mnist.load("test", n=1024, seed=s)[0]
        for s in range(n // 1024)])
    data = synthetic_mnist.binarize(images, seed=0)
    data = torch.from_numpy(data.reshape(CHAIN, PATH_LANES, 784)) \
        .to(torch.int32).cuda()

    def encode():
        return codecs.compress(codec, data, lanes=PATH_LANES, seed=0,
                               device="cuda")

    def decode(blob):
        return codecs.decompress(codec, blob, device="cuda")

    K.reset_launches()
    blob, enc_ms = cuda_span(encode)
    back, dec_ms = cuda_span(lambda: decode(blob))
    launches = dict(K.LAUNCHES)
    lossless = bool((back == data).all())
    bpd = 8 * len(blob) / data.numel()
    say(f"phase 5: 784-100-40 fixed-point VAE, {PATH_LANES} lanes x "
        f"{CHAIN} images: {len(blob)} bytes, {bpd:.4f} bits/dim, "
        f"lossless {lossless}; first run: encode {enc_ms:.2f} ms, decode "
        f"{dec_ms:.2f} ms on {card}")
    enc = sorted(n / cuda_span(encode)[1] * 1e3 for _ in range(REPS))
    dec = sorted(n / cuda_span(lambda: decode(blob))[1] * 1e3
                 for _ in range(REPS))
    say(f"phase 5: {REPS} more runs, images/s median (min-max): encode "
        f"{enc[REPS // 2]:.1f} ({enc[0]:.1f}-{enc[-1]:.1f}), decode "
        f"{dec[REPS // 2]:.1f} ({dec[0]:.1f}-{dec[-1]:.1f}) on {card}")
    say(f"phase 5: launches {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if not v]
    if not lossless or missing:
        raise SystemExit(f"phase 5 failed (lossless={lossless}, kernels "
                         f"not launched: {missing})")

    sub = data[:, :TWIN_LANES].contiguous()
    card_blob = codecs.compress(codec, sub, lanes=TWIN_LANES, seed=0,
                                device="cuda")
    params_cpu = {k: {n_: t.cpu() for n_, t in v.items()}
                  for k, v in params.items()}
    codec_cpu = codecs.compile(codecs.Chained(
        vae.make_bb_codec_q(params_cpu, cfg), CHAIN))
    t3 = time.perf_counter()
    cpu_blob = codecs.compress(codec_cpu, sub.cpu(), lanes=TWIN_LANES,
                               seed=0, device="cpu")
    same = card_blob == cpu_blob
    say(f"phase 5: {TWIN_LANES}-lane blob, card vs CPU twin: "
        f"{'identical' if same else 'DIFFERENT'} ({len(card_blob)} bytes; "
        f"CPU twin encode {time.perf_counter() - t3:.1f} s)")
    if not same:
        raise SystemExit("phase 5: card and CPU twin wrote different bytes")
    return launches, codec, data


def profile(codec, data) -> None:
    """One traced encode + decode of the main path: wall time, device
    busy time (sum of kernel self times) and the top kernels and host
    ops."""
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch import codecs

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = codecs.compress(codec, data, lanes=PATH_LANES, seed=0,
                               device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        codecs.decompress(codec, blob, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    busy_ms = sum(dev(e) for e in events) / 1e3
    wall_ms = (t2 - t0) * 1e3
    top = sorted(events, key=dev, reverse=True)[:6]
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:6]
    key = "self_device_time_total" if events and hasattr(
        events[0], "self_device_time_total") else "self_cuda_time_total"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(events.table(sort_by=key, row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    say(f"profile: encode {(t1 - t0) * 1e3:.2f} ms + decode "
        f"{(t2 - t1) * 1e3:.2f} ms wall (traced), device busy "
        f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of wall")
    say("profile: device " + "; ".join(
        f"{e.key[:40]} {dev(e) / 1e3:.2f} ms x{e.count}" for e in top))
    say("profile: host " + "; ".join(
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
    check_golden()
    launches, codec, data = main_path(smi)
    if "--profile" in sys.argv[1:]:
        profile(codec, data)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    say(f"card: {smi}")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
