#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each on a line of its own; any failure exits non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``src/repro_torch/kernels``
     (``torch.utils.cpp_extension.load``; ninja runs the compilers in
     parallel);
  3. every kernel against its plain PyTorch version (``twin.py``, on the
     same seeded inputs on the card) at 4096 lanes and at each shape where
     the counted paths launch it (``PATH_SHAPES``, ``BK_CASES``), timed
     there: device time per launch (``torch.profiler``'s entries for the
     kernel's CUDA function; ``ms_by`` "trace", or "events" - a time a
     call, not ranked - where five traces lose its launches), beside it
     the time per call (host + device, CUDA events), the plain version's
     time and the least time the card could take (bytes over HBM rate or
     flops over the FP32 rate); peek
     also beside one ``torch.bitwise_and``, the library column. The
     push also on inputs at the edges of its division by reciprocal (freq
     1 and 2^precision, heads near 2^32, precisions 16 and 12); the
     posterior bucketize at 256 lanes (phase 12's), 4096, 4097 at
     lat_bits 12 and either side of the lane count where its group
     narrows, with slots at 0 and 2^16 - 1, mu in [-8, 8] and sigma in
     [1e-3, 30]; the gaussian and logistic grid pops on such inputs (heads
     near 2^32 besides) at 1, 3, 32, 130, 4096 and 4101 lanes (both group
     widths), and timed on either side of the lane count where the
     launcher narrows the group; the uniform pop at those lane counts x
     392 steps with no read, a read every step (to the feed's last row)
     and between; the dyntable pop at A+1 = 2, 3, 13 and 257; the table
     pop at each width band of its launcher (``TABLE_CASES``: A+1 = 3,
     13, 257 and 4097 at 1, 3, 130, 4096 and 4101 lanes, 257 at 2640 and
     2641, where the group narrows, 31, 4500 and 2^16 at 130) over 70
     steps, with all-zero rows and heads near 2^32, each case
     timed;
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
     against the CPU twin's at 8 lanes over 2 chain steps, within 2%;
 14. the LM served at full width: ``serve.Engine`` over qwen2-0.5b (24
     layers, d 896, GQA 14:2, vocab 151,936; random weights from seed 0)
     with ``max_len`` 4096 + 16. First the flash-attention forward's two
     routes against their plain version: the tensor-core route on q, k, v
     captured from layer 0 of the 2 x 4096 prefill (bf16, causal) and
     the float32 route on seeded inputs at a ragged windowed GQA case
     (4100 tokens, window 1024), at the causal [28, 4096, 64] on 4 key
     heads that a float32-compute prefill of 2 prompts would give it, and
     at the reduced prefill's [4, 2100, 16] on 2 (the path below launches
     both routes there; the tensor-core route on seeded bf16 inputs):
     worst error, kernel, plain and
     ``F.scaled_dot_product_attention`` times (the library column, CUDA
     events a call; the port never calls it) and the bound at the route's
     rate (bf16 tensor cores; FP32 CUDA cores). Then ``generate`` greedily
     continues 2 uniform random prompts of 4096 tokens by 16, twice: the
     same tokens, and exactly 24 tensor-core flash launches (one a
     layer) per prefill. ``compress``/``decompress`` of 4 lanes x 128
     tokens (lossless, bits/token, tokens/s) and ``compress_stream`` in
     blocks of 32 with a ``decode_from_offset`` resume. Last, at reduced
     width (vocab 300) the card's prefill logits of a 2100-token prompt
     against the CPU twin's (the port on the CPU, plain flash): float32
     compute within 1e-3 (through the float32 route), bfloat16 within 0.1
     (the tensor-core route), each prefill's launches counted. Then
     stablelm-12b at full width (40 layers, d 5120, 32:8 heads of 160,
     bfloat16 weights from a CUDA generator): both flash routes at D 160
     against their plain version beside SDPA (layer 0 of its 2 x 4096
     prefill; a ragged windowed float32 case and the causal [64, 4096,
     160] on 16 key heads), and ``generate`` twice:
     the same tokens, exactly 40 tensor-core flash launches a prefill.

Each path (phases 5-14) runs with the kernel launch counts set to 0 just
before it and read just after, and fails if one of its kernels was not
launched; its launches are also counted by shape. The kernels are then
ranked by launches x (device ms - bound ms), summed over the shapes
phase 3 timed (``ranking`` lines).

The line before the last holds the per-kernel JSON record; the last line
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` trace of
one more encode + decode of phases 5, 6, 8, 9, 11 and 12 (phase 12 over
one image), and of phase 14's compress + decompress (4 lanes x 32
tokens) and its generate (device busy share, time
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
# Phases 11 and 12: hvae-base2 widths on 28 x 28 digits.
HV_LANES, HV_CHAIN = 1024, 4
HVF_LANES, HVF_CHAIN = 256, 2
TABLE_STEPS = CAT_BLOCK   # pop_table_emit check: one block's pops
# Where the counted paths launch each coder kernel: (lanes, steps) and the
# phases that launch it there, the most launched first. Phase 3 times each
# kernel at each of these shapes (device time per launch, from the
# profiler) and the first one is its record's; 4096 x 40 is no path's
# shape but the grid pops' earlier yardstick. Phase 13 (hvae-small2 at 32
# lanes) codes 392 latents a level over 784 pixels; phases 5, 6 and 10 the
# 784-100-40 VAE at 1024 lanes, phase 7 at 2 shards of 512; phase 11 784
# latents a level at 1024 lanes; phase 12 one latent position of 256
# lanes a launch.
PATH_SHAPES = {
    "push_emit": (((32, 392), "13"), ((32, 784), "13"),
                  ((1024, 784), "5, 6, 10, 11"), ((1024, 40), "5, 6, 10"),
                  ((512, 784), "7"), ((512, 40), "7"), ((4096, 40), "9"),
                  ((4096, CAT_BLOCK), "8")),
    "pop_slots": (((LANES, 1), "none"),),
    "pop_table_emit": (((CAT_LANES, CAT_BLOCK), "8"),),
    "pop_dyntable_emit": (((32, 784), "13"), ((1024, 784), "5, 6, 10, 11"),
                          ((512, 784), "7")),
    "pop_grid_emit/gaussian": (((32, 392), "13"), ((1024, 40), "5, 6, 10"),
                               ((512, 40), "7"), ((1024, 784), "11"),
                               ((LANES, 40), "none")),
    "pop_grid_emit/uniform": (((32, 392), "13"), ((1024, 40), "5, 6, 10"),
                              ((512, 40), "7"), ((1024, 784), "11"),
                              ((LANES, 40), "none")),
    "pop_grid_emit/logistic": (((LOG_LANES, LOG_DIMS), "9"),),
    "grid_starts/gaussian": (((HVF_LANES, 1), "12"), ((32, 392), "13"),
                             ((1024, 40), "5, 6, 10"), ((512, 40), "7"),
                             ((1024, 784), "11")),
    "grid_starts/logistic": (((LOG_LANES, LOG_DIMS), "9"),),
}
# The CUDA function each record's wrapper launches, as the profiler names
# it (a part of the name that other checkouts' kernels share; the table
# pop's names every instance of its template, one a group width and walk).
KERNEL_FN = {
    "push_emit": "push_kernel", "pop_slots": "peek_kernel",
    "pop_table_emit": "pop_table_kernel", "pop_dyntable_emit": "pop_dyntable",
    "pop_grid_emit/gaussian": "pop_grid_group_kernel",
    "pop_grid_emit/uniform": "pop_grid_uniform_kernel",
    "pop_grid_emit/logistic": "pop_grid_group_kernel",
    "grid_starts/gaussian": "grid_starts_kernel",
    "grid_starts/logistic": "grid_starts_kernel",
    "bucketize": "bucketize_kernel",
    "flash_fwd/wgmma": "flash_fwd_wgmma_kernel",
    "flash_fwd/simt": "flash_fwd_kernel"}
# The bucketize at (lanes, lat_bits, phases): phase 12's 256 lanes (its
# record), the HVAE's grid at LANES, the largest committed grid at a lane
# count off the block size, and either side of the lane count where the
# launcher narrows its group (BK_GROUP_EDGE: 32 threads a lane up to it,
# 16 above).
BK_GROUP_EDGE = 1024
BK_CASES = ((HVF_LANES, 10, "12"), (LANES, 10, "none"),
            (LANES + 1, 12, "none"), (BK_GROUP_EDGE, 10, "none"),
            (BK_GROUP_EDGE + 1, 10, "none"))
# The push's adversarial cases (lanes, steps, precision): freq 1 and
# 2^precision among random ones, heads within 2^12 of 2^32.
PUSH_EDGES = ((LANES, 784, 16), (LANES + 5, 300, 12))
# The grid pops (gaussian, logistic) on edge inputs - heads near 2^32,
# first slots 0 and 2^16 - 1, mu over [-8, 8], sigma over [1e-3, 30] -
# at these lane counts (32 threads a lane up to 1024 gaussian or 512
# logistic lanes, 16 above: GROUP_EDGES times each kind on either side);
# the uniform pop at these lane counts x 392 steps at lat_bits 0 (no
# read), 10 and 16 (a read every step, up to the feed's last row), at
# precisions 16 and 12; the dyntable pop at these table widths (the
# Bernoulli pixels' 3 and a 256-symbol Categorical's 257) over steps off
# its staging tile.
POP_LANES = (1, 3, 32, 130, LANES, LANES + 5)
GROUP_EDGES = {"gaussian": (1024, 1025), "logistic": (512, 513)}
UNIFORM_EDGES = ((0, 16), (10, 16), (16, 16), (8, 12), (12, 12))
DYN_A1, DYN_STEPS = (2, 3, 13, 257), 70
# The table pop (A+1, lanes), over DYN_STEPS steps (off its 32-step
# tiles), bit for bit and timed: each width band of its launcher (the
# window alone at 3 and 13, groups of 8 and 16; top round and window at
# 257, or above 2640 lanes a group of 8 with a probe round; a probe round
# at 4097) at these lane counts, 257 on either side of 2640 lanes (the
# launcher's NARROW_LANES), the window alone in a group of 32 (A+1 = 31)
# and rows staged as samples (4500: top round and window over the
# sample; 2^16: a probe round too) at 130 lanes.
TABLE_A1, TABLE_LANES = (3, 13, 257, 4097), (1, 3, 130, LANES, LANES + 5)
TABLE_CASES = tuple((a1, lanes) for a1 in TABLE_A1
                    for lanes in TABLE_LANES) + (
    (257, 2640), (257, 2641), (31, 130), (4500, 130), (1 << 16, 130))
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

# Phase 14: qwen2-0.5b at full width. The prompts reach the blockwise
# length (2048), so every layer of a prefill attends through the flash
# kernel.
LM_ARCH = "qwen2-0.5b"
LM_BATCH, LM_PROMPT, LM_NEW = 2, 4096, 16
LM_LANES, LM_TOKENS, LM_BLOCK = 4, 128, 32
LM_TWIN_PROMPT, LM_TWIN_VOCAB = 2100, 300
# The ragged flash check: GQA 14:2, a window, float32.
FLASH_RAGGED = dict(s=4100, window=1024)
# The float32 route at the shapes a float32-compute prefill of a served
# model would give it: causal, no window, 2 prompts of this many tokens
# (q [2 x heads, S, D] on 2 x key heads), numpy seed FLASH_F32_SEED.
FLASH_F32_PROMPT, FLASH_F32_SEED = 4096, 3
# Kernel against its plain version, as allclose with rtol = atol: float32
# sums in another order (2e-5, the Pallas kernel test's tolerance);
# bfloat16 outputs and p (2e-2).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Card against CPU twin at reduced width: cuBLAS and the CPU sum in other
# orders (float32: 1e-3 on logits near 1); bfloat16 rounds at other places
# (0.1, the reference's own prefill tolerance).
LM_TWIN_TOL = {"float32": 1e-3, "bfloat16": 0.1}
LM_KERNELS = ("flash_fwd/wgmma",)
# Phase 14's second model: stablelm-12b (40 layers, d 5120, 32:8 heads,
# head dim 160, d_ff 13824, vocab 100,352) at full width with bfloat16
# weights (24 GB), the largest head dim a registered config has; its
# prefill attends through the tensor-core flash kernel's 192-column
# instance. The float32 route's D-160 case is ragged and windowed.
SLM_ARCH = "stablelm-12b"

VAE_KERNELS = ("push_emit", "pop_dyntable_emit", "pop_grid_emit/gaussian",
               "pop_grid_emit/uniform", "grid_starts/gaussian")
LOGISTIC_KERNELS = ("push_emit", "pop_grid_emit/logistic",
                    "grid_starts/logistic")
CAT_KERNELS = ("push_emit", "pop_table_emit")
HVAE_EAGER_KERNELS = ("bucketize", "grid_starts/gaussian")

# H100 SXM published peaks (NVIDIA data sheet; at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12       # dense tensor-core rate
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
    "flash_fwd/wgmma": "src/repro/kernels/flash/kernel.py:28",
    "flash_fwd/simt": "src/repro/kernels/flash/kernel.py:28",
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
    "flash_fwd/wgmma":
        "src/repro_torch/kernels/flash/csrc/flash_fwd_wgmma.cu",
    "flash_fwd/simt": "src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
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


#: traces ``device_ms`` takes before it gives up on the tracer
TRACES = 5


def device_ms(fn, kernel, reps: int = 20) -> tuple:
    """(ms, by): the mean device time in ms of one launch of the CUDA
    function whose name holds ``kernel`` (``KERNEL_FN``), over ``reps``
    calls of ``fn()`` traced by ``torch.profiler`` after one warm-up
    call - the kernel's own entries only, summed and divided by their
    count - and ``by`` "trace". A trace that does not hold at least half
    as many launches as calls, and no more, is taken again, up to
    ``TRACES`` times (the tracer has been seen to miss one launch, and in
    one run every launch of a kernel in three traces in a row). After
    that the time is CUDA events' time a call, host work included, ``by``
    is "events", and a line says so: such a time is kept, but neither
    ranked here (``rank``) nor compared by ``tools/compare_pops.py``.
    """
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(TRACES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, n = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and kernel in e.key:
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                n += e.count
        if reps // 2 <= n <= reps and n:
            return total / n / 1e3, "trace"
    ms = cuda_ms(fn, reps)
    say(f"device_ms: {n} launches of {kernel} in {reps} calls, {TRACES} "
        f"traces running; CUDA events' time a call instead (ms_by "
        f"events, not ranked or compared): {ms:.4f} ms")
    return ms, "events"


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


def kernel_inputs(seed: int = 0, lanes: int = LANES, steps: int = 0):
    """Seeded inputs of ``lanes`` lanes at the main paths' step counts -
    784 Bernoulli pixel steps (push and dyntable pop), 40 latent steps
    (grid pops, starts), one Categorical block of 64 pops against
    257-entry tables - or, when ``steps`` is given, at ``steps`` for
    every kernel."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    L = lanes
    P, S, TS = (steps,) * 3 if steps else (784, 40, TABLE_STEPS)
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
    feed_t = rng.integers(0, 1 << 16, (TS, L))
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    mu_l, scale = logistic_params(L, S)
    return {"head": head, "starts": i32(starts), "freqs": i32(freqs),
            "tables": i32(tables), "feed_p": i32(feed_p),
            "feed_s": i32(feed_s), "mu": torch.from_numpy(mu),
            "sigma": torch.from_numpy(sigma), "idx": i32(idx),
            "table": i32(table), "feed_t": i32(feed_t),
            "mu_l": torch.from_numpy(mu_l.T.copy()),
            "scale": torch.from_numpy(scale.T.copy())}


def logistic_params(lanes: int, dims: int = LOG_DIMS):
    """Phase 9's logistic parameters, (mu, scale) float32[lanes, dims]
    from numpy seed 9, scale in [0.05, 2]."""
    import numpy as np
    rng = np.random.default_rng(9)
    mu = rng.normal(0.0, 1.0, (lanes, dims)).astype(np.float32)
    scale = rng.uniform(0.05, 2.0, (lanes, dims)).astype(np.float32)
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


def work(name: str, d, out) -> tuple:
    """(bytes, flops) the call of kernel ``name`` on inputs ``d`` must move
    and do: each input read once, each output written once; the feed
    counted as far as it was read."""
    L = d["head"].shape[0]
    P, S, TS = (d[k].shape[0] for k in ("feed_p", "feed_s", "feed_t"))
    reads = 4 * int(out[2].sum()) \
        if name.startswith("pop") and name != "pop_slots" else 0
    if name == "push_emit":
        return 16 * P * L + 16 * L, 0
    if name == "pop_slots":
        return 12 * L, 0
    if name == "pop_table_emit":
        return 4 * d["table"].shape[1] * L + 4 * TS * L + reads + 20 * L, 0
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


def shape_key(name: str, lanes: int, steps: int) -> str:
    """How ``watch_shapes`` names a coder kernel's launch shape."""
    return f"{lanes}" if name == "pop_slots" else f"{lanes}x{steps}"


def time_shape(name: str, lanes: int, steps: int, paths: str, e) -> dict:
    """Kernel ``name`` at ``lanes`` x ``steps`` against its plain version,
    and its device time per launch there beside its time per call (host
    and device) and its bound."""
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    d = {k: v.cuda() for k, v in kernel_inputs(lanes + steps, lanes,
                                                  steps).items()}
    got = run(K, name, d, e)
    want, plain_ms = cuda_span(lambda: run(T, name, d, e))
    worst, bad = max_err(got, want)
    call = lambda: run(K, name, d, e)
    ms, ms_by = device_ms(call, KERNEL_FN[name])
    shape = {"shape": shape_key(name, lanes, steps), "paths": paths,
             "ms": ms, "ms_by": ms_by,
             "call_ms": cuda_ms(call, 20), "plain_ms": plain_ms,
             "mismatches": bad, "max_abs_err": worst}
    if name == "pop_slots":
        # One PyTorch call computes peek's values (in int64): the library
        # column, its kernel's device time.
        import torch
        mask = (1 << 16) - 1
        shape["library_ms"], shape["library_ms_by"] = device_ms(
            lambda: torch.bitwise_and(d["head"], mask), "elementwise_kernel")
    shape.update(bound(*work(name, d, got)))
    library = f", library {shape['library_ms']:.4f} ms" \
        if "library_ms" in shape else ""
    say(f"phase 3: {name} at {shape['shape']} (phases {paths}): "
        f"mismatches {bad}, device {shape['ms']:.4f} ms a launch, per call "
        f"(host + device) {shape['call_ms']:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {shape['bound_ms']:.5f} ms "
        f"({shape['bound_by']}){library}")
    return shape


def bound(nbytes: int, flops: int, flop_rate: float = FP32_FLOPS) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    flops over ``flop_rate``, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def check_kernels():
    """Phase 3: each kernel vs its plain version on the same inputs on the
    card, at LANES and at its paths' shapes (``PATH_SHAPES``, where it is
    timed); returns records."""
    from repro_torch.core import discretize
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    gpu = {k: v.cuda() for k, v in kernel_inputs().items()}
    e_gpu = discretize.edge_table(10, "cuda")
    records, bad_all = [], 0
    for name in REPLACES:
        if name == "bucketize" or name.startswith("flash_fwd"):
            continue
        worst, bad = max_err(run(K, name, gpu, e_gpu),
                             run(T, name, gpu, e_gpu))
        say(f"phase 3: {name} at {LANES} lanes: mismatches {bad}, "
            f"max_abs_err {worst}")
        shapes = [time_shape(name, lanes, steps, paths, e_gpu)
                  for (lanes, steps), paths in PATH_SHAPES[name]]
        records.append(record(name, worst, shapes))
        bad_all += bad + sum(sh["mismatches"] for sh in shapes)
    by_name = {r["name"]: r for r in records}
    bad_all += check_push()
    bad_all += check_pops(by_name, e_gpu)
    bad_all += check_tables(by_name["pop_table_emit"])
    rec, bad = check_bucketize()
    records.append(rec)
    if bad_all or bad:
        raise SystemExit("phase 3: a kernel disagrees with its plain version")
    return records


def push_edges(lanes: int, steps: int, precision: int):
    """Seeded push inputs at the edges of the kernel's reciprocal
    division, on the card: freq 1 and 2^precision (where freq <<
    (32 - precision) wraps to 0) among random ones, start + freq <=
    2^precision, and heads within 2^12 of 2^32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(lanes + steps + precision)
    total = 1 << precision
    pick = rng.random((steps, lanes))
    freq = np.where(pick < 0.2, 1, np.where(
        pick < 0.4, total, rng.integers(1, total + 1, (steps, lanes))))
    start = rng.integers(0, total - freq + 1)
    head = (1 << 32) - 1 - rng.integers(0, 1 << 12, lanes)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return (torch.from_numpy(head.astype(np.int64)).cuda(),
            i32(start).cuda(), i32(freq).cuda())


def check_push() -> int:
    """Phase 3's push beyond its shapes: the adversarial inputs of
    ``PUSH_EDGES`` bit for bit against the plain version; returns the
    mismatch count."""
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    bad_all = 0
    for lanes, steps, precision in PUSH_EDGES:
        args = (*push_edges(lanes, steps, precision), precision)
        worst, bad = max_err(K.push_emit(*args), T.push_emit(*args))
        say(f"phase 3: push_emit edges ({lanes} lanes x {steps} steps, "
            f"precision {precision}, freq 1 and 2^{precision}, heads near "
            f"2^32): mismatches {bad}, max_abs_err {worst}")
        bad_all += bad
    return bad_all


def grid_inputs(lanes: int, steps: int, seed: int, edges: bool):
    """Grid-pop inputs (head, mu, sigma, feed) on the card: phase 3's
    draws (mu ~ N(0, 1.5), sigma log-uniform over [e^-4, e]) or, with
    ``edges``, heads near 2^32 and heads whose first slot is 0 or
    2^16 - 1, mu over [-8, 8] and sigma log-uniform over [1e-3, 30],
    each range's ends included."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    head = rng.integers(1 << 16, 1 << 32, lanes, dtype=np.int64)
    if edges:
        head[::4] = (1 << 32) - 1 - rng.integers(0, 1 << 12,
                                                 len(head[::4]))
        head[1::4] &= ~0xFFFF
        head[2::4] |= 0xFFFF
        mu = rng.uniform(-8.0, 8.0, (steps, lanes))
        mu[0, :2] = (-8.0, 8.0)[:lanes]
        sigma = np.exp(rng.uniform(np.log(1e-3), np.log(30.0),
                                   (steps, lanes)))
        sigma[1, :2] = (1e-3, 30.0)[:lanes]
    else:
        mu = rng.normal(0.0, 1.5, (steps, lanes))
        sigma = np.exp(rng.uniform(-4.0, 1.0, (steps, lanes)))
    feed = rng.integers(0, 1 << 16, (steps, lanes))
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    return (torch.from_numpy(head).cuda(), f32(mu), f32(sigma),
            torch.from_numpy(feed.astype(np.int32)).cuda())


def dyn_inputs(lanes: int, steps: int, a1: int, seed: int):
    """Dyntable-pop inputs (head, tables, feed) on the card: heads near
    2^32 among random ones, non-decreasing tables 0 .. 2^16 with symbols
    of zero frequency."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    head = rng.integers(1 << 16, 1 << 32, lanes, dtype=np.int64)
    head[::3] = (1 << 32) - 1 - rng.integers(0, 1 << 12, len(head[::3]))
    w = rng.integers(1, 100, (steps, lanes, a1 - 1)) * \
        (rng.random((steps, lanes, a1 - 1)) > 0.2)
    w[..., 0] += 1
    cdf = np.floor(np.cumsum(w, -1) / w.sum(-1, keepdims=True) * (1 << 16))
    tables = np.concatenate([np.zeros((steps, lanes, 1)), cdf], -1)
    tables[..., -1] = 1 << 16
    feed = rng.integers(0, 1 << 16, (steps, lanes))
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()
    return torch.from_numpy(head).cuda(), i32(tables), i32(feed)


def check_pops(recs: dict, e) -> int:
    """Phase 3's grid and dyntable pops beyond their shapes: the grid pops
    on edge inputs at ``POP_LANES``, bit for bit, and each CDF kind's
    device time at 40 steps on either side of its group's threshold
    (``GROUP_EDGES``, kept as ``ms_by_lanes``); the uniform pop at
    ``POP_LANES`` x 392 steps over ``UNIFORM_EDGES``; the dyntable pop at
    the widths of ``DYN_A1``. Returns the mismatch count."""
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    bad_all = 0
    for kind in ("gaussian", "logistic"):
        for lanes in POP_LANES:
            args = grid_inputs(lanes, 40, lanes, edges=True)
            bad = max_err(K.pop_grid_emit(*args, e, kind, 10, 16),
                          T.pop_grid_emit(*args, e, kind, 10, 16))[1]
            say(f"phase 3: pop_grid_emit/{kind} edges ({lanes} lanes x 40 "
                f"steps): mismatches {bad}")
            bad_all += bad
        rec = recs[f"pop_grid_emit/{kind}"]
        rec["ms_by_lanes"] = {}
        for lanes in GROUP_EDGES[kind]:
            args = grid_inputs(lanes, 40, lanes, edges=False)
            call = lambda: K.pop_grid_emit(*args, e, kind, 10, 16)
            bad = max_err(call(), T.pop_grid_emit(*args, e, kind, 10,
                                                  16))[1]
            bad_all += bad
            ms, ms_by = device_ms(call, KERNEL_FN[rec["name"]])
            rec["ms_by_lanes"][lanes] = {"ms": ms, "ms_by": ms_by}
            say(f"phase 3: pop_grid_emit/{kind} at {lanes} lanes x 40 "
                f"steps: mismatches {bad}, device {ms:.4f} ms a launch")
    for lanes in POP_LANES:
        for lat_bits, precision in UNIFORM_EDGES:
            head, _, _, feed = grid_inputs(lanes, 392, lanes + lat_bits,
                                           edges=True)
            args = (head, None, None, feed, None, "uniform", lat_bits,
                    precision)
            want = T.pop_grid_emit(*args)
            bad = max_err(K.pop_grid_emit(*args), want)[1]
            say(f"phase 3: pop_grid_emit/uniform edges ({lanes} lanes x "
                f"392 steps, lat_bits {lat_bits}, precision {precision}: "
                f"{int(want[2].min())}-{int(want[2].max())} reads a lane): "
                f"mismatches {bad}")
            bad_all += bad
    for a1 in DYN_A1:
        for lanes in (33, LANES + 5):
            args = dyn_inputs(lanes, DYN_STEPS, a1, lanes + a1)
            bad = max_err(K.pop_dyntable_emit(*args, 16),
                          T.pop_dyntable_emit(*args, 16))[1]
            say(f"phase 3: pop_dyntable_emit A+1 = {a1} ({lanes} lanes x "
                f"{DYN_STEPS} steps): mismatches {bad}")
            bad_all += bad
    return bad_all


def table_pop_inputs(lanes: int, steps: int, a1: int, seed: int):
    """Table-pop inputs (head, table, feed) on the card: heads near 2^32
    and heads whose first slot is 0 or 2^16 - 1 among random ones;
    non-decreasing rows 0 .. 2^16 with symbols of zero frequency, every
    seventh row from the fourth all zeros (a padded lane)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    head = rng.integers(1 << 16, 1 << 32, lanes, dtype=np.int64)
    head[::4] = (1 << 32) - 1 - rng.integers(0, 1 << 12, len(head[::4]))
    head[1::4] &= ~0xFFFF
    head[2::4] |= 0xFFFF
    w = rng.integers(1, 100, (lanes, a1 - 1), dtype=np.int32) * \
        (rng.random((lanes, a1 - 1), dtype=np.float32) > 0.2)
    w[:, 0] += 1
    cdf = np.floor(np.cumsum(w, 1, dtype=np.int64) * float(1 << 16)
                   / w.sum(1, keepdims=True, dtype=np.int64))
    table = np.concatenate([np.zeros((lanes, 1)), cdf], 1).astype(np.int32)
    table[:, -1] = 1 << 16
    table[3::7] = 0
    feed = rng.integers(0, 1 << 16, (steps, lanes))
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return (torch.from_numpy(head).cuda(), i32(table).cuda(),
            i32(feed).cuda())


def check_tables(rec: dict) -> int:
    """Phase 3's table pop beyond its path's shape: each of
    ``TABLE_CASES`` bit for bit against the plain version (on the card)
    and its device time a launch, kept as ``ms_by_width`` ("A+1 x
    lanes"). Returns the mismatch count."""
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    bad_all = 0
    rec["ms_by_width"] = {}
    for a1, lanes in TABLE_CASES:
        args = (*table_pop_inputs(lanes, DYN_STEPS, a1, lanes + a1), 16)
        call = lambda: K.pop_table_emit(*args)
        worst, bad = max_err(call(), T.pop_table_emit(*args))
        ms, ms_by = device_ms(call, KERNEL_FN["pop_table_emit"], 10)
        rec["ms_by_width"][f"{a1} x {lanes}"] = {"ms": ms, "ms_by": ms_by}
        say(f"phase 3: pop_table_emit A+1 = {a1} ({lanes} lanes x "
            f"{DYN_STEPS} steps): mismatches {bad}, max_abs_err {worst}, "
            f"device {ms:.4f} ms a launch")
        bad_all += bad
    return bad_all


def record(name: str, worst: int, shapes: list) -> dict:
    """Phase 3's record of kernel ``name``: its first shape's numbers (the
    paths' most launched), all shapes under ``shapes``."""
    first = shapes[0]
    rec = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name], "launches": 0,
           "max_abs_err": max([worst] +
                              [sh["max_abs_err"] for sh in shapes]),
           "ms": first["ms"], "ms_by": first["ms_by"],
           "call_ms": first["call_ms"],
           "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
           "bound_by": first["bound_by"],
           "library_ms": first.get("library_ms"),
           "shape": first["shape"], "shapes": shapes}
    say(f"phase 3: {name} at {first['shape']}: device "
        f"{rec['ms']:.4f} ms a launch, bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']})")
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
    the plain version, and timed; returns (the record, the mismatch count
    over all)."""
    from repro_torch.core import discretize
    from repro_torch.kernels.bucketize import kernel as BK
    from repro_torch.kernels.bucketize import twin as BT

    shapes, bad_all, worst_all = [], 0, 0
    for lanes, lat_bits, paths in BK_CASES:
        slot, mu, sigma = bucketize_inputs(lanes)
        edges = discretize.edge_table(lat_bits, "cuda")
        call = lambda mod: mod.bucketize(slot, mu, sigma, edges, lat_bits,
                                         16)
        want, plain_ms = cuda_span(lambda: call(BT))
        worst, bad = max_err(call(BK), want)
        ms, ms_by = device_ms(lambda: call(BK), KERNEL_FN["bucketize"])
        shape = {"shape": f"{lanes}, lat_bits {lat_bits}", "paths": paths,
                 "ms": ms, "ms_by": ms_by,
                 "call_ms": cuda_ms(lambda: call(BK), 20),
                 "plain_ms": plain_ms, "mismatches": bad,
                 "max_abs_err": worst}
        # Each lane reads slot, mu, sigma and writes idx, start, freq;
        # lat_bits + 1 bisection steps and the two ends evaluate F.
        shape.update(bound(24 * lanes + 4 * ((1 << lat_bits) + 1),
                           (lat_bits + 3) * FLOPS_PER_F * lanes))
        say(f"phase 3: bucketize at {lanes} lanes, lat_bits {lat_bits} "
            f"(phases {paths}): mismatches {bad}, max_abs_err {worst}, "
            f"device {shape['ms']:.4f} ms a launch, per call (host + "
            f"device) {shape['call_ms']:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {shape['bound_ms']:.5f} ms ({shape['bound_by']})")
        shapes.append(shape)
        bad_all += bad
        worst_all = max(worst_all, worst)
    return record("bucketize", worst_all, shapes), bad_all


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


# Launches by kernel and shape since the last ``counted`` reset (filled
# by ``watch_shapes``), and those of every counted path.
SHAPES: dict = {}
PATH_SHAPES_SEEN: list = []
# The wrapper argument that holds [steps, lanes]: the push's starts, the
# pops' feed (the CDF grid pop's mu).
STEPS_ARG = {"push_emit": 0, "pop_table_emit": 1, "pop_dyntable_emit": 1,
             "pop_grid_uniform": 0, "pop_grid_cdf": 0}


def flash_shape(q) -> str:
    """How ``watch_shapes`` names a flash launch: q's [BH, S, D], dtype."""
    return "x".join(map(str, q.shape)) + " " + \
        str(q.dtype).removeprefix("torch.")


def launch_shape(fn: str, head, args) -> str:
    """The shape of a launch of extension function ``fn`` on ``head`` and
    ``args``, named as phase 3 names its timed shapes."""
    if fn == "bucketize":
        return f"{head.shape[0]}, lat_bits {args[3]}"
    if fn == "flash_fwd":
        return flash_shape(head)
    if fn == "pop_slots":
        return f"{head.shape[0]}"
    steps, lanes = (head if fn == "grid_starts" else args[STEPS_ARG[fn]]) \
        .shape[:2]
    return f"{lanes}x{steps}"


def watch_shapes() -> None:
    """Wrap ``kernel.launch`` so that each counted launch is also counted
    by shape in ``SHAPES``; the counts in ``LAUNCHES`` are the wrapper's
    own, as before."""
    from repro_torch.kernels.ans import kernel as K

    launch = K.launch

    def watched(counter, fn, head, *args):
        out = launch(counter, fn, head, *args)
        if head.numel():
            key = launch_shape(fn, head, args)
            for name in (counter,) if isinstance(counter, str) else counter:
                by = SHAPES.setdefault(name, {})
                by[key] = by.get(key, 0) + 1
        return out

    K.launch = watched


def counted(phase: str, kernels, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; fails when one of ``kernels`` was not launched. Returns
    (``fn()``'s result, the counts); the counts by shape are kept in
    ``PATH_SHAPES_SEEN``."""
    from repro_torch.kernels.ans import kernel as K

    K.reset_launches()
    SHAPES.clear()
    out = fn()
    launches = dict(K.LAUNCHES)
    PATH_SHAPES_SEEN.append({k: dict(v) for k, v in SHAPES.items()})
    say(f"{phase}: launches {json.dumps(launches)}")
    say(f"{phase}: launches by shape {json.dumps(SHAPES)}")
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


def lm_layer0_qkv(params, cfg, tokens):
    """q, k, v of layer 0 of the prefill of ``tokens``, in the flash
    kernel's layout ([B * H, S, Dh], contiguous), as ``prefill`` computes
    them before it attends."""
    import torch
    from repro_torch.models import attention, layers, transformer

    dt = transformer._compute_dtype(cfg)
    b, s = tokens.shape
    p0 = transformer._layers(params["blocks"], 1)[0]
    x = layers.embed_apply(params["embed"], tokens, dt)
    h = layers.norm_apply(cfg.norm, p0["ln1"], x)
    q, k, v = attention._qkv(p0["attn"], h, cfg,
                             transformer._positions(cfg, b, s, x.device), dt)
    fold = lambda t: t.transpose(1, 2).reshape(-1, s, t.shape[-1]) \
        .contiguous()
    return fold(q), fold(k), fold(v)


def flash_bound(bh: int, bkv: int, sq: int, sk: int, d: int, itemsize: int,
                causal: bool, window: int, flop_rate: float) -> tuple:
    """(bound ms, what bounds it): q, k, v read once and the output written
    once, against q . k and p . v over the (query, key) pairs the masks
    leave, at ``flop_rate`` (the route's: bf16 tensor cores for ``wgmma``,
    FP32 CUDA cores for ``simt``)."""
    pairs = 0
    for qi in range(sq):
        hi = min(sk, qi + 1) if causal else sk
        lo = max(0, qi - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo)
    flops = 2 * 2 * bh * pairs * d
    nbytes = itemsize * d * (2 * bh * sq + 2 * bkv * sk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                 else "bytes")


def check_flash(q, k, v, *, causal: bool, window: int, label: str,
                paths: str = "14") -> dict:
    """The flash kernel of q's route against its plain version on (q, k,
    v) [BH, S, D] on the card (on the kernel's tiles), beside SDPA;
    returns the route's record, its shape launched by ``paths``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.flash import twin as FT

    kw = dict(causal=causal, window=window)
    name = f"flash_fwd/{FK.route(q.dtype)}"
    tiles = FT.simt_tiles(q.shape[-1], *q.shape[:2]) \
        if name.endswith("simt") else None
    got = FK.flash_fwd(q, k, v, **kw)
    want, plain_ms = cuda_span(lambda: FT.flash_fwd(q, k, v, tiles=tiles,
                                                    **kw))
    tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    diff = (got.float() - want.float()).abs()
    worst = float(diff.max())
    # allclose with rtol = atol = tol: outputs of layer 0 reach tens, where
    # one bfloat16 ulp is 0.25
    ratio = float((diff / (tol + tol * want.float().abs())).max())
    call = lambda: FK.flash_fwd(q, k, v, **kw)
    (ms, ms_by), call_ms = device_ms(call, KERNEL_FN[name], 10), \
        cuda_ms(call, 10)
    bh, sq, d = q.shape
    bkv, sk = k.shape[:2]
    bound_ms, bound_by = flash_bound(
        bh, bkv, sq, sk, d, q.element_size(), causal, window,
        BF16_FLOPS if name.endswith("wgmma") else FP32_FLOPS)
    # SDPA on [1, BH, S, D] with the key heads repeated and, for a window,
    # the mask built (both outside the timed call): the library column
    # only, CUDA-event time a call. (Its traced device time is not kept:
    # the tracer has dropped most of its launches' entries in this
    # script, and at [4, 2100, 16] all of them.)
    g = bh // bkv
    q4, k4, v4 = (t[None] for t in (q, k.repeat_interleave(g, 0),
                                    v.repeat_interleave(g, 0)))
    mask = None
    if window > 0:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(sk, device=q.device)[None, :]
        mask = (j > i - window) & ((j <= i) if causal else True)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, is_causal=causal and mask is None), 10)
    say(f"phase 14: {name} {label} ({bh} heads on {bkv} key heads, "
        f"{sq} x {sk}, D {d}, {q.dtype}, causal {causal}, window {window}): "
        f"max_abs_err {worst:.3g} at |out| up to "
        f"{float(want.float().abs().max()):.3g} (rtol = atol = {tol}: "
        f"{ratio:.3g} of it), device {ms:.4f} ms a launch, per call (host "
        f"+ device) {call_ms:.4f} ms, plain {plain_ms:.2f} ms, SDPA "
        f"{library_ms:.4f} ms a call, bound {bound_ms:.5f} ms "
        f"({bound_by}); kernel / SDPA {ms / library_ms:.3f} (device), "
        f"{call_ms / library_ms:.3f} (a call)")
    if not ratio <= 1.0:
        raise SystemExit("phase 14: the flash kernel disagrees with its "
                         "plain version")
    shape = {"shape": flash_shape(q), "paths": paths, "ms": ms,
             "ms_by": ms_by, "call_ms": call_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms, "max_abs_err": worst}
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": worst,
            "ms": ms, "ms_by": ms_by, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": shape["shape"],
            "shapes": [shape]}


def seeded_qkv(heads: int, kv_heads: int, s: int, d: int, rng):
    """float32 q [heads, s, d] and k, v [kv_heads, s, d] from ``rng``'s
    normal draws, on the card."""
    import numpy as np
    import torch
    return tuple(torch.from_numpy(rng.normal(0, 1, (n, s, d))
                                  .astype(np.float32)).cuda()
                 for n in (heads, kv_heads, kv_heads))


def check_flash_prefill(rec: dict, cfg, label: str, *, batch: int, s: int,
                        dtype: str = "float32", paths: str = "none") -> None:
    """The route of ``dtype`` (float32: simt; bfloat16: wgmma) at the
    shape a prefill of ``cfg`` computing in ``dtype`` gives it - ``batch``
    prompts of ``s`` tokens, causal, no window - on seeded inputs, its
    shape added to the route's record ``rec``."""
    import numpy as np
    import torch
    q, k, v = (t.to(getattr(torch, dtype)) for t in seeded_qkv(
        batch * cfg.n_heads, batch * cfg.n_kv_heads, s, cfg.head_dim,
        np.random.default_rng(FLASH_F32_SEED)))
    rec["shapes"] += check_flash(q, k, v, causal=True, window=0,
                                 label=label, paths=paths)["shapes"]


def lm_twin_check() -> dict:
    """Phase 14's card against CPU twin: the reduced qwen2-0.5b's prefill
    logits of one 2100-token prompt (the blockwise branch: plain flash on
    the CPU, the kernel of the compute dtype's route on the card); returns
    the launch counts of each card prefill, by ``lm_prefill_<dtype>``."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import base
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.models import transformer

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, LM_TWIN_VOCAB, (1, LM_TWIN_PROMPT)).astype(np.int32))
    counts = {}
    for compute, tol in LM_TWIN_TOL.items():
        cfg = dataclasses.replace(base.reduced(base.get(LM_ARCH)),
                                  vocab=LM_TWIN_VOCAB, compute_dtype=compute)
        params = transformer.init(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        on_card = transformer._tree_map(lambda t: t.cuda(), params)
        t0 = time.perf_counter()
        cpu = transformer.prefill(params, cfg, {"tokens": toks},
                                  LM_TWIN_PROMPT)[0]
        t_cpu = time.perf_counter() - t0
        route = f"flash_fwd/{FK.route(getattr(torch, compute))}"
        card, counts[f"lm_prefill_{compute}"] = counted(
            f"phase 14 {compute} prefill", (route,),
            lambda: transformer.prefill(on_card, cfg,
                                        {"tokens": toks.cuda()},
                                        LM_TWIN_PROMPT)[0].cpu())
        err = float((card.float() - cpu.float()).abs().max())
        say(f"phase 14: reduced {LM_ARCH} ({cfg.n_layers} layers, width "
            f"{cfg.d_model}, vocab {cfg.vocab}), {LM_TWIN_PROMPT}-token "
            f"prefill at {compute}: card vs CPU twin max |logit diff| "
            f"{err:.3g} (tolerance {tol}; logits up to "
            f"{float(cpu.float().abs().max()):.3g}; CPU twin {t_cpu:.1f} s)")
        if not err <= tol:
            raise SystemExit("phase 14: card and CPU twin prefill logits "
                             "disagree")
    return counts


def lm_serve_path(card: str):
    """Phase 14: the LM serving engine on qwen2-0.5b at full width;
    returns (the flash records, launch counts by path: one generate and
    the reduced prefills, and the traced pairs)."""
    import numpy as np
    import torch
    from repro_torch import stream
    from repro_torch.configs import base
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.models import transformer
    from repro_torch.serve import Engine

    t_phase = time.perf_counter()
    cfg = base.get(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init(cfg, gen, device="cuda")
    eng = Engine(params, cfg, max_len=LM_PROMPT + LM_NEW, device="cuda")
    rng = np.random.default_rng(0)
    prompts = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).cuda()}

    records = [check_flash(*lm_layer0_qkv(params, cfg, prompts["tokens"]),
                           causal=True, window=0, label="layer 0 of the "
                           "prefill")]
    q, k, v = seeded_qkv(LM_BATCH * cfg.n_heads, LM_BATCH * cfg.n_kv_heads,
                         FLASH_RAGGED["s"], cfg.head_dim, rng)
    records.append(check_flash(q, k, v, causal=True,
                               window=FLASH_RAGGED["window"],
                               label="ragged"))
    del q, k, v
    check_flash_prefill(records[-1], cfg, "causal, full width",
                        batch=LM_BATCH, s=FLASH_F32_PROMPT)
    reduced = base.reduced(cfg)
    for rec in records:
        dtype = "float32" if rec["name"].endswith("simt") else "bfloat16"
        check_flash_prefill(rec, reduced, f"the reduced {dtype} prefill's "
                            "shape", batch=1, s=LM_TWIN_PROMPT, dtype=dtype,
                            paths="14")

    generate = lambda: eng.generate(prompts, LM_NEW)
    (first, gen_ms), launches = counted("phase 14", LM_KERNELS,
                                        lambda: cuda_span(generate))
    K.reset_launches()
    second = generate()
    again = K.LAUNCHES["flash_fwd/wgmma"]
    same = torch.equal(first, second)
    say(f"phase 14: {LM_ARCH} at full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f}M float32 "
        f"parameters): generate {LM_BATCH} x {LM_PROMPT} + {LM_NEW} in "
        f"{gen_ms:.1f} ms; the same tokens twice: {same}; tensor-core "
        f"flash launches {launches['flash_fwd/wgmma']} and {again} (want "
        f"{cfg.n_layers} a prefill, of {launches['flash_fwd']} in all) on "
        f"{card}")
    if not same or launches["flash_fwd/wgmma"] != cfg.n_layers \
            or again != cfg.n_layers \
            or launches["flash_fwd"] != cfg.n_layers:
        raise SystemExit("phase 14: generate is not deterministic or did "
                         "not attend through the tensor-core flash kernel "
                         "once a layer")

    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_LANES, LM_TOKENS)).astype(np.int32)).cuda()
    n = toks.numel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = eng.compress(toks)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    back = eng.decompress(blob, LM_TOKENS)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0 - t_enc
    lossless = torch.equal(back, toks)
    say(f"phase 14: compress {LM_LANES} lanes x {LM_TOKENS} tokens: "
        f"{len(blob)} bytes, {8 * len(blob) / n:.4f} bits/token "
        f"(log2 V = {np.log2(cfg.vocab):.4f}), lossless {lossless}; "
        f"{n / t_enc:.1f} tokens/s encode, {n / t_dec:.1f} tokens/s decode "
        f"(host clock)")
    wire = eng.compress_stream(toks, block_symbols=LM_BLOCK)
    _, offsets, _ = stream.format.scan(wire)
    tail = stream.decode_from_offset(None, wire, offsets[1],
                                     block_codec_fn=eng._block_codec_fn(),
                                     device="cuda")
    streamed = torch.equal(eng.decompress_stream(wire), toks)
    resumed = torch.equal(tail.T, toks[:, LM_BLOCK:])
    say(f"phase 14: compress_stream in blocks of {LM_BLOCK}: {len(wire)} "
        f"bytes over {len(offsets)} blocks, lossless {streamed}; resume "
        f"from block 1 (byte {offsets[1]}) lossless {resumed}")
    if not (lossless and streamed and resumed):
        raise SystemExit("phase 14: the token streams did not decode "
                         "losslessly")
    by_path = {"lm_generate": launches, **lm_twin_check()}
    say(f"phase 14: wall {time.perf_counter() - t_phase:.1f} s")
    # One block's tokens: a trace of the whole 128 (some 840,000 launches)
    # takes the profiler minutes to sum.
    traced = {
        "phase14": (lambda: eng.compress(toks[:, :LM_BLOCK]),
                    lambda b: eng.decompress(b, LM_BLOCK)),
        "phase14_generate": (generate, lambda out: None)}
    return records, by_path, traced


def stablelm_path(card: str, records: list) -> dict:
    """Phase 14, stablelm-12b: the D-160 flash routes against their plain
    version beside SDPA (kept in the routes' records under ``d160``),
    then ``generate`` twice; returns the launch counts of one generate."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import base
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.models import transformer
    from repro_torch.serve import Engine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(base.get(SLM_ARCH), param_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init(cfg, gen, device="cuda")
    eng = Engine(params, cfg, max_len=LM_PROMPT + LM_NEW, device="cuda")
    rng = np.random.default_rng(2)
    prompts = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).cuda()}
    by_name = {r["name"]: r for r in records}
    d160 = check_flash(*lm_layer0_qkv(params, cfg, prompts["tokens"]),
                       causal=True, window=0,
                       label=f"{SLM_ARCH} layer 0 of the prefill")
    say(f"phase 14: {SLM_ARCH} flash D {cfg.head_dim}: kernel / SDPA "
        f"{d160['ms'] / d160['library_ms']:.3f}")
    q, k, v = seeded_qkv(cfg.n_heads, cfg.n_kv_heads, FLASH_RAGGED["s"],
                         cfg.head_dim, rng)
    d160_f32 = check_flash(q, k, v, causal=True,
                           window=FLASH_RAGGED["window"],
                           label=f"ragged D {cfg.head_dim}")
    del q, k, v
    for rec in (d160, d160_f32):
        by_name[rec["name"]]["d160"] = {
            key: rec[key] for key in ("max_abs_err", "ms", "ms_by",
                                      "call_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}
        by_name[rec["name"]]["shapes"] += rec["shapes"]
    check_flash_prefill(by_name["flash_fwd/simt"], cfg,
                        f"{SLM_ARCH} causal, full width", batch=LM_BATCH,
                        s=FLASH_F32_PROMPT)

    generate = lambda: eng.generate(prompts, LM_NEW)
    (first, gen_ms), launches = counted(f"phase 14 {SLM_ARCH}", LM_KERNELS,
                                        lambda: cuda_span(generate))
    K.reset_launches()
    second = generate()
    again = K.LAUNCHES["flash_fwd/wgmma"]
    same = torch.equal(first, second)
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"phase 14: {SLM_ARCH} at full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{n_params / 1e9:.2f}B bfloat16 parameters): generate {LM_BATCH} "
        f"x {LM_PROMPT} + {LM_NEW} in {gen_ms:.1f} ms; the same tokens "
        f"twice: {same}; tensor-core flash launches "
        f"{launches['flash_fwd/wgmma']} and {again} (want {cfg.n_layers} "
        f"a prefill, of {launches['flash_fwd']} in all); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB on {card}")
    if not same or launches["flash_fwd/wgmma"] != cfg.n_layers \
            or again != cfg.n_layers \
            or launches["flash_fwd"] != cfg.n_layers:
        raise SystemExit(f"phase 14: {SLM_ARCH} generate is not "
                         "deterministic or did not attend through the "
                         "tensor-core flash kernel once a layer")
    say(f"phase 14: {SLM_ARCH} wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


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


def rank(records: list) -> None:
    """The kernels ranked by the device time their counted launches spend
    above their bound: launches x (device ms - bound ms), summed over the
    shapes phase 3 timed by a trace (``gap_ms``); launches at shapes it
    did not time, or timed only by CUDA events (``ms_by`` "events": host
    work included), are counted apart (``untimed_launches``)."""
    for rec in records:
        by_shape = {}
        for seen in PATH_SHAPES_SEEN:
            for key, n in seen.get(rec["name"], {}).items():
                by_shape[key] = by_shape.get(key, 0) + n
        timed = {sh["shape"]: sh for sh in rec.get("shapes", [])
                 if sh["ms_by"] == "trace"}
        rec["launches_by_shape"] = by_shape
        rec["gap_ms"] = sum(n * (timed[k]["ms"] - timed[k]["bound_ms"])
                            for k, n in by_shape.items() if k in timed)
        rec["untimed_launches"] = sum(n for k, n in by_shape.items()
                                      if k not in timed)
    for i, rec in enumerate(sorted(records, key=lambda r: -r["gap_ms"])):
        say(f"ranking {i + 1}: {rec['name']}: {rec['gap_ms']:.3f} ms above "
            f"its bound over {rec['launches']} launches ("
            + ", ".join(f"{k}: {n}" for k, n in
                        rec["launches_by_shape"].items())
            + f"; {rec['untimed_launches']} at shapes not timed by a "
            "trace)")


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

    watch_shapes()
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
    flash_records, lm_counts, lm_traced = lm_serve_path(smi)
    records += flash_records
    by_path.update(lm_counts)
    traced.update(lm_traced)
    by_path["lm_generate_stablelm"] = stablelm_path(smi, records)
    stamp("phase 14")
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
    rank(records)
    say(f"card: {smi}")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
