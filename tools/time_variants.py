#!/usr/bin/env python3
"""Time, on one GPU, kernel variants that no path launches but whose
times placed a design choice, each held to the kernel the paths launch.

    python3 tools/time_variants.py [--reps 20]

1. The table pop's narrow band (``kernels/ans/csrc/pop_table.cu``): its
   launcher walks rows of 57 to 448 entries in groups of 32 (top round
   and window) up to ``NARROW_LANES`` (2640) lanes and in groups of 8
   (top, probe round and window) above. The file is built twice more by
   nvcc with a plain C launcher (loaded through ctypes), with
   ``POP_TABLE_NARROW_LANES`` set to 2^30 (groups of 32 at every lane
   count) and to 0 (groups of 8), and both builds are timed at A+1 = 57,
   257 and 448 x 1024 to 4096 lanes (``BAND_LANES``, both sides of
   2640 and of each step of 528 lanes - a block more an SM for groups
   of 32 on the H100's 132 SMs) x 64 steps, on
   ``chip_smoke.py``'s table-pop inputs, each held bit for bit to the
   extension's ``pop_table_emit``.
2. Peek (``kernels/ans/csrc/peek.cu``, ``pop_slots``) at 4096 and 2^24
   lanes (192 MiB moved, past the 50 MB L2): bit for bit against its
   plain version, its device time beside one ``torch.bitwise_and`` on
   the same int64 heads and its byte bound (8 bytes read and 4 written a
   lane at 3.35 TB/s); and an empty kernel on peek's 4096-lane grid
   (32 x 128), the least time a launch of that grid takes.

Times are device times of one launch (``chip_smoke.device_ms``:
``torch.profiler``'s entries of the kernel's CUDA function over
``--reps`` calls). Builds into ``build/variants``. Prints the card, a
line a case, and a JSON object of the times last; exits non-zero when a
variant's output differs or a time did not come from a trace.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)
OUT = os.path.join(ROOT, "build", "variants")
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "ans", "csrc")
COMMON = os.path.join(ROOT, "src", "repro_torch", "kernels", "common")

# The table pop built with each group over the narrow band, by the lane
# threshold it is built with: 2^30 keeps groups of 32, 0 takes groups of 8.
GROUPS = {32: 1 << 30, 8: 0}
BAND_A1, BAND_STEPS = (57, 257, 448), 64
BAND_LANES = (1024, 2048, 2112, 2113, 2640, 2641, 3168, 3169, 3696, 3697,
              4096)
PEEK_LANES = (4096, 1 << 24)

TABLE_SHIM = r"""
#include "pop_table.cu"
extern "C" int pop_table_c(const int64_t* head, const int32_t* table,
                           const int32_t* feed, int64_t* out_head,
                           int32_t* syms, int32_t* reads, int steps,
                           int lanes, int a1, int precision, void* stream) {
  return (int)launch_pop_table(head, table, feed, out_head, syms, reads,
                               steps, lanes, a1, precision,
                               (cudaStream_t)stream);
}
"""
EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_c(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def build() -> dict:
    """{name: ctypes library}: the two table-pop builds ("table/32",
    "table/8") and the empty kernel ("empty"), compiled in parallel."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels.ans import kernel as K

    os.makedirs(OUT, exist_ok=True)
    jobs = {f"table/{g}": (TABLE_SHIM, [f"-DPOP_TABLE_NARROW_LANES={n}"])
            for g, n in GROUPS.items()}
    jobs["empty"] = (EMPTY, [])
    procs = {}
    for name, (text, defs) in jobs.items():
        stem = os.path.join(OUT, name.replace("/", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = (stem + ".so", subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *K.NVCC_FLAGS,
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC,
             "-I", COMMON, *defs, "-o", stem + ".so", stem + ".cu"]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait():
            raise SystemExit(f"time_variants: nvcc failed on {name}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def table_pop(lib):
    """``pop_table_emit(head, table, feed, precision)`` through ``lib``'s
    plain C launcher, on PyTorch's current stream."""
    import torch
    fn = lib.pop_table_c
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(head, table, feed, precision):
        out, syms = torch.empty_like(head), torch.empty_like(feed)
        reads = torch.zeros(table.shape[0], dtype=torch.int32,
                            device=head.device)
        err = fn(head.data_ptr(), table.data_ptr(), feed.data_ptr(),
                 out.data_ptr(), syms.data_ptr(), reads.data_ptr(),
                 feed.shape[0], table.shape[0], table.shape[1], precision,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"time_variants: the table pop did not "
                             f"launch (CUDA error {err})")
        return out, syms, reads
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as S
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.ans import twin as T

    if not torch.cuda.is_available():
        raise SystemExit("time_variants: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    K.build()
    libs = build()
    pops = {g: table_pop(libs[f"table/{g}"]) for g in GROUPS}
    bad = untraced = 0
    cases = {}

    def keep(name: str, timed: tuple, **more) -> float:
        nonlocal untraced
        ms, ms_by = timed
        untraced += ms_by != "trace"
        cases[name] = {"ms": ms, "ms_by": ms_by, **more}
        return ms

    for a1 in BAND_A1:
        for lanes in BAND_LANES:
            args = (*S.table_pop_inputs(lanes, BAND_STEPS, a1, lanes + a1),
                    16)
            want = K.pop_table_emit(*args)
            ms = {}
            for g, pop in pops.items():
                diff = sum(int((x != y).sum())
                           for x, y in zip(pop(*args), want))
                bad += diff
                ms[g] = keep(f"pop_table A+1 {a1} x {lanes}, group {g}",
                             S.device_ms(lambda: pop(*args),
                                         S.KERNEL_FN["pop_table_emit"],
                                         a.reps), mismatches=diff)
            print(f"pop_table A+1 = {a1}, {lanes} lanes x {BAND_STEPS} "
                  f"steps: group 32 {ms[32]:.5f} ms, group 8 {ms[8]:.5f} "
                  f"ms a launch (8 / 32 {ms[8] / ms[32]:.3f})", flush=True)
    mask = (1 << 16) - 1
    for lanes in PEEK_LANES:
        head = torch.from_numpy(np.random.default_rng(lanes).integers(
            1 << 16, 1 << 32, lanes, dtype=np.int64)).cuda()
        diff = int((K.pop_slots(head, 16) != T.pop_slots(head, 16)).sum())
        bad += diff
        b = S.bound(12 * lanes, 0)
        ms = keep(f"pop_slots {lanes}", S.device_ms(
            lambda: K.pop_slots(head, 16), S.KERNEL_FN["pop_slots"],
            a.reps), mismatches=diff, **b)
        lib = keep(f"torch.bitwise_and {lanes}", S.device_ms(
            lambda: torch.bitwise_and(head, mask), "elementwise_kernel",
            a.reps))
        print(f"pop_slots at {lanes} lanes: mismatches {diff}, device "
              f"{ms:.5f} ms a launch, bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}; {b['bound_ms'] / ms:.3f} of it), "
              f"torch.bitwise_and {lib:.5f} ms (peek / it {ms / lib:.3f})",
              flush=True)
        del head
    fn = libs["empty"].empty_c
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    blocks = (PEEK_LANES[0] + 127) // 128
    ms = keep(f"empty kernel {blocks}x128", S.device_ms(
        lambda: fn(blocks, 128, torch.cuda.current_stream().cuda_stream),
        "empty_kernel", a.reps))
    print(f"an empty kernel on peek's grid at {PEEK_LANES[0]} lanes "
          f"({blocks} x 128): device {ms:.5f} ms a launch", flush=True)
    print(json.dumps({"card": smi, "cases": cases}))
    return 1 if bad or untraced else 0


if __name__ == "__main__":
    sys.exit(main())
