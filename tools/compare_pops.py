#!/usr/bin/env python3
"""Time the grid pops, the dyntable pop, the table pop, the posterior
bucketize, the push-side grid starts and the float32 flash-attention
forward of two checkouts of this repo on one GPU, in turns, and check
that both write the same outputs (the flash forward: within its 2e-5
tolerance).

    python3 tools/compare_pops.py OTHER [--reps 20]

OTHER is the root of another checkout, e.g. a ``git archive`` of the
parent commit unpacked into ``build/parent``. Each turn is a process of
its own that imports ``repro_torch`` from one checkout's ``src``, builds
that checkout's kernels into its ``build/kernels`` and calls its public
wrappers (``kernels.ans.kernel.pop_grid_emit``, ``pop_dyntable_emit``,
``pop_table_emit``, ``grid_starts``, ``kernels.bucketize.kernel.bucketize``,
``kernels.flash.kernel.flash_fwd``), so the two checkouts' bindings may
differ. The turns run OTHER, this, this, OTHER. The inputs are
``chip_smoke.py``'s phase 3 and phase 14 draws: the gaussian and
logistic grid pops at 4096 lanes x 40 steps (lat_bits 10), the gaussian
at 32 lanes x 392 steps (phase 13's first level), the uniform pop at
32 x 392, 1024 x 40 (phases 5-7 and 10) and 4096 x 40, the dyntable pop
at 4096 and 32 lanes x 784 steps (A+1 = 3), the table pop at phase 8's
4096 lanes x 64 steps (A+1 = 257) and at each of ``chip_smoke.py``'s
``TABLE_CASES`` (A+1 x lanes, 70 steps), the bucketize at 256 lanes
(phase 12's) and 4096 at lat_bits 10 and 4097 at lat_bits 12, the
gaussian starts at every path shape (256 x 1, 32 x 392, 1024 x 40,
512 x 40, 1024 x 784) and the logistic at 4096 x 40, and the float32
flash forward at phase 14's ragged windowed cases (28 heads on 4 at D
64, 32 on 8 at D 160; 4100 tokens, window 1024) and causal full-width
cases ([28, 4096, 64] on 4 key heads, [64, 4096, 160] on 16). Each
case's time is the device time of one launch of its kernel
(``torch.profiler``, summed over ``--reps`` calls - 5 for the flash
forward - after a warm-up and divided by the launches), and beside it
the time per call (host + device, CUDA events). A turn whose traces lose
a case's launches times it by CUDA events instead (``ms_by`` "events",
host work included, ``chip_smoke.device_ms``): that case is not
compared (``this_over_other`` null). Prints the card, a line a case, and
a JSON object of the times last; exits non-zero when the outputs differ
(the flash forward: when a turn's output is not within rtol = atol =
2e-5 of the first turn's) or a case is not compared.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The float32 flash forward's cases: (heads, key heads, tokens, D, window).
FLASH_CASES = {"ragged D 64": (28, 4, 4100, 64, 1024),
               "ragged D 160": (32, 8, 4100, 160, 1024),
               "causal 28x4096x64": (28, 4, 4096, 64, 0),
               "causal 64x4096x160": (64, 16, 4096, 160, 0)}
FLASH_REPS, FLASH_TOL = 5, 2e-5


def differ(name: str, a, b) -> int:
    """Entries of ``a`` that differ from ``b``: any difference, or for
    the flash forward one beyond rtol = atol = FLASH_TOL."""
    import numpy as np
    if name.startswith("flash_fwd"):
        return int((np.abs(a - b) > FLASH_TOL * (1 + np.abs(b))).sum())
    return int((a != b).sum())


def worker(src: str, out: str, reps: int) -> None:
    """One turn: the cases on the ``repro_torch`` under ``src``; outputs
    to ``out``.npz, times to ``out``.json."""
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import numpy as np

    import chip_smoke as S
    from repro_torch.core import discretize
    from repro_torch.kernels.ans import kernel as K
    from repro_torch.kernels.bucketize import kernel as BK
    from repro_torch.kernels.flash import kernel as FK

    if not K.__file__.startswith(os.path.abspath(src)):
        raise SystemExit(f"compare_pops: imported {K.__file__}, not {src}")
    K.build()
    g = {k: v.cuda() for k, v in S.kernel_inputs().items()}
    e = discretize.edge_table(10, "cuda")
    narrow = S.grid_inputs(32, 392, 13, edges=False)
    n = 32
    dyn = (g["head"], g["tables"], g["feed_p"])
    dyn_n = (g["head"][:n].contiguous(), g["tables"][:, :n].contiguous(),
             g["feed_p"][:, :n].contiguous())
    grid = {
        f"gaussian {S.LANES}x40":
            (g["head"], g["mu"], g["sigma"], g["feed_s"], "gaussian"),
        f"gaussian {n}x392": (*narrow, "gaussian"),
        f"logistic {S.LANES}x40":
            (g["head"], g["mu_l"], g["scale"], g["feed_s"], "logistic")}
    for lanes, steps in ((32, 392), (1024, 40), (S.LANES, 40)):
        u = S.kernel_inputs(lanes + steps, lanes, steps)
        grid[f"uniform {lanes}x{steps}"] = (
            u["head"].cuda(), None, None, u["feed_s"].cuda(), "uniform")
    cases = {f"pop_grid_emit/{name}":
             (lambda a=a: K.pop_grid_emit(*a[:4], e, a[4], 10, 16),
              S.KERNEL_FN[f"pop_grid_emit/{name.split()[0]}"])
             for name, a in grid.items()}
    cases.update({f"pop_dyntable_emit {label}":
                  (lambda a=a: K.pop_dyntable_emit(*a, 16),
                   S.KERNEL_FN["pop_dyntable_emit"])
                  for label, a in ((f"{S.LANES}x784", dyn),
                                   (f"{n}x784", dyn_n))})
    table_fn = S.KERNEL_FN["pop_table_emit"]
    cases[f"pop_table_emit {S.LANES}x{S.TABLE_STEPS} (A+1 257)"] = (
        lambda: K.pop_table_emit(g["head"], g["table"], g["feed_t"], 16),
        table_fn)
    for a1, lanes in S.TABLE_CASES:
        t = (*S.table_pop_inputs(lanes, S.DYN_STEPS, a1, lanes + a1), 16)
        cases[f"pop_table_emit {lanes}x{S.DYN_STEPS} (A+1 {a1})"] = (
            lambda t=t: K.pop_table_emit(*t), table_fn)
    for lanes, lat_bits in ((256, 10), (S.LANES, 10), (S.LANES + 1, 12)):
        b = (*S.bucketize_inputs(lanes),
             discretize.edge_table(lat_bits, "cuda"), lat_bits, 16)
        cases[f"bucketize {lanes}, lat_bits {lat_bits}"] = (
            lambda b=b: BK.bucketize(*b), S.KERNEL_FN["bucketize"])
    for kind, shapes in (("gaussian", ((256, 1), (32, 392), (1024, 40),
                                       (512, 40), (1024, 784))),
                         ("logistic", ((S.LANES, 40),))):
        for lanes, steps in shapes:
            u = {k: v.cuda() for k, v in
                 S.kernel_inputs(lanes + steps, lanes, steps).items()}
            mu, sigma = (u["mu"], u["sigma"]) if kind == "gaussian" \
                else (u["mu_l"], u["scale"])
            cases[f"grid_starts/{kind} {lanes}x{steps}"] = (
                lambda a=(u["idx"], mu, sigma, e, 10, 16, kind):
                K.grid_starts(*a), S.KERNEL_FN[f"grid_starts/{kind}"])
    for label, (heads, kv, s, d, window) in FLASH_CASES.items():
        qkv = S.seeded_qkv(heads, kv, s, d,
                           np.random.default_rng(S.FLASH_F32_SEED))
        cases[f"flash_fwd/simt {label}"] = (
            lambda a=qkv, w=window: (FK.flash_fwd(*a, causal=True,
                                                  window=w),),
            S.KERNEL_FN["flash_fwd/simt"])
    times, arrays = {}, {}
    for name, (call, fn) in cases.items():
        for i, t in enumerate(call()):
            arrays[f"{name}/{i}"] = t.cpu().numpy()
        n = FLASH_REPS if name.startswith("flash_fwd") else reps
        ms, ms_by = S.device_ms(call, fn, n)
        times[name] = {"ms": ms, "ms_by": ms_by,
                       "call_ms": S.cuda_ms(call, n)}
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(times, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "OUT"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(*a.worker, a.reps)
        return 0
    import numpy as np

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    turns = [("other", a.other), ("this", ROOT), ("this", ROOT),
             ("other", a.other)]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        res = []
        for i, (who, root) in enumerate(turns):
            out = os.path.join(d, f"turn{i}")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            a.other, "--reps", str(a.reps), "--worker",
                            os.path.abspath(os.path.join(root, "src")),
                            out], check=True)
            with open(out + ".json") as f:
                times = json.load(f)
            with np.load(out + ".npz") as z:
                arrays = {k: z[k] for k in z.files}
            res.append((who, times, arrays))
    bad = untraced = 0
    summary = {}
    for name in res[0][1]:
        t = [r[1][name]["ms"] for r in res]
        by = [r[1][name]["ms_by"] for r in res]
        c = [r[1][name]["call_ms"] for r in res]
        diff = sum(differ(name, r[2][k], res[0][2][k])
                   for r in res[1:] for k in res[0][2]
                   if k.startswith(name + "/"))
        bad += diff
        # A time by CUDA events (a turn whose traces lost the launches)
        # holds host work: it is kept, but compared with nothing.
        traced = all(b == "trace" for b in by)
        untraced += not traced
        other, this = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        ratio = this / other if traced else None
        summary[name] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                         "other_ms_by": [by[0], by[3]],
                         "this_ms_by": [by[1], by[2]],
                         "other_call_ms": [c[0], c[3]],
                         "this_call_ms": [c[1], c[2]],
                         "this_over_other": ratio, "mismatches": diff}
        verdict = f"this / other {ratio:.3f}" if traced else \
            "not compared: a turn's time is by CUDA events (" + \
            "/".join(by) + ")"
        print(f"{name}: mismatches {diff}; device ms a launch: other "
              f"{t[0]:.5f}/{t[3]:.5f}, this {t[1]:.5f}/{t[2]:.5f}, "
              f"{verdict}; per call (host + device): other "
              f"{c[0]:.4f}/{c[3]:.4f}, this {c[1]:.4f}/{c[2]:.4f}",
              flush=True)
    print(json.dumps({"card": smi, "cases": summary}))
    return 1 if bad or untraced else 0


if __name__ == "__main__":
    sys.exit(main())
