"""The port's ANS kernels against the reference's.

On the CPU: ``twin.py`` and the ``ref.py`` oracle against
``repro.kernels.ans.xla`` and the Pallas kernels in interpret mode, at
lanes 1, 3, 128 and 130 and precisions 12 and 16; the dispatched ops
against ``repro.kernels.ans.ops``; the push kernel's division by
reciprocal (``twin.divmod_by_reciprocal``) against ``//`` and ``%`` over
every freq of precision 16 at the heads' edges and on a million random
pairs. The CUDA kernels themselves are held to ``twin.py`` on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import container as ref_container  # noqa: E402
from repro.kernels import dispatch as ref_dispatch  # noqa: E402
from repro.kernels.ans import kernel as ref_kernel  # noqa: E402
from repro.kernels.ans import ops as ref_ops  # noqa: E402
from repro.kernels.ans import xla as ref_xla  # noqa: E402
from repro.kernels.bucketize import kernel as ref_bucketize  # noqa: E402
from repro_torch.codecs import container  # noqa: E402
from repro_torch.core import discretize  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ans import ops, ref, twin  # noqa: E402

LANES = [1, 3, 128, 130]
PRECISIONS = [12, 16]
STEPS = 6


def _lat_bits(precision):
    return 10 if precision == 16 else 8


def _inputs(lanes, precision, seed=0):
    rng = np.random.default_rng(seed + lanes * 31 + precision)
    total = 1 << precision
    f1 = rng.integers(1, total - 1, (STEPS, lanes))
    sym = rng.integers(0, 2, (STEPS, lanes))
    f0 = total - f1
    return {
        "head": rng.integers(1 << 16, 1 << 32, lanes, dtype=np.uint64)
        .astype(np.uint32),
        "starts": np.where(sym == 1, f0, 0).astype(np.uint32),
        "freqs": np.where(sym == 1, f1, f0).astype(np.uint32),
        "tables": np.stack([np.zeros_like(f1), f0, np.full_like(f1, total)],
                           -1).astype(np.uint32),
        "feed": rng.integers(0, 1 << 16, (STEPS, lanes)).astype(np.uint32),
        "mu": rng.normal(0.0, 1.5, (STEPS, lanes)).astype(np.float32),
        "sigma": np.exp(rng.uniform(-4.0, 1.0, (STEPS, lanes)))
        .astype(np.float32),
        "idx": rng.integers(0, 1 << _lat_bits(precision), (STEPS, lanes))
        .astype(np.int32),
    }


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def _same(port_out, ref_out):
    for p, r in zip(port_out, ref_out):
        np.testing.assert_array_equal(p.numpy().astype(np.int64),
                                      np.asarray(r).astype(np.int64))


def _ref_grid(d, kind, precision, interpret):
    lb = _lat_bits(precision)
    edges = ref_bucketize.edge_table(lb) if kind == "gaussian" \
        else jnp.zeros((2,), jnp.float32)
    args = (jnp.asarray(d["head"]), jnp.asarray(d["mu"]),
            jnp.asarray(d["sigma"]), jnp.asarray(d["feed"]), edges, kind, lb,
            precision)
    if interpret:
        return ref_kernel.pop_grid_emit(*args, interpret=True,
                                        lane_tile=len(d["head"]))
    return ref_xla.pop_grid_emit(*args)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("lanes", LANES)
def test_push_emit_matches_reference(lanes, precision, interpret):
    d = _inputs(lanes, precision)
    args = (jnp.asarray(d["head"]), jnp.asarray(d["starts"]),
            jnp.asarray(d["freqs"]), precision)
    want = ref_kernel.push_emit(*args, interpret=True, lane_tile=lanes) \
        if interpret else ref_xla.push_emit(*args)
    _same(twin.push_emit(_t(d["head"]), _t(d["starts"]), _t(d["freqs"]),
                         precision), want)


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("lanes", LANES)
def test_pop_dyntable_emit_matches_reference(lanes, precision, interpret):
    d = _inputs(lanes, precision)
    args = (jnp.asarray(d["head"]), jnp.asarray(d["tables"]),
            jnp.asarray(d["feed"]), precision)
    want = ref_kernel.pop_dyntable_emit(*args, interpret=True,
                                        lane_tile=lanes) \
        if interpret else ref_xla.pop_dyntable_emit(*args)
    _same(twin.pop_dyntable_emit(_t(d["head"]), _t(d["tables"]),
                                 _t(d["feed"]), precision), want)


@pytest.mark.parametrize("kind", ["gaussian", "uniform"])
@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("lanes", LANES)
def test_pop_grid_emit_matches_reference(lanes, precision, interpret, kind):
    d = _inputs(lanes, precision)
    lb = _lat_bits(precision)
    got = twin.pop_grid_emit(_t(d["head"]), _t(d["mu"]), _t(d["sigma"]),
                             _t(d["feed"]), discretize.edge_table(lb, "cpu"),
                             kind, lb, precision)
    _same(got, _ref_grid(d, kind, precision, interpret))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("lanes", LANES)
def test_grid_starts_match_reference_cdf(lanes, precision):
    """The push-side starts of both CDF kinds at random indices and at
    the pinned ends 0, 1, K - 1 and K (where F(K + 1) reads past the edge
    table, clamped), exactly as the reference's grid chain."""
    d = _inputs(lanes, precision)
    lb = _lat_bits(precision)
    k = 1 << lb
    idx_np = d["idx"].copy()
    idx_np[:4] = np.array([0, 1, k - 1, k], np.int32)[:, None]
    for kind in ("gaussian", "logistic"):
        f = jax.jit(lambda m, s, i: ref_xla._grid_starts_fn(
            m, s, ref_bucketize.edge_table(lb), kind, lb, precision)(i))
        mu, sg, idx = (jnp.asarray(a) for a in (d["mu"], d["sigma"], idx_np))
        start = np.asarray(f(mu, sg, idx)).astype(np.int64)
        freq = np.asarray(f(mu, sg, idx + 1)).astype(np.int64) - start
        got = twin.grid_starts(_t(idx_np), _t(d["mu"]), _t(d["sigma"]),
                               discretize.edge_table(lb, "cpu"), lb,
                               precision, kind)
        np.testing.assert_array_equal(got[0].numpy(), start, err_msg=kind)
        np.testing.assert_array_equal(got[1].numpy(), freq, err_msg=kind)


def _stacks(lanes, seed=5, chunks=40):
    with jax.threefry_partitionable(False):
        r = ref_container.fresh_stack(lanes, 96, seed=seed,
                                      init_chunks=chunks)
    return container.fresh_stack(lanes, 96, seed=seed, init_chunks=chunks,
                                 device="cpu"), r


def _same_stack(port, r):
    for f in ("head", "buf", "ptr", "underflows", "overflows"):
        np.testing.assert_array_equal(
            getattr(port, f).numpy().astype(np.int64),
            np.asarray(getattr(r, f)).astype(np.int64), err_msg=f)


@pytest.mark.parametrize("backend", ["torch", "ref"])
@pytest.mark.parametrize("lanes", LANES)
def test_ops_match_reference_ops(lanes, backend):
    """push_many, pop_many_dyn, pop_many_grid on whole stacks, chained:
    the same stack and symbols as ``repro.kernels.ans.ops`` (xla)."""
    d = _inputs(lanes, 16, seed=1)
    port, r = _stacks(lanes)
    for _ in range(2):     # the second round runs past the clean bits
        r = ref_ops.push_many(r, jnp.asarray(d["starts"]),
                              jnp.asarray(d["freqs"]), 16, backend="xla")
        port = ops.push_many(port, _t(d["starts"]), _t(d["freqs"]), 16,
                             backend=backend)
        _same_stack(port, r)
        r, rs = ref_ops.pop_many_grid(r, "gaussian", jnp.asarray(d["mu"]),
                                      jnp.asarray(d["sigma"]), STEPS, 10, 16,
                                      backend="xla")
        port, ps = ops.pop_many_grid(port, "gaussian", _t(d["mu"]),
                                     _t(d["sigma"]), STEPS, 10, 16,
                                     backend=backend)
        _same_stack(port, r)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        r, rs = ref_ops.pop_many_dyn(r, jnp.asarray(d["tables"]), 16,
                                     backend="xla")
        port, ps = ops.pop_many_dyn(port, _t(d["tables"]), 16,
                                    backend=backend)
        _same_stack(port, r)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        r, rs = ref_ops.pop_many_grid(r, "uniform", jnp.zeros(()),
                                      jnp.zeros(()), STEPS, 10, 16,
                                      backend="xla")
        port, ps = ops.pop_many_grid(port, "uniform", None, None, STEPS, 10,
                                     16, backend=backend)
        _same_stack(port, r)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))


def test_push_many_counts_overflow_like_the_reference():
    lanes = 3
    d = _inputs(lanes, 16, seed=2)
    with jax.threefry_partitionable(False):
        r = ref_container.fresh_stack(lanes, 2, seed=0)
    port = container.fresh_stack(lanes, 2, seed=0, device="cpu")
    for _ in range(4):
        r = ref_ops.push_many(r, jnp.asarray(d["starts"]),
                              jnp.asarray(d["freqs"]), 16, backend="xla")
        port = ops.push_many(port, _t(d["starts"]), _t(d["freqs"]), 16)
        _same_stack(port, r)
    assert int(port.overflows.sum()) > 0


def test_ref_oracle_matches_twin_ops():
    d = _inputs(128, 16, seed=3)
    a, _ = _stacks(128, seed=1)
    b, _ = _stacks(128, seed=1)
    a = ref.push_many_ref(a, _t(d["starts"]), _t(d["freqs"]), 16)
    b = ops.push_many(b, _t(d["starts"]), _t(d["freqs"]), 16,
                      backend="torch")
    a, sa = ref.pop_many_grid_ref(a, "gaussian", _t(d["mu"]),
                                  _t(d["sigma"]), STEPS, 10, 16)
    b, sb = ops.pop_many_grid(b, "gaussian", _t(d["mu"]), _t(d["sigma"]),
                              STEPS, 10, 16, backend="torch")
    assert torch.equal(sa, sb)
    for f in ("head", "buf", "ptr", "underflows"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_dispatch_precedence_and_refusals(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND", raising=False)
    assert dispatch.resolve("push_many", cpu) == "torch"
    with dispatch.use_backend("ref"):
        assert dispatch.resolve("push_many", cpu) == "ref"
        assert dispatch.resolve("push_many", cpu, "torch") == "torch"
        monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "torch")
        assert dispatch.resolve("push_many", cpu) == "torch"
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND")
    with pytest.raises(RuntimeError, match="cuda backend"):
        dispatch.resolve("push_many", cpu, "cuda")
    with pytest.raises(RuntimeError, match="only the kernel runs"):
        dispatch.resolve("push_many", torch.device("cuda"), "torch")
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.resolve("push_many", cpu, "xla")
    twin.check_kind("logistic")     # ported: no refusal
    with pytest.raises(ValueError, match="unknown grid kind"):
        twin.check_kind("laplace")


def test_each_package_reads_only_its_own_backend_variable(monkeypatch):
    """Both packages in one process: the port's variable does not steer
    the reference, and the reference's (whose values the port does not
    know) does not steer - or break - the port."""
    cpu = torch.device("cpu")
    d = _inputs(3, 16)
    monkeypatch.delenv("REPRO_KERNEL_BACKEND", raising=False)
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "ref")
    with ref_dispatch.use_backend("interpret"):
        assert ref_dispatch.resolve("push_many").backend == "interpret"
    assert dispatch.resolve("push_many", cpu) == "ref"
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND")
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "xla")
    assert ref_dispatch.resolve("push_many").backend == "xla"
    assert dispatch.resolve("push_many", cpu) == "torch"
    with dispatch.use_backend("ref"):
        assert dispatch.resolve("push_many", cpu) == "ref"
    port, r = _stacks(3)
    r = ref_ops.push_many(r, jnp.asarray(d["starts"]),
                          jnp.asarray(d["freqs"]), 16)
    port = ops.push_many(port, _t(d["starts"]), _t(d["freqs"]), 16)
    _same_stack(port, r)


def _divmod_edges(freq):
    """Heads at the edges for each freq: 0, freq - 1, freq, the largest
    head that reaches the division without renormalizing at precision 16
    (freq << 16, wrapped, minus 1) and 2^32 - 1."""
    m32 = np.uint64(0xFFFFFFFF)
    below = ((freq << np.uint64(16)) - np.uint64(1)) & m32
    return [np.zeros_like(freq), freq - np.uint64(1), freq, below,
            np.full_like(freq, m32)]


@pytest.mark.parametrize("edge", range(5))
def test_push_reciprocal_divmod_is_exact_for_every_freq(edge):
    freq = np.arange(1, (1 << 16) + 1, dtype=np.uint64)
    x = _divmod_edges(freq)[edge]
    q, r = twin.divmod_by_reciprocal(x, freq)
    np.testing.assert_array_equal(q, x // freq)
    np.testing.assert_array_equal(r, x % freq)


def test_push_reciprocal_divmod_is_exact_on_random_pairs():
    rng = np.random.default_rng(19)
    x = rng.integers(0, 1 << 32, 10 ** 6, dtype=np.uint64)
    freq = rng.integers(1, (1 << 16) + 1, 10 ** 6, dtype=np.uint64)
    q, r = twin.divmod_by_reciprocal(x, freq)
    np.testing.assert_array_equal(q, x // freq)
    np.testing.assert_array_equal(r, x % freq)


def test_push_reciprocal_is_the_ceiling_of_two_to_the_64_over_freq():
    freq = np.array([1, 2, 3, 255, 4096, 65521, 65535, 65536], np.uint64)
    want = [0] + [-(-(1 << 64) // int(f)) for f in freq[1:]]
    assert [int(m) for m in twin.push_reciprocal(freq)] == want


def _walk_case(bits, fkind, seed):
    """(f, slot) for the group tree walk: per-lane F over 0 .. K + 1 as a
    table - ``monotone`` (cumulative random frequencies, F(K) = 2^16),
    ``non-monotone`` (random words) or ``ndtr`` (the grid's own F at
    random mu, sigma) - and slots at 0, 2^16 - 1, on F's values and one
    below them, and random."""
    lanes, k = 48, 1 << bits
    rng = np.random.default_rng(seed)
    if fkind == "ndtr":
        mu = torch.from_numpy(rng.uniform(-8, 8, lanes).astype(np.float32))
        sigma = torch.from_numpy(np.exp(rng.uniform(
            np.log(1e-3), np.log(30.0), lanes)).astype(np.float32))
        table = discretize.posterior_starts_fn(
            mu[:, None], sigma[:, None], bits, 16)(
                torch.arange(k + 2)[None, :]).to(torch.int64)
    elif fkind == "monotone":
        w = rng.integers(1, 50, (lanes, k))
        cdf = np.concatenate([np.zeros((lanes, 1)), np.cumsum(w, 1)], 1)
        f = np.floor(cdf / cdf[:, -1:] * ((1 << 16) - k)) + np.arange(k + 1)
        table = torch.from_numpy(np.concatenate(
            [f, np.full((lanes, 1), (1 << 16) + 1)], 1).astype(np.int64))
    else:
        table = torch.from_numpy(rng.integers(0, 1 << 16, (lanes, k + 2)))
    slot = rng.integers(0, 1 << 16, lanes)
    pick = rng.integers(0, k + 1, lanes)
    on_f = table.numpy()[np.arange(lanes), pick]
    slot[:2] = (0, (1 << 16) - 1)
    slot[2:18] = on_f[2:18]
    slot[18:34] = np.maximum(on_f[18:34] - 1, 0)
    slot = torch.from_numpy(np.minimum(slot, (1 << 16) - 1))

    def f(i):
        return table.gather(1, i[:, None])[:, 0] if i.dim() == 1 \
            else table.gather(1, i)
    return f, slot


@pytest.mark.parametrize("fkind", ["monotone", "non-monotone", "ndtr"])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("bits", range(1, 13))
def test_grid_tree_walk_matches_the_bisection(bits, group, fkind):
    """The grid pop kernel's group walk (``twin.grid_tree_walk``, round
    for round as ``csrc/pop_grid.cu`` walks it) returns the bisection's
    index and F at its two ends for any F, monotone or not."""
    f, slot = _walk_case(bits, fkind, 100 * bits + group)
    want = discretize.bisect(f, slot, bits)
    idx, start, nxt = twin.grid_tree_walk(f, slot, bits, group)
    assert torch.equal(idx, want)
    assert torch.equal(start, f(want)) and torch.equal(nxt, f(want + 1))
