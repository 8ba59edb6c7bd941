"""The port's static-table pop and slot peek against the reference's.

On the CPU: ``twin.pop_table_emit`` / ``twin.pop_slots`` against
``repro.kernels.ans.xla`` and the Pallas kernels (``kernel.py:92,120``) in
interpret mode, word for word, over random cumulative tables with
zero-frequency symbols; and the dispatched ``push_many_table`` /
``pop_many`` / ``pop_slots`` against ``repro.kernels.ans.ops`` on whole
stacks, past the bottom of the stack. The CUDA kernels are held to the
twins on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import container as ref_container  # noqa: E402
from repro.kernels.ans import kernel as ref_kernel  # noqa: E402
from repro.kernels.ans import ops as ref_ops  # noqa: E402
from repro.kernels.ans import xla as ref_xla  # noqa: E402
from repro_torch.codecs import container  # noqa: E402
from repro_torch.kernels.ans import ops, ref, twin  # noqa: E402


def table_inputs(lanes, a1, steps, precision=16, seed=0):
    """head u32[L]; a non-decreasing table [L, A+1] from 0 to 2^p whose
    symbols have random frequencies, about a third of them zero; feed
    [S, L]; symbols [S, L] of non-zero frequency."""
    rng = np.random.default_rng(seed + 7 * lanes + a1 + 1000 * steps)
    total = 1 << precision
    a = a1 - 1
    w = rng.integers(1, 100, (lanes, a)) * (rng.random((lanes, a)) > 0.35)
    w[:, rng.integers(0, a)] += 1        # at least one coded symbol
    cdf = np.floor(np.cumsum(w, axis=1) / w.sum(1, keepdims=True) * total)
    table = np.concatenate([np.zeros((lanes, 1)), cdf], 1).astype(np.int64)
    table[:, -1] = total
    freqs = np.diff(table, axis=1)
    syms = np.stack([rng.choice(np.nonzero(f)[0], steps) for f in freqs], 1)
    return {
        "head": rng.integers(1 << 16, 1 << 32, lanes, dtype=np.uint64)
        .astype(np.uint32),
        "table": table.astype(np.uint32),
        "feed": rng.integers(0, 1 << 16, (steps, lanes)).astype(np.uint32),
        "syms": syms.astype(np.int32),
    }


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def _words(x):
    """uint32 words of an array (int32 -1 and uint32 0xFFFFFFFF alike)."""
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


CASES = [(1, 3, 1), (3, 13, 8), (130, 257, 64), (128, 13, 64), (7, 257, 33)]


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("lanes,a1,steps", CASES)
def test_pop_table_emit_matches_reference(lanes, a1, steps, interpret):
    d = table_inputs(lanes, a1, steps)
    args = (jnp.asarray(d["head"]), jnp.asarray(d["table"]),
            jnp.asarray(d["feed"]), 16)
    want = ref_kernel.pop_table_emit(*args, interpret=True, lane_tile=lanes) \
        if interpret else ref_xla.pop_table_emit(*args)
    got = twin.pop_table_emit(_t(d["head"]), _t(d["table"]), _t(d["feed"]),
                              16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(g), _words(w))


def test_pop_table_emit_on_zero_rows_and_equal_starts():
    """Padded lanes (all-zero rows, head 2^16) and runs of equal starts:
    the branchless search picks the last of equal entries."""
    table = np.array([[0, 0, 0, 0], [0, 0, 40000, 65536],
                      [0, 30000, 30000, 65536]], np.uint32)
    head = np.array([1 << 16, (7 << 16) | 12345, (9 << 16) | 30000],
                    np.uint32)
    feed = np.arange(12, dtype=np.uint32).reshape(4, 3) + 100
    want = ref_xla.pop_table_emit(jnp.asarray(head), jnp.asarray(table),
                                  jnp.asarray(feed), 16)
    got = twin.pop_table_emit(_t(head), _t(table), _t(feed), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(g), _words(w))
    assert got[1][0, 1] == 1 and got[1][0, 2] == 2


@pytest.mark.parametrize("precision", [8, 12, 16])
@pytest.mark.parametrize("lanes", [1, 130])
def test_pop_slots_matches_reference(lanes, precision):
    head = np.random.default_rng(lanes).integers(
        1 << 16, 1 << 32, lanes, dtype=np.uint64).astype(np.uint32)
    want = ref_kernel.pop_slots(jnp.asarray(head), precision,
                                interpret=True, lane_tile=lanes)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(
        ref_xla.pop_slots(jnp.asarray(head), precision)))
    got = twin.pop_slots(_t(head), precision)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_words(got), _words(want))


def _stacks(lanes, chunks, capacity=160, seed=5):
    with jax.threefry_partitionable(False):
        r = ref_container.fresh_stack(lanes, capacity, seed=seed,
                                      init_chunks=chunks)
    return container.fresh_stack(lanes, capacity, seed=seed,
                                 init_chunks=chunks, device="cpu"), r


def _same_stack(port, r):
    for f in ("head", "buf", "ptr", "underflows", "overflows"):
        np.testing.assert_array_equal(
            getattr(port, f).numpy().astype(np.int64),
            np.asarray(getattr(r, f)).astype(np.int64), err_msg=f)


@pytest.mark.parametrize("backend", ["torch", "ref"])
@pytest.mark.parametrize("lanes,a1,steps", [(3, 13, 8), (130, 257, 64)])
def test_table_ops_match_reference_ops(lanes, a1, steps, backend):
    """push_many_table then pop_many, twice over, on one stack: the same
    stack, word for word, and the same symbols as the reference's ops.
    The pops take more than was pushed, so the second round reads past
    the clean bits and the bottom of the stack (underflows counted)."""
    d = table_inputs(lanes, a1, steps, seed=3)
    port, r = _stacks(lanes, chunks=4)
    table = jnp.asarray(d["table"])
    for _ in range(2):
        r = ref_ops.push_many_table(r, table, jnp.asarray(d["syms"]), 16,
                                    backend="xla")
        port = ops.push_many_table(port, _t(d["table"]), _t(d["syms"]), 16,
                                   backend=backend)
        _same_stack(port, r)
        r, rs = ref_ops.pop_many(r, table, 3 * steps, 16, backend="xla")
        port, ps = ops.pop_many(port, _t(d["table"]), 3 * steps, 16,
                                backend=backend)
        _same_stack(port, r)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    assert int(port.underflows.sum()) > 0
    np.testing.assert_array_equal(
        ops.pop_slots(port, 16, backend=backend).numpy(),
        np.asarray(ref_xla.pop_slots(r.head, 16)).astype(np.int32))


def test_table_pops_invert_table_pushes():
    lanes, a1, steps = 5, 257, 40
    d = table_inputs(lanes, a1, steps, seed=9)
    port, _ = _stacks(lanes, chunks=0)
    table = _t(d["table"])
    pushed = ops.push_many_table(port, table, _t(d["syms"]), 16)
    popped, syms = ops.pop_many(pushed, table, steps, 16)
    np.testing.assert_array_equal(syms.numpy(), d["syms"][::-1])
    assert int(popped.underflows.sum()) == 0 and int(popped.ptr.sum()) == 0


def test_ref_oracle_matches_twin_table_ops():
    d = table_inputs(9, 13, 12, seed=4)
    a, _ = _stacks(9, chunks=8)
    b, _ = _stacks(9, chunks=8)
    a = ref.push_many_table_ref(a, _t(d["table"]), _t(d["syms"]), 16)
    b = ops.push_many_table(b, _t(d["table"]), _t(d["syms"]), 16,
                            backend="torch")
    a, sa = ref.pop_many_ref(a, _t(d["table"]), 30, 16)
    b, sb = ops.pop_many(b, _t(d["table"]), 30, 16, backend="torch")
    assert torch.equal(sa, sb)
    for f in ("head", "buf", "ptr", "underflows", "overflows"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
