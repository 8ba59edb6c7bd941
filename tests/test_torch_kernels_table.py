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


# (lanes, A+1, steps): the table pop kernel's width bands (``csrc/
# pop_table.cu``: the window alone at 3 and 13 - groups of 8 and 16 -,
# top round and window at 257, a probe round between at 4097, a staged
# sample above it at 4500), step counts off its 32-step tiles.
CASES = [(1, 3, 1), (3, 13, 8), (130, 257, 64), (128, 13, 64), (7, 257, 33),
         (130, 3, 70), (1, 13, 33), (3, 257, 70), (3, 4097, 33),
         (1, 4500, 33)]


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
    # the kernel's group walk, at every group width, on the same rows
    for group in (8, 16, 32):
        walked = walk_pop_emit(_t(head), _t(table), _t(feed), 16, group)
        for g, w in zip(walked, want):
            np.testing.assert_array_equal(_words(g), _words(w))


def walk_pop_emit(head, table, feed, precision, group):
    """``twin.pop_table_emit`` with its search done as the kernel walks it
    (``twin.table_group_walk``)."""
    h = head.to(torch.int64)
    r = torch.zeros_like(h)
    syms = torch.zeros(feed.shape, dtype=torch.int32)
    for t in range(feed.shape[0]):
        slot = h & ((1 << precision) - 1)
        c, start, nxt = twin.table_group_walk(table, slot, precision, group)
        syms[t] = (c - 1).to(torch.int32)
        h = ((nxt - start) * (h >> precision) + slot - start) & 0xFFFFFFFF
        h, r = twin._read(h, r, feed)
    return h, syms, r.to(torch.int32)


@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("lanes,a1,steps,group", [
    (1, 3, 33, 8), (130, 13, 70, 16), (3, 257, 70, 32), (130, 257, 33, 32),
    (3, 257, 70, 8), (3, 4097, 33, 32), (1, 4500, 33, 32)])
def test_table_group_walk_pops_match_reference(lanes, a1, steps, group,
                                               precision):
    """Pops through the kernel's group walk, at each round plan its
    launcher takes (the window alone in groups of 8 and 16; top round and
    window in 32; top, probe and window in 8 and in 32; a sampled row),
    and the twin's, against the Pallas kernel in interpret mode, word for
    word, the first slots at 0 and 2^p - 1 among random ones; at
    precision 12 the widest rows repeat most starts (zero-frequency
    symbols)."""
    d = table_inputs(lanes, a1, steps, precision)
    mask = np.uint32((1 << precision) - 1)
    d["head"][0::3] &= ~mask
    d["head"][1::3] |= mask
    want = ref_kernel.pop_table_emit(
        jnp.asarray(d["head"]), jnp.asarray(d["table"]),
        jnp.asarray(d["feed"]), precision, interpret=True, lane_tile=lanes)
    args = (_t(d["head"]), _t(d["table"]), _t(d["feed"]), precision)
    for got in (walk_pop_emit(*args, group), twin.pop_table_emit(*args)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_words(g), _words(w))


@pytest.mark.parametrize("a1,group", [
    (3, 8), (3, 32), (13, 16), (13, 32), (40, 8), (257, 8), (448, 8),
    (257, 16),
    (257, 32), (3840, 16), (4097, 32), (4500, 32), (15872, 32),
    (1 << 16, 32)])
def test_table_group_walk_finds_the_branchless_search(a1, group):
    """Each round plan of the walk (the window alone; top round and
    window; top, probe and window; a sampled row above 4097 entries), at
    group widths the kernel uses and others, gives the reference's count,
    start and next on slots 0 and 2^16 - 1, slots on the row's entries and
    random ones, over random rows with zero-frequency symbols and an
    all-zero row."""
    d = table_inputs(4, a1, 1)
    table = _t(d["table"])
    table[3] = 0
    rng = np.random.default_rng(a1 + group)
    slots = [np.zeros(4, np.int64), np.full(4, (1 << 16) - 1),
             rng.integers(0, 1 << 16, 4)]
    slots += [np.minimum(table[np.arange(4), rng.integers(0, a1, 4)]
                         .numpy(), (1 << 16) - 1) for _ in range(6)]
    for slot in map(torch.from_numpy, slots):
        le = table <= slot[:, None]
        c, start, nxt = twin.table_group_walk(table, slot, 16, group)
        assert torch.equal(c, le.sum(1))
        assert torch.equal(start, torch.where(le, table, 0).amax(1))
        assert torch.equal(nxt, torch.where(le, 1 << 16, table).amin(1))


def test_table_group_walk_refuses_walks_past_its_rounds():
    """Rows that three rounds of 16 cannot walk, and sampled rows in a
    group too narrow for a block of the sample and the entry after."""
    with pytest.raises(ValueError, match="at most 3840 entries"):
        twin.table_group_walk(torch.zeros((1, 3841), dtype=torch.int64),
                              torch.zeros(1, dtype=torch.int64), 16, 16)
    with pytest.raises(ValueError, match="more than 16 threads"):
        twin.table_group_walk(torch.zeros((1, 4500), dtype=torch.int64),
                              torch.zeros(1, dtype=torch.int64), 16, 16)


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
