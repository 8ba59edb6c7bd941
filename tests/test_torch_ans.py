"""The port's ANS coder and threefry against the JAX reference, word for
word (``repro_torch.core.ans`` / ``core.prng`` vs ``repro.core.ans`` /
``jax.random`` in the non-partitionable mode the golden blobs use)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import container as ref_container  # noqa: E402
from repro.core import ans as ref_ans  # noqa: E402
from repro_torch.codecs import container  # noqa: E402
from repro_torch.core import ans, prng  # noqa: E402


def _words(stack):
    """(head, buf, ptr, underflows, overflows) of either package, int64."""
    return tuple(np.asarray(getattr(stack, f)).astype(np.int64)
                 for f in ("head", "buf", "ptr", "underflows", "overflows"))


def assert_same_stack(port, ref):
    for name, a, b in zip(("head", "buf", "ptr", "underflows", "overflows"),
                          _words(port), _words(ref)):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", range(50))
def test_threefry_and_fresh_stack_match_jax(seed):
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(key))
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), 3),
                                      np.asarray(jax.random.split(key, 3)))
        k = jax.random.split(key)[1]
        want = jax.random.randint(k, (5, 7), 0, 1 << 16, dtype=jnp.int32)
        got = prng.randint(np.asarray(k), (5, 7), 0, 1 << 16)
        np.testing.assert_array_equal(got, np.asarray(want))
        lanes = 1 + seed % 9
        ref = ref_container.fresh_stack(lanes, 40, seed=seed,
                                        init_chunks=seed % 33)
    port = container.fresh_stack(lanes, 40, seed=seed,
                                 init_chunks=seed % 33, device="cpu")
    assert_same_stack(port, ref)


@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_random_push_pop_sequences_match_reference(lanes, precision):
    rng = np.random.default_rng(lanes * 100 + precision)
    cap = 24     # small: the sequence runs into overflow and underflow
    with jax.threefry_partitionable(False):
        ref = ref_container.fresh_stack(lanes, cap, seed=3, init_chunks=4)
    port = container.fresh_stack(lanes, cap, seed=3, init_chunks=4,
                                 device="cpu")
    total = 1 << precision
    for _ in range(120):
        freq = rng.integers(1, total // 2, lanes)
        start = rng.integers(0, total - freq + 1)
        if rng.random() < 0.55:
            ref = ref_ans.push(ref, jnp.asarray(start, jnp.uint32),
                               jnp.asarray(freq, jnp.uint32), precision)
            port = ans.push(port, torch.from_numpy(start),
                            torch.from_numpy(freq), precision)
        else:
            slot = np.asarray(ref_ans.peek(ref, precision)).astype(np.int64)
            np.testing.assert_array_equal(
                ans.peek(port, precision).numpy(), slot)
            # a (start, freq) pair that contains the slot
            start = np.minimum(slot, rng.integers(0, total, lanes))
            freq = np.maximum(slot - start + 1,
                              rng.integers(1, total // 2, lanes))
            freq = np.minimum(freq, total - start)
            ref = ref_ans.pop_update(ref, jnp.asarray(start, jnp.uint32),
                                     jnp.asarray(freq, jnp.uint32),
                                     precision)
            port = ans.pop_update(port, torch.from_numpy(start),
                                  torch.from_numpy(freq), precision)
        assert_same_stack(port, ref)


@pytest.mark.parametrize("precision", [8, 16])
def test_table_push_pop_match_reference(precision):
    rng = np.random.default_rng(precision)
    lanes, a = 5, 7
    probs = rng.random((lanes, a)).astype(np.float32) + 0.01
    ref_table = ref_ans.probs_to_starts(jnp.asarray(probs), precision)
    table = ans.probs_to_starts(torch.from_numpy(probs), precision)
    np.testing.assert_array_equal(table.numpy(), np.asarray(ref_table))
    with jax.threefry_partitionable(False):
        ref = ref_container.fresh_stack(lanes, 64, seed=1)
    port = container.fresh_stack(lanes, 64, seed=1, device="cpu")
    syms = rng.integers(0, a, (20, lanes))
    for s in syms:
        ref = ref_ans.push_with_table(ref, ref_table, jnp.asarray(s),
                                      precision)
        port = ans.push_with_table(port, table, torch.from_numpy(s),
                                   precision)
        assert_same_stack(port, ref)
    for s in syms[::-1]:
        ref, rs = ref_ans.pop_with_table(ref, ref_table, precision)
        port, ps = ans.pop_with_table(port, table, precision)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(ps.numpy(), s)
        assert_same_stack(port, ref)


def test_flatten_unflatten_and_bits_match_reference():
    with jax.threefry_partitionable(False):
        ref = ref_container.fresh_stack(6, 30, seed=9, init_chunks=11)
    port = container.fresh_stack(6, 30, seed=9, init_chunks=11, device="cpu")
    rmsg, rlen = ref_ans.flatten(ref)
    msg, lengths = ans.flatten(port)
    np.testing.assert_array_equal(msg.numpy(), np.asarray(rmsg))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(rlen))
    back = ans.unflatten(msg, lengths)
    assert_same_stack(back, ref_ans.unflatten(rmsg, rlen))
    assert ans.stack_bits(port) == int(ref_ans.stack_bits(ref))
    assert ans.stack_content_bits(port) == pytest.approx(
        float(ref_ans.stack_content_bits(ref)), rel=1e-6)


def test_check_clean_raises_on_underflow_and_overflow():
    stack = ans.make_stack(2, 1, device="cpu")
    ans.check_clean(stack)
    under = ans.pop_update(stack, torch.zeros(2, dtype=torch.int64),
                           torch.full((2,), 1 << 15, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="underflow"):
        ans.check_clean(under)
    over = stack
    for _ in range(4):
        over = ans.push(over, torch.zeros(2, dtype=torch.int64),
                        torch.ones(2, dtype=torch.int64))
    with pytest.raises(RuntimeError, match="overflow"):
        ans.check_clean(over)


def test_cdf_to_starts_matches_reference():
    cdf = np.array([[0.0, 0.1, 0.35, 0.9, 1.0],
                    [0.0, 0.5, 0.5, 0.75, 1.0]], np.float32)
    for p in (8, 16):
        np.testing.assert_array_equal(
            ans.cdf_to_starts(torch.from_numpy(cdf), p).numpy(),
            np.asarray(ref_ans.cdf_to_starts(jnp.asarray(cdf), p)))
    with pytest.raises(ValueError):
        ans.cdf_to_starts(torch.tensor([[0.0, 1.0]]), 16)
    with pytest.raises(ValueError):
        ans.check_precision(17)


@pytest.mark.parametrize("n", [5, 16, 18, 300])
def test_cumsum_order_matches_xla(n):
    rng = np.random.default_rng(n)
    x = (rng.random((40, n)) * 10.0 ** rng.uniform(-3, 3, (40, n))) \
        .astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    got = ans.cumsum_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_leaves_and_combinators_write_the_reference_wire():
    """Serial over PointwiseCDF (a linear CDF) and a Shaped Repeat of
    DiscretizedGaussian: the port's container bytes are the reference's,
    and decode inverts them."""
    from repro import codecs as rc
    from repro_torch import codecs as pc

    rng = np.random.default_rng(8)
    lanes = 5
    mu = rng.normal(0, 1, (lanes, 6)).astype(np.float32)
    sg = np.exp(rng.uniform(-2, 0.5, (lanes, 6))).astype(np.float32)
    a = rng.integers(0, 256, lanes).astype(np.int32)
    b = rng.integers(0, 1024, (lanes, 2, 3)).astype(np.int32)
    ref = rc.Serial([
        rc.PointwiseCDF(lambda i: i.astype(jnp.float32) / 256, bits=8),
        rc.Shaped(rc.Repeat(lambda d: rc.DiscretizedGaussian(
            jnp.asarray(mu)[:, d], jnp.asarray(sg)[:, d], 10), 6), (2, 3))])
    tmu, tsg = torch.from_numpy(mu), torch.from_numpy(sg)
    port = pc.Serial([
        pc.PointwiseCDF(lambda i: i.float() / 256, bits=8),
        pc.Shaped(pc.Repeat(lambda d: pc.DiscretizedGaussian(
            tmu[:, d], tsg[:, d], 10), 6), (2, 3))])
    with jax.threefry_partitionable(False):
        want = rc.compress(ref, (jnp.asarray(a), jnp.asarray(b)),
                           lanes=lanes, seed=2)
    got = pc.compress(port, (a, b), lanes=lanes, seed=2, device="cpu")
    assert got.hex() == want.hex()
    ga, gb = pc.decompress(port, want, device="cpu")
    np.testing.assert_array_equal(ga.numpy(), a)
    np.testing.assert_array_equal(gb.numpy(), b)


# ---------------------------------------------------------------------------
# Appends without a host sync (the spill column): the same stacks as the
# reference's ``mode="drop"`` scatter, past capacity too, and no op on the
# push path that reads a device value back to the host.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [0, 3, 20])
def test_appends_past_capacity_match_reference(cap):
    """``seed_stack``, ``ans.push`` and ``ops.push_many`` into a stack too
    small for them: buf, ptr and the overflow counts are the
    reference's, and the spill column stays out of sight."""
    from repro.kernels.ans import ops as ref_ops
    from repro_torch.kernels.ans import ops

    lanes = 4
    with jax.threefry_partitionable(False):
        ref = ref_container.fresh_stack(lanes, cap, seed=6, init_chunks=5)
    port = container.fresh_stack(lanes, cap, seed=6, init_chunks=5,
                                 device="cpu")
    assert_same_stack(port, ref)
    assert tuple(port.buf.shape) == (lanes, cap)
    rng = np.random.default_rng(cap)
    for _ in range(3):
        freq = rng.integers(1, 64, lanes)
        start = rng.integers(0, (1 << 16) - 64, lanes)
        ref = ref_ans.push(ref, jnp.asarray(start, jnp.uint32),
                           jnp.asarray(freq, jnp.uint32), 16)
        port = ans.push(port, torch.from_numpy(start), torch.from_numpy(freq),
                        16)
        assert_same_stack(port, ref)
    freqs = rng.integers(1, 256, (30, lanes))
    starts = rng.integers(0, (1 << 16) - 256, (30, lanes))
    ref = ref_ops.push_many(ref, jnp.asarray(starts, jnp.uint32),
                            jnp.asarray(freqs, jnp.uint32), 16)
    port = ops.push_many(port, torch.from_numpy(starts),
                         torch.from_numpy(freqs), 16)
    assert_same_stack(port, ref)
    assert tuple(port.buf.shape) == (lanes, cap)
    assert int(port.overflows.sum()) > 0
    msg, lengths = ans.flatten(port)
    rmsg, rlen = ref_ans.flatten(ref)
    np.testing.assert_array_equal(msg.numpy(), np.asarray(rmsg))


def test_append_to_a_buffer_without_a_spill_column():
    """A stack built around a plain [lanes, cap] buffer still appends: the
    returned buffer is a copy that has the spill column."""
    buf = torch.arange(6, dtype=torch.int32).reshape(2, 3).contiguous()
    keep = torch.tensor([True, False])
    out = ans.append(buf, torch.arange(2), torch.tensor([1, 2]),
                     torch.tensor([70, 80]), keep)
    np.testing.assert_array_equal(out.numpy(), [[0, 70, 2], [3, 4, 5]])
    again = ans.append(out, torch.arange(2), torch.tensor([0, 9]),
                       torch.tensor([7, 9]), keep)
    assert again.data_ptr() == out.data_ptr()      # in place this time
    np.testing.assert_array_equal(again.numpy(), [[7, 70, 2], [3, 4, 5]])


class _HostReads:
    """A dispatch mode that records every op that reads a tensor's value
    back to the host: an item or a bool, ``nonzero``, ``masked_select``,
    and indexing with a boolean mask (a ``nonzero`` inside)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func.overloadpacket)
                masks = name.startswith(("aten.index", "aten.index_put")) \
                    and any(isinstance(t, torch.Tensor)
                            and t.dtype == torch.bool for t in args[1])
                if masks or name in ("aten.nonzero", "aten.masked_select",
                                     "aten._local_scalar_dense",
                                     "aten.is_nonzero", "aten.equal"):
                    seen.append(name)
                return func(*args, **(kwargs or {}))

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def test_block_push_reads_nothing_back_from_the_device():
    """One pipelined-stream block push of the fixed-point VAE (the
    compiled chain on a seeded stack) and the stack's content bits run
    with no op that waits for the device; the boolean-mask append this
    replaced is caught by the same check."""
    from repro_torch import codecs as pc
    from repro_torch import weights
    from repro_torch.models import vae
    from repro_torch.stream import coder
    from tests.golden.make_torch_fixtures import VAE_PARAMS

    params = weights.from_jax_params(dict(np.load(VAE_PARAMS)), device="cpu")
    codec = vae.make_bb_codec_q(params, vae.VAEConfig(36, 24, 6))
    block = pc.compile(coder.BlockChain(codec, 2))
    xs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, (2, 4, 36)).astype(np.int32))
    stack = container.fresh_stack(4, 256, seed=0, init_chunks=16,
                                  device="cpu")
    block.push(container.fresh_stack(4, 256, seed=0, init_chunks=16,
                                     device="cpu"), xs)   # warm the caches
    with _HostReads() as reads:
        stack = ans.seed_stack(stack, np.array([0, 5], np.uint32), 4)
        pushed = block.push(stack, xs)
        ans.stack_content_bits(pushed)
    assert reads.seen == []
    buf, keep = torch.zeros((2, 3), dtype=torch.int32), torch.tensor(
        [True, False])
    with _HostReads() as reads:
        buf[torch.arange(2)[keep], torch.tensor([0, 1])[keep]] = 5
    assert reads.seen
