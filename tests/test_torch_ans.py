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
