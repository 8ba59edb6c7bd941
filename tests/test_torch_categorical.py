"""The port's static-table ``Categorical`` and the threefry ``fold_in``
against the JAX reference: the coding table bit for bit (XLA-CPU's
softmax and sum order), the per-block key derivation, and the codec's
stack word for word."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codecs import container as ref_container  # noqa: E402
from repro.core import distributions as ref_dist  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch.codecs import container  # noqa: E402
from repro_torch.core import ans, distributions, prng  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7, 1 << 20, (1 << 31) - 1])
def test_fold_in_matches_jax(seed):
    data = [0, 1, 2, 3, 17, 1000, 65535, 1 << 31, (1 << 32) - 1]
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(seed)
        want = [np.asarray(jax.random.fold_in(key, d)) for d in data]
        split = [np.asarray(jax.random.split(k)) for k in want]
    for d, w, s in zip(data, want, split):
        got = prng.fold_in(prng.PRNGKey(seed), d)
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(prng.split(got), s)


@pytest.mark.parametrize("n", [1, 2, 12, 31, 32, 33, 48, 100, 256, 257,
                               1000, 1025])
def test_sum_f32_is_xla_cpu_order(n):
    x = np.random.default_rng(n).exponential(size=(64, n)) \
        .astype(np.float32)
    want = np.asarray(jnp.sum(jnp.asarray(x), axis=-1, keepdims=True))
    got = ans.sum_f32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _logits(seed):
    rng = np.random.default_rng(seed)
    a = int(rng.choice([2, 3, 12, 16, 33, 100, 256, 257, 1000]))
    lanes = int(rng.choice([1, 4, 64]))
    scale = float(rng.choice([0.1, 1.0, 5.0, 30.0, 100.0]))
    shift = float(rng.choice([0.0, -1000.0, 1000.0, -50.0]))
    return (rng.normal(size=(lanes, a)) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("seed", range(24))
def test_table_matches_reference(seed):
    """Large, negative and widely spread logits: the table's every entry
    equals the reference's (flushed subnormal exps included)."""
    logits = _logits(seed)
    want = np.asarray(ref_dist.Categorical(jnp.asarray(logits))._table())
    got = distributions.Categorical(torch.from_numpy(logits))._table()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_table_precision_and_log_prob():
    logits = _logits(3)
    for precision in (10, 14):
        want = ref_dist.Categorical(jnp.asarray(logits), precision)._table()
        got = distributions.Categorical(torch.from_numpy(logits),
                                        precision)._table()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sym = np.arange(logits.shape[0]) % logits.shape[1]
    np.testing.assert_allclose(
        distributions.Categorical(torch.from_numpy(logits))
        .log_prob(torch.from_numpy(sym)).numpy(),
        np.asarray(ref_dist.Categorical(jnp.asarray(logits))
                   .log_prob(jnp.asarray(sym))), rtol=1e-5, atol=1e-5)


def test_codec_matches_reference_stack():
    """Pushes then more pops than pushes (past the clean bits), symbol by
    symbol: the port's stack equals the reference's word for word."""
    rng = np.random.default_rng(11)
    lanes, a = 6, 40
    logits = rng.normal(size=(lanes, a)).astype(np.float32) * 3
    syms = rng.integers(0, a, (10, lanes)).astype(np.int32)
    ref_cat = ref_dist.Categorical(jnp.asarray(logits))
    cat = codecs.Categorical(torch.from_numpy(logits))
    with jax.threefry_partitionable(False):
        r = ref_container.fresh_stack(lanes, 64, seed=3, init_chunks=1)
    p = container.fresh_stack(lanes, 64, seed=3, init_chunks=1,
                              device="cpu")
    for s in syms:
        r = ref_cat.push(r, jnp.asarray(s))
        p = cat.push(p, torch.from_numpy(s))
    for _ in range(40):
        r, rs = ref_cat.pop(r)
        p, ps = cat.pop(p)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    for f in ("head", "buf", "ptr", "underflows", "overflows"):
        np.testing.assert_array_equal(
            getattr(p, f).numpy().astype(np.int64),
            np.asarray(getattr(r, f)).astype(np.int64), err_msg=f)
    assert int(p.underflows.sum()) > 0
