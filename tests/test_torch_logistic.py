"""The port's logistic and Bernoulli coding against the JAX reference, bit
for bit: XLA-CPU's float32 sigmoid (``xla_ndtr.sigmoid_f32``), the
``Bernoulli`` and ``DiscretizedLogistic`` leaves, the logistic kind of
the grid-pop plain version (``twin.pop_grid_emit``) and of the push-side
starts, and the compiled ``Repeat`` of either leaf. The CUDA kernels are
held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as ref_codecs  # noqa: E402
from repro.codecs import leaves as ref_leaves  # noqa: E402
from repro.core import distributions as ref_dist  # noqa: E402
from repro.kernels.ans import kernel as ref_kernel  # noqa: E402
from repro.kernels.ans import ops as ref_ops  # noqa: E402
from repro.kernels.ans import ref as ref_ref  # noqa: E402
from repro.kernels.ans import xla as ref_xla  # noqa: E402
from repro.kernels.bucketize import kernel as ref_bucketize  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch.codecs import container, leaves  # noqa: E402
from repro_torch.core import discretize, xla_ndtr  # noqa: E402
from repro_torch.kernels.ans import ops, ref, twin  # noqa: E402

# ``repro_torch.codecs.compile`` the function shadows the module's path.
port_compile = importlib.import_module("repro_torch.codecs.compile")
STEPS = 6


def _sigmoid_inputs() -> np.ndarray:
    """Over 2M float32 inputs: a normal and a uniform bulk, every float32
    in [-89, -87] and [87, 89] (where exp(-x) nears overflow and the
    result turns subnormal), magnitudes down to subnormals, random bit
    patterns (NaN and infinities among them) and the special values."""
    rng = np.random.default_rng(16)
    band = np.arange(np.float32(87).view(np.int32),
                     np.float32(89).view(np.int32),
                     dtype=np.int32).view(np.float32)
    parts = [
        rng.normal(0.0, 30.0, 600_000),
        rng.uniform(-100.0, 100.0, 600_000),
        band, -band,
        rng.uniform(-1, 1, 200_000) * 10.0 ** rng.uniform(-45, 38, 200_000),
        rng.integers(0, 2 ** 32, 300_000, dtype=np.uint64)
        .astype(np.uint32).view(np.float32),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
         3.4028235e38, -3.4028235e38, 88.72284, -88.72284, 87.33655,
         -87.33655],
    ]
    return np.concatenate([np.asarray(p, np.float32) for p in parts])


def test_sigmoid_bit_exact_over_2m_inputs():
    x = _sigmoid_inputs()
    assert x.size >= 2_000_000
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    jitted = np.asarray(jax.jit(jax.nn.sigmoid)(jnp.asarray(x)))
    got = xla_ndtr.sigmoid_f32(torch.from_numpy(x)).numpy()
    nan = np.isnan(got) & np.isnan(want)
    for ref_bits in (want, jitted):
        same = (got.view(np.uint32) == ref_bits.view(np.uint32)) | nan
        assert same.all(), (
            f"{int((~same).sum())} of {x.size} differ, e.g. x="
            f"{x[~same][:5]}: {got[~same][:5]} vs {ref_bits[~same][:5]}")
    # torch's own sigmoid is not XLA's: the reason sigmoid_f32 exists.
    assert (torch.sigmoid(torch.from_numpy(x)).numpy().view(np.uint32)
            != want.view(np.uint32)).sum() > 0


def _params(lanes, n=None, seed=0):
    rng = np.random.default_rng(seed + 7 * lanes)
    shape = (lanes,) if n is None else (lanes, n)
    mu = rng.normal(0.0, 1.5, shape).astype(np.float32)
    scale = rng.uniform(0.05, 2.0, shape).astype(np.float32)
    logits = rng.normal(0.0, 6.0, shape).astype(np.float32)
    return mu, scale, logits


def _sample_logistic(mu, scale, bits, rng):
    """Bucket indices of logistic draws on the N(0,1) bucket grid."""
    u = rng.uniform(1e-6, 1 - 1e-6, mu.shape)
    z = mu + scale * np.log(u / (1 - u))
    edges = discretize.edge_table(bits, "cpu").numpy()
    return np.clip(np.searchsorted(edges, z) - 1, 0,
                   (1 << bits) - 1).astype(np.int32)


@pytest.mark.parametrize("precision,bits", [(16, 10), (12, 8)])
@pytest.mark.parametrize("lanes", [1, 5])
def test_logistic_starts_match_reference(lanes, precision, bits):
    mu, scale, _ = _params(lanes)
    i = np.arange(-1, (1 << bits) + 2)[:, None].repeat(lanes, 1)
    want = ref_leaves.logistic_starts_fn(
        jnp.asarray(mu), jnp.asarray(scale), bits, precision)(jnp.asarray(i))
    got = leaves.logistic_starts_fn(torch.from_numpy(mu),
                                    torch.from_numpy(scale), bits,
                                    precision)(torch.from_numpy(i))
    # F(-1) = -1 wraps to 2^32 - 1 in the reference's uint32.
    np.testing.assert_array_equal(got.numpy() & 0xFFFFFFFF,
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("leaf", ["bernoulli", "logistic"])
@pytest.mark.parametrize("lanes", [1, 4])
def test_leaf_wire_matches_reference(leaf, lanes):
    """A Repeat of one leaf family, interpreted, over 5 positions: the
    port's bytes are the reference's, and they decode."""
    n = 5
    mu, scale, logits = _params(lanes, n, seed=1)
    rng = np.random.default_rng(lanes)
    if leaf == "bernoulli":
        data = (rng.random((lanes, n)) < 1 / (1 + np.exp(-logits))) \
            .astype(np.int32)
        mk_ref = lambda d: ref_dist.Bernoulli(jnp.asarray(logits)[:, d])
        mk = lambda d: codecs.Bernoulli(torch.from_numpy(logits)[:, d])
    else:
        data = _sample_logistic(mu, scale, 10, rng)
        mk_ref = lambda d: ref_leaves.DiscretizedLogistic(
            jnp.asarray(mu)[:, d], jnp.asarray(scale)[:, d], 10)
        mk = lambda d: codecs.DiscretizedLogistic(
            torch.from_numpy(mu)[:, d], torch.from_numpy(scale)[:, d], 10)
    kw = dict(lanes=lanes, seed=3, init_chunks=0)
    with jax.threefry_partitionable(False):
        want = ref_codecs.compress(ref_codecs.Repeat(mk_ref, n),
                                   jnp.asarray(data), **kw)
    rep = codecs.Repeat(mk, n)
    got = codecs.compress(rep, data, device="cpu", **kw)
    assert got.hex() == want.hex()
    assert codecs.compress(codecs.compile(rep), data, device="cpu",
                           **kw).hex() == want.hex()
    np.testing.assert_array_equal(
        codecs.decompress(rep, want, device="cpu").numpy(), data)
    np.testing.assert_array_equal(
        codecs.decompress(codecs.compile(rep), want, device="cpu").numpy(),
        data)


@pytest.mark.parametrize("leaf", ["bernoulli", "logistic"])
def test_compiled_repeat_lowers_to_one_kernel_node(leaf):
    mu, scale, logits = _params(3, 4)
    if leaf == "bernoulli":
        rep = codecs.Repeat(
            lambda d: codecs.Bernoulli(torch.from_numpy(logits)[:, d]), 4)
        want = port_compile._TableRepeat
    else:
        rep = codecs.Repeat(lambda d: codecs.DiscretizedLogistic(
            torch.from_numpy(mu)[:, d], torch.from_numpy(scale)[:, d], 10),
            4)
        want = port_compile._GridRepeat
    assert isinstance(codecs.compile(rep).lowered, want)
    # A heterogeneous body stays interpreted, as in the reference.
    mixed = codecs.Repeat(lambda d: codecs.Uniform(4) if d % 2 else
                          codecs.Uniform(5), 4)
    assert isinstance(codecs.compile(mixed).lowered, codecs.Repeat)


def test_compile_refuses_broken_logistic_params():
    mu, scale, _ = _params(2, 3)
    scale[1, 2] = 0.0
    rep = codecs.Repeat(lambda d: codecs.DiscretizedLogistic(
        torch.from_numpy(mu)[:, d], torch.from_numpy(scale)[:, d], 10), 3)
    with pytest.raises(ValueError, match="strictly positive"):
        codecs.compile(rep)


def _grid_inputs(lanes, precision):
    rng = np.random.default_rng(lanes * 13 + precision)
    mu, scale, _ = _params(lanes, STEPS, seed=precision)
    return {
        "head": rng.integers(1 << 16, 1 << 32, lanes, dtype=np.uint64)
        .astype(np.uint32),
        "feed": rng.integers(0, 1 << 16, (STEPS, lanes)).astype(np.uint32),
        "mu": mu.T.copy(), "sigma": scale.T.copy(),
        "idx": rng.integers(0, 1 << (10 if precision == 16 else 8),
                            (STEPS, lanes)).astype(np.int32),
    }


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("lanes", [1, 3, 130])
def test_logistic_grid_pop_matches_reference(lanes, precision, interpret):
    """``twin.pop_grid_emit(kind="logistic")`` against the reference's XLA
    twin and its Pallas kernel in interpret mode."""
    d = _grid_inputs(lanes, precision)
    lb = 10 if precision == 16 else 8
    args = (jnp.asarray(d["head"]), jnp.asarray(d["mu"]),
            jnp.asarray(d["sigma"]), jnp.asarray(d["feed"]),
            ref_bucketize.edge_table(lb), "logistic", lb, precision)
    want = ref_kernel.pop_grid_emit(*args, interpret=True, lane_tile=lanes) \
        if interpret else ref_xla.pop_grid_emit(*args)
    got = twin.pop_grid_emit(_t(d["head"]), _t(d["mu"]), _t(d["sigma"]),
                             _t(d["feed"]), discretize.edge_table(lb, "cpu"),
                             "logistic", lb, precision)
    for p, r in zip(got, want):
        np.testing.assert_array_equal(p.numpy().astype(np.int64),
                                      np.asarray(r).astype(np.int64))


@pytest.mark.parametrize("backend", ["torch", "ref"])
@pytest.mark.parametrize("lanes", [2, 9])
def test_logistic_ops_match_reference_ops(lanes, backend):
    """``ops.pop_many_grid`` and ``ops.grid_starts`` + ``push_many`` of the
    logistic kind: the port's stacks equal the reference's word for word
    (and the reference's ``ref.py`` oracle's)."""
    d = _grid_inputs(lanes, 16)
    with jax.threefry_partitionable(False):
        r = ref_codecs.fresh_stack(lanes, 24, seed=5, init_chunks=8)
    port = container.fresh_stack(lanes, 24, seed=5, init_chunks=8,
                                 device="cpu")
    mu, sg = jnp.asarray(d["mu"]), jnp.asarray(d["sigma"])
    r2, want = ref_ops.pop_many_grid(r, "logistic", mu, sg, STEPS, 10, 16)
    r3, want3 = ref_ref.pop_many_grid_ref(r, "logistic", mu, sg, STEPS, 10,
                                          16)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want3))
    port, got = ops.pop_many_grid(port, "logistic", _t(d["mu"]),
                                  _t(d["sigma"]), STEPS, 10, 16,
                                  backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = ref_leaves.logistic_starts_fn(mu, sg, 10, 16)
    idx = np.asarray(want).astype(np.int32)
    start = f(jnp.asarray(idx))
    freq = f(jnp.asarray(idx) + 1) - start
    r2 = ref_ops.push_many(r2, start[::-1], freq[::-1], 16)
    s, fr = ops.grid_starts(torch.from_numpy(idx), _t(d["mu"]),
                            _t(d["sigma"]), 10, 16, backend=backend,
                            kind="logistic")
    np.testing.assert_array_equal(s.numpy().astype(np.int64),
                                  np.asarray(start).astype(np.int64))
    port = ops.push_many(port, s.flip(0), fr.flip(0), 16, backend=backend)
    for name in ("head", "buf", "ptr", "underflows", "overflows"):
        np.testing.assert_array_equal(
            np.asarray(getattr(port, name)).astype(np.int64),
            np.asarray(getattr(r2, name)).astype(np.int64), err_msg=name)
    if backend == "ref":
        back, _ = ref.pop_many_grid_ref(
            container.fresh_stack(lanes, 24, seed=5, init_chunks=8,
                                  device="cpu"), "logistic", _t(d["mu"]),
            _t(d["sigma"]), STEPS, 10, 16)
        np.testing.assert_array_equal(np.asarray(back.head),
                                      np.asarray(r3.head).astype(np.int64))
