"""The port's float32 ``ndtr`` (``repro_torch.core.xla_ndtr``) and grid
CDF against the JAX reference, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fractions import Fraction  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.scipy.special import ndtr as jax_ndtr  # noqa: E402

from repro.core import discretize as ref_discretize  # noqa: E402
from repro_torch.core import discretize, xla_ndtr  # noqa: E402

from tests.golden.make_torch_fixtures import LAT_BITS  # noqa: E402

SCALE = float((1 << 16) - (1 << 10))


def _inputs() -> np.ndarray:
    """Over 2M float32 inputs: normal and uniform bulk, every magnitude
    down to subnormals, random bit patterns (NaNs and infinities among
    them), the special values, and 200 ulps each side of every branch
    edge of the sequence (|x| = 1/sqrt2, 1, 2, the erf clamp, the exp
    clamps and the erfc underflow, in a = x * sqrt2)."""
    rng = np.random.default_rng(2024)
    parts = [
        rng.normal(0.0, 3.0, 1_000_000),
        rng.uniform(-15.0, 15.0, 500_000),
        rng.uniform(-1, 1, 200_000) * 10.0 ** rng.uniform(-45, 2, 200_000),
        rng.integers(0, 2 ** 32, 300_000, dtype=np.uint64)
        .astype(np.uint32).view(np.float32),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
         1.1754944e-38, -1.1754944e-38, 3.4028235e38, -3.4028235e38],
    ]
    edges = []
    for xe in (0.70710677, 1.0, 2.0, 3.7439213, 9.3704, 9.4196, 9.4227):
        for sign in (1.0, -1.0):
            a = np.float32(sign * xe / 0.70710677)
            up = down = a
            for _ in range(200):
                edges += [up, down]
                up = np.nextafter(up, np.float32(np.inf))
                down = np.nextafter(down, np.float32(-np.inf))
    parts.append(edges)
    return np.concatenate([np.asarray(p, np.float32) for p in parts])


def test_ndtr_bit_exact_over_2m_inputs():
    x = _inputs()
    assert x.size >= 2_000_000
    want = np.asarray(jax.jit(jax_ndtr)(jnp.asarray(x)))
    got = xla_ndtr.ndtr(torch.from_numpy(x)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) \
        | (np.isnan(got) & np.isnan(want))
    assert same.all(), (
        f"{int((~same).sum())} of {x.size} differ, e.g. "
        f"{x[~same][:5]} -> {got[~same][:5]} vs {want[~same][:5]}")
    # H3: the inputs where torch's own ndtr flips a fixed-point start are
    # in the set, and the twin gets each of them right.
    torch_c = torch.special.ndtr(torch.from_numpy(x)).numpy()
    finite = np.isfinite(x)
    flips = finite & (np.floor(torch_c * SCALE) != np.floor(want * SCALE))
    assert flips.sum() > 1000
    np.testing.assert_array_equal(np.floor(got[flips] * SCALE),
                                  np.floor(want[flips] * SCALE))


def _fma_exact(a: float, b: float, c: float) -> np.float32:
    v = Fraction(a) * Fraction(b) + Fraction(c)
    g = np.float32(float(v))
    near = [g, np.nextafter(g, np.float32(np.inf)),
            np.nextafter(g, np.float32(-np.inf))]
    return min(near, key=lambda t: (abs(Fraction(float(t)) - v),
                                    int(np.array(t).view(np.uint32)) & 1))


def test_fma_is_a_single_rounding():
    rng = np.random.default_rng(7)
    a, b, c = (rng.normal(0, 1, 3000) * 10.0 ** rng.integers(-6, 6, 3000)
               for _ in range(3))
    a, b, c = (v.astype(np.float32) for v in (a, b, c))
    # near-cancellation cases, where a double-rounded sum would slip
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    got = xla_ndtr.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(float(x), float(y), float(z))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("lat_bits,precision", [(10, 16), (8, 12)])
def test_posterior_starts_match_reference_on_the_full_grid(lat_bits,
                                                           precision):
    rng = np.random.default_rng(lat_bits)
    n = 48
    mu = rng.normal(0.0, 2.0, n).astype(np.float32)
    sigma = np.exp(rng.uniform(-5.0, 2.0, n)).astype(np.float32)
    k = 1 << lat_bits
    i = np.broadcast_to(np.arange(k + 1, dtype=np.int32)[:, None], (k + 1, n))

    def ref(m, s, ii):
        return ref_discretize.posterior_starts_fn(m, s, lat_bits,
                                                  precision)(ii)

    want = np.asarray(jax.jit(ref)(jnp.asarray(mu), jnp.asarray(sigma),
                                   jnp.asarray(i)))
    got = discretize.posterior_starts_fn(
        torch.from_numpy(mu), torch.from_numpy(sigma), lat_bits,
        precision)(torch.from_numpy(np.ascontiguousarray(i)).long())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("lat_bits", LAT_BITS)
def test_grid_tables_are_the_references(lat_bits):
    np.testing.assert_array_equal(
        discretize.edge_table(lat_bits, "cpu").numpy(),
        np.asarray(ref_discretize.edge_table(lat_bits)))
    np.testing.assert_array_equal(
        discretize.centre_table(lat_bits, "cpu").numpy(),
        np.asarray(ref_discretize.centre_table(lat_bits)))


def test_missing_grid_table_raises():
    with pytest.raises(ValueError, match="no committed"):
        discretize.edge_table(13, "cpu")
