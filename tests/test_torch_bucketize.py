"""The port's posterior-decode bucketize (``repro_torch.kernels.bucketize``)
against the reference's ``repro.kernels.bucketize``: the plain PyTorch
version and the oracle give the reference's (idx, start, freq) bit for
bit, and ``KernelDiscretizedGaussian`` decodes what ``DiscretizedGaussian``
decodes. The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import discretize as ref_discretize  # noqa: E402
from repro.kernels.bucketize import ref as ref_bk  # noqa: E402
from repro.kernels.bucketize import xla as xla_bk  # noqa: E402
from repro_torch import codecs  # noqa: E402
from repro_torch.core import discretize  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ans import twin as ans_twin  # noqa: E402
from repro_torch.kernels.bucketize import ops, ref, twin  # noqa: E402
from repro_torch.models import hvae  # noqa: E402

# The four shapes of the reference's tests/test_kernels.py.
SHAPES = [(8, 8, 16), (64, 10, 16), (200, 12, 16), (128, 6, 12)]


def _random(lanes, lat_bits, precision):
    rng = np.random.default_rng(lanes)
    slot = rng.integers(0, 1 << precision, lanes).astype(np.int64)
    mu = rng.normal(0, 1.2, lanes).astype(np.float32)
    sigma = rng.uniform(0.05, 2.0, lanes).astype(np.float32)
    return slot, mu, sigma


def _edges(precision):
    """Every pairing of the edge slots (0, 1, 2^p - 1 and one inside),
    mu in {-8, 0, 8} and sigma in {1e-3, 1, 30}: 36 lanes."""
    cases = list(itertools.product(
        [0, 1, (1 << precision) - 1, 1 << (precision - 1)],
        [-8.0, 0.0, 8.0], [1e-3, 1.0, 30.0]))
    slot, mu, sigma = (np.array(c) for c in zip(*cases))
    return (slot.astype(np.int64), mu.astype(np.float32),
            sigma.astype(np.float32))


def _reference(slot, mu, sigma, lat_bits, precision):
    args = (jnp.asarray(slot, jnp.uint32), jnp.asarray(mu),
            jnp.asarray(sigma))
    want = [np.asarray(a).astype(np.int64)
            for a in ref_bk.bucketize_ref(*args, lat_bits, precision)]
    xla = [np.asarray(a).astype(np.int64) for a in xla_bk.bucketize(
        *args, ref_discretize.edge_table(lat_bits), lat_bits, precision)]
    for a, b in zip(want, xla):
        np.testing.assert_array_equal(a, b)
    return want


@pytest.mark.parametrize("case", ["random", "edges"])
@pytest.mark.parametrize("lanes,lat_bits,precision", SHAPES)
def test_plain_version_and_oracle_equal_the_reference(case, lanes, lat_bits,
                                                      precision):
    """Bit for bit, tolerance 0: idx, start and freq from the port's plain
    version (through ``ops.bucketize`` on the CPU), its oracle and the
    reference's oracle and XLA twin."""
    slot, mu, sigma = (_random(lanes, lat_bits, precision) if case == "random"
                       else _edges(precision))
    want = _reference(slot, mu, sigma, lat_bits, precision)
    t = [torch.from_numpy(a) for a in (slot, mu, sigma)]
    for backend in ("torch", "ref"):
        got = ops.bucketize(*t, lat_bits, precision, backend=backend)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy().astype(np.int64), w)
    direct = twin.bucketize(t[0].to(torch.int32), t[1], t[2],
                            discretize.edge_table(lat_bits, "cpu"), lat_bits,
                            precision)
    for g, w in zip(direct, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), w)
    # start + freq of the found bucket brackets the slot: F(idx) <= slot
    # < F(idx + 1).
    idx, start, freq = ref.bucketize_ref(*t, lat_bits, precision)
    assert (start.long() <= t[0]).all()
    assert (t[0] < start.long() + freq.long()).all()
    assert (freq > 0).all() and (idx >= 0).all()
    assert (idx < (1 << lat_bits)).all()


@pytest.mark.parametrize("lat_bits", [10, 12])
@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("case", ["random", "edges"])
def test_group_walk_gives_the_reference_buckets(case, group, lat_bits):
    """The CUDA kernel's algorithm on the CPU: ``twin.grid_tree_walk`` (the
    walk ``csrc/bucketize.cu`` runs with a group of 16 or 32 threads a
    lane, round for round) over ``discretize.posterior_starts_fn`` gives
    the reference's (idx, start, freq), exactly."""
    slot, mu, sigma = (_random(300, lat_bits, 16) if case == "random"
                       else _edges(16))
    want = _reference(slot, mu, sigma, lat_bits, 16)
    f = discretize.posterior_starts_fn(
        torch.from_numpy(mu)[:, None], torch.from_numpy(sigma)[:, None],
        lat_bits, 16, discretize.edge_table(lat_bits, "cpu"))
    idx, start, nxt = ans_twin.grid_tree_walk(f, torch.from_numpy(slot),
                                              lat_bits, group)
    for g, w in zip((idx, start, nxt - start), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_the_op_refuses_the_kernel_for_cpu_tensors():
    slot, mu, sigma = (torch.from_numpy(a) for a in _random(8, 8, 16))
    with pytest.raises(RuntimeError, match="cuda backend"):
        ops.bucketize(slot, mu, sigma, 8, 16, backend="cuda")
    with dispatch.use_backend("ref"):
        got = ops.bucketize(slot, mu, sigma, 8, 16)
    for g, w in zip(got, ops.bucketize(slot, mu, sigma, 8, 16)):
        assert torch.equal(g, w)


def test_kernel_leaf_pops_what_the_plain_leaf_pops():
    """As the reference's ``test_kernel_discretized_gaussian_parity``:
    same heads and buckets from one stack, and the push inverts the pop."""
    lanes, bits, prec = 8, 8, 16
    rng = np.random.default_rng(8)
    mu = torch.from_numpy(rng.normal(0, 1, lanes).astype(np.float32))
    sigma = torch.from_numpy(rng.uniform(0.3, 1.5, lanes).astype(np.float32))
    stack = codecs.fresh_stack(lanes, 128, seed=0, init_chunks=16,
                               device="cpu")
    head0 = stack.head.clone()
    plain = codecs.DiscretizedGaussian(mu, sigma, bits, prec)
    kernel = hvae.KernelDiscretizedGaussian(mu, sigma, bits, prec)
    s_plain, idx_plain = plain.pop(stack)
    head_plain = s_plain.head.clone()
    s_ker, idx_ker = kernel.pop(codecs.fresh_stack(
        lanes, 128, seed=0, init_chunks=16, device="cpu"))
    assert torch.equal(idx_plain, idx_ker)
    assert torch.equal(head_plain, s_ker.head)
    back = kernel.push(s_ker, idx_ker)
    assert torch.equal(back.head, head0)
