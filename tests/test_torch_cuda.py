"""The hand-written CUDA kernels against their plain PyTorch versions
(``repro_torch.kernels.ans.twin``), bit for bit, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports neither JAX nor ``repro``, so it runs on a machine
that has only PyTorch and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import codecs, stream  # noqa: E402
from repro_torch.codecs import container  # noqa: E402
from repro_torch.core import discretize  # noqa: E402
from repro_torch.kernels.ans import ops, twin  # noqa: E402

STEPS = 6


@pytest.fixture
def kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.ans import kernel
    kernel.build()
    return kernel


def _inputs(lanes, precision, seed=0):
    rng = np.random.default_rng(seed + lanes * 31 + precision)
    total = 1 << precision
    lat_bits = 10 if precision == 16 else 8
    f1 = rng.integers(1, total - 1, (STEPS, lanes))
    sym = rng.integers(0, 2, (STEPS, lanes))
    f0 = total - f1
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return lat_bits, {
        "head": torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes,
                                              dtype=np.int64)),
        "starts": i32(np.where(sym == 1, f0, 0)),
        "freqs": i32(np.where(sym == 1, f1, f0)),
        "tables": i32(np.stack([np.zeros_like(f1), f0,
                                np.full_like(f1, total)], -1)),
        "feed": i32(rng.integers(0, 1 << 16, (STEPS, lanes))),
        "mu": torch.from_numpy(rng.normal(0.0, 1.5, (STEPS, lanes))
                               .astype(np.float32)),
        "sigma": torch.from_numpy(np.exp(rng.uniform(
            -4.0, 1.0, (STEPS, lanes))).astype(np.float32)),
        "idx": i32(rng.integers(0, 1 << lat_bits, (STEPS, lanes))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("lanes", [1, 3, 128, 130])
def test_kernels_match_twin(kernel, lanes, precision):
    lb, c = _inputs(lanes, precision)
    g = {k: v.cuda() for k, v in c.items()}
    e = discretize.edge_table(lb, "cpu")
    pairs = [
        (kernel.push_emit(g["head"], g["starts"], g["freqs"], precision),
         twin.push_emit(c["head"], c["starts"], c["freqs"], precision)),
        (kernel.pop_dyntable_emit(g["head"], g["tables"], g["feed"],
                                  precision),
         twin.pop_dyntable_emit(c["head"], c["tables"], c["feed"],
                                precision)),
        (kernel.grid_starts(g["idx"], g["mu"], g["sigma"], e.cuda(), lb,
                            precision),
         twin.grid_starts(c["idx"], c["mu"], c["sigma"], e, lb, precision)),
    ]
    for kind in ("gaussian", "uniform"):
        pairs.append((
            kernel.pop_grid_emit(g["head"], g["mu"], g["sigma"], g["feed"],
                                 e.cuda(), kind, lb, precision),
            twin.pop_grid_emit(c["head"], c["mu"], c["sigma"], c["feed"], e,
                               kind, lb, precision)))
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))


@pytest.mark.cuda
def test_ops_launch_the_kernel_and_count_it(kernel):
    _, c = _inputs(130, 16)
    stack = container.fresh_stack(130, 96, seed=0, init_chunks=8,
                                  device="cuda")
    kernel.reset_launches()
    ops.push_many(stack, c["starts"].cuda(), c["freqs"].cuda(), 16)
    assert kernel.LAUNCHES["push_emit"] == 1
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.push_emit(c["head"], c["starts"], c["freqs"], 16)
    with pytest.raises(RuntimeError, match="only the kernel runs"):
        ops.push_many(stack, c["starts"].cuda(), c["freqs"].cuda(), 16,
                      backend="torch")


def _table(rng, lanes, a1):
    """Non-decreasing tables 0 .. 2^16 with zero-frequency symbols; lane 0
    all zeros (a padded lane)."""
    w = rng.integers(1, 100, (lanes, a1 - 1)) * \
        (rng.random((lanes, a1 - 1)) > 0.3)
    w[:, 0] += 1
    cdf = np.floor(np.cumsum(w, 1) / w.sum(1, keepdims=True) * 65536)
    table = np.concatenate([np.zeros((lanes, 1)), cdf], 1)
    table[:, -1] = 65536
    table[0] = 0
    return torch.from_numpy(table.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,a1,steps", [(1, 3, 1), (130, 13, 64),
                                            (300, 257, 64)])
def test_table_kernels_match_twin(kernel, lanes, a1, steps):
    rng = np.random.default_rng(lanes + a1)
    head = torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes,
                                         dtype=np.int64))
    table = _table(rng, lanes, a1)
    feed = torch.from_numpy(rng.integers(0, 1 << 16, (steps, lanes))
                            .astype(np.int32))
    got = kernel.pop_table_emit(head.cuda(), table.cuda(), feed.cuda(), 16)
    want = twin.pop_table_emit(head, table, feed, 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))
    for p in (8, 16):
        assert torch.equal(kernel.pop_slots(head.cuda(), p).cpu(),
                           twin.pop_slots(head, p))


@pytest.mark.cuda
def test_categorical_stream_on_the_card_equals_the_cpu_twin(kernel):
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    data = rng.integers(0, 256, (20, 64)).astype(np.int32)
    wires = {}
    for dev in ("cpu", "cuda"):
        codec = codecs.Categorical(logits.to(dev))
        wires[dev] = stream.encode_stream(codec, data, lanes=64,
                                          block_symbols=8, seed=0,
                                          pipeline=True, device=dev)
    assert wires["cuda"] == wires["cpu"]
    kernel.reset_launches()
    out = stream.decode_stream(codecs.Categorical(logits.cuda()),
                               wires["cuda"], device="cuda")
    assert torch.equal(out.cpu(), torch.from_numpy(data))
    assert kernel.LAUNCHES["pop_table_emit"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("lanes", [1, 3, 128, 130])
def test_logistic_kernels_match_twin(kernel, lanes, precision):
    """The logistic kinds of the grid pop and the push-side starts, with
    scales down to 0.05 and locations out to the grid's tails."""
    lb, c = _inputs(lanes, precision, seed=16)
    rng = np.random.default_rng(lanes + precision)
    c["sigma"] = torch.from_numpy(rng.uniform(0.05, 2.0, (STEPS, lanes))
                                  .astype(np.float32))
    g = {k: v.cuda() for k, v in c.items()}
    e = discretize.edge_table(lb, "cpu")
    kernel.reset_launches()
    pairs = [
        (kernel.pop_grid_emit(g["head"], g["mu"], g["sigma"], g["feed"],
                              e.cuda(), "logistic", lb, precision),
         twin.pop_grid_emit(c["head"], c["mu"], c["sigma"], c["feed"], e,
                            "logistic", lb, precision)),
        (kernel.grid_starts(g["idx"], g["mu"], g["sigma"], e.cuda(), lb,
                            precision, "logistic"),
         twin.grid_starts(c["idx"], c["mu"], c["sigma"], e, lb, precision,
                          "logistic")),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))
    assert kernel.LAUNCHES["pop_grid_emit/logistic"] == 1
    assert kernel.LAUNCHES["grid_starts/logistic"] == 1


@pytest.mark.cuda
def test_float_vae_eager_equals_compiled_on_the_card(kernel):
    """The float VAE (36-24-6) on the card: the compiled codec writes the
    eager codec's bytes and decodes them."""
    from repro_torch.models import vae

    cfg = vae.VAEConfig(36, 24, 6)
    params = vae.init(cfg, torch.Generator().manual_seed(2), device="cuda")
    chain = codecs.Chained(vae.make_bb_codec(params, cfg), 3)
    data = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2, (3, 16, 36)).astype(np.int32)).cuda()
    kw = dict(lanes=16, seed=0, device="cuda")
    blob = codecs.compress(codecs.compile(chain), data, **kw)
    assert blob == codecs.compress(chain, data, **kw)
    assert torch.equal(codecs.decompress(codecs.compile(chain), blob,
                                         device="cuda"), data)


@pytest.mark.cuda
def test_float_vae_bits_do_not_depend_on_input_layout(kernel):
    """The network computes the same bits for a row-major input and for
    the transposed view of the same values (cuBLAS would take another
    kernel for the latter)."""
    from repro_torch.models import vae

    cfg = vae.VAEConfig(36, 24, 6)
    params = vae.init(cfg, torch.Generator().manual_seed(2), device="cuda")
    s = torch.from_numpy(np.random.default_rng(6).integers(
        0, 2, (36, 16)).astype(np.int32)).cuda().T
    y = torch.randn((6, 16), device="cuda").T
    for a, b in zip(vae.encode(params, cfg, s),
                    vae.encode(params, cfg, s.contiguous())):
        assert torch.equal(a, b)
    assert torch.equal(vae.decode(params, cfg, y),
                       vae.decode(params, cfg, y.contiguous()))


@pytest.mark.cuda
def test_block_push_does_not_sync(kernel):
    """A compiled block push of the fixed-point VAE on a seeded stack runs
    under ``set_sync_debug_mode("error")``."""
    from repro_torch.models import vae
    from repro_torch.stream import coder

    cfg = vae.VAEConfig(36, 24, 6)
    params = vae.init(cfg, torch.Generator().manual_seed(3), device="cuda")
    block = codecs.compile(coder.BlockChain(vae.make_bb_codec_q(params, cfg),
                                            2))
    xs = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2, (2, 8, 36)).astype(np.int32)).cuda()
    fresh = lambda: container.fresh_stack(8, 256, seed=0, init_chunks=16,
                                          device="cuda")
    want = block.push(fresh(), xs)
    stack = fresh()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = block.push(stack, xs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.buf, want.buf) and torch.equal(got.head, want.head)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,lat_bits", [(1, 10), (130, 10), (300, 12),
                                            (128, 6)])
def test_bucketize_kernel_matches_twin(kernel, lanes, lat_bits):
    """The posterior bucketize at any lane count, slots at both ends,
    mu out to +-8 and sigma from 1e-3 to 30."""
    from repro_torch.kernels.bucketize import kernel as bk
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.bucketize import twin as bk_twin

    rng = np.random.default_rng(lanes + lat_bits)
    slot = rng.integers(0, 1 << 16, lanes)
    slot[:2] = (0, (1 << 16) - 1)[:lanes]
    mu = rng.uniform(-8.0, 8.0, lanes).astype(np.float32)
    sigma = np.exp(rng.uniform(np.log(1e-3), np.log(30.0), lanes))
    c = [torch.from_numpy(slot.astype(np.int32)), torch.from_numpy(mu),
         torch.from_numpy(sigma.astype(np.float32))]
    e = discretize.edge_table(lat_bits, "cpu")
    kernel.reset_launches()
    got = bk.bucketize(*(t.cuda() for t in c), e.cuda(), lat_bits, 16)
    want = bk_twin.bucketize(*c, e, lat_bits, 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert kernel.LAUNCHES["bucketize"] == 1
    with pytest.raises(RuntimeError, match="only the kernel runs"):
        bk_ops.bucketize(*(t.cuda() for t in c), lat_bits, 16,
                         backend="torch")


@pytest.mark.cuda
def test_hvae_kernel_leaf_on_the_card(kernel):
    """The float HVAE (ch 8, 8 x 8) on the card: the bucketize-kernel
    codec, the plain one and the compiled one write the same bytes, and
    the kernel decodes one latent position per launch."""
    from repro_torch.models import hvae

    cfg = hvae.HVAEConfig(levels=2, ch=8, z_ch=2, n_res=1)
    params = hvae.init(cfg, torch.Generator().manual_seed(1), device="cuda")
    data = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2, (1, 16, 8, 8)).astype(np.int32)).cuda()
    kw = dict(lanes=16, seed=0, init_chunks=256, device="cuda")
    blobs = []
    for opt in ({"use_bucketize_kernel": True}, {}, {"compiled": True}):
        kernel.reset_launches()
        chain = codecs.Chained(hvae.make_bitswap_codec(params, cfg, (8, 8),
                                                       **opt), 1)
        blobs.append(codecs.compress(chain, data, **kw))
        if opt.get("use_bucketize_kernel"):
            assert kernel.LAUNCHES["bucketize"] == 2 * 4 * 4 * 2
            kernel.reset_launches()
            assert torch.equal(codecs.decompress(chain, blobs[0],
                                                 device="cuda"), data)
            assert kernel.LAUNCHES["bucketize"] == 4 * 4 * 2
    assert blobs[0] == blobs[1] == blobs[2]
