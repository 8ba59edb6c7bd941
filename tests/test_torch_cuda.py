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
@pytest.mark.parametrize("lanes", [1, 3, 32, 128, 130, 4101])
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
@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("lanes,a1", [
    (lanes, a1) for a1 in (3, 13, 257, 4097)
    for lanes in (1, 3, 130, 4096, 4101)] + [
    (2640, 257), (2641, 257), (4096, 56), (4096, 57), (4096, 448),
    (4096, 449), (130, 31), (4096, 31), (130, 4098), (130, 15872),
    (130, 15873), (130, 1 << 16)])
def test_table_pop_widths_match_twin(kernel, lanes, a1, precision):
    """Every width band of the table pop's launcher (groups of 8, 16 and
    32; the window alone, top round and window, a probe round between - at
    more than 2640 lanes in groups of 8 from 57 to 448 entries -, a staged
    sample of a 2^16-entry row) over 70 steps (off its 32-step
    tiles), with slots at 0 and 2^p - 1 and heads near 2^32, all-zero
    rows and zero-frequency symbols, against the plain version on the
    card. At precision 12 the tables are the precision-16 ones shifted
    right by 4 (more equal starts)."""
    rng = np.random.default_rng(lanes + a1 + precision)
    head = rng.integers(1 << 16, 1 << 32, lanes, dtype=np.int64)
    head[::4] = (1 << 32) - 1 - rng.integers(0, 1 << 12, len(head[::4]))
    head[1::4] &= ~((1 << precision) - 1)
    head[2::4] |= (1 << precision) - 1
    table = _table(rng, lanes, a1) >> (16 - precision)
    table[5::7] = 0
    feed = rng.integers(0, 1 << 16, (70, lanes)).astype(np.int32)
    args = [torch.from_numpy(head).cuda(), table.cuda(),
            torch.from_numpy(feed).cuda(), precision]
    got = kernel.pop_table_emit(*args)
    want = twin.pop_table_emit(*args)
    for a, b in zip(got, want):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))


@pytest.mark.cuda
def test_table_pop_refuses_rows_past_its_widest(kernel):
    head = torch.zeros(2, dtype=torch.int64, device="cuda")
    feed = torch.zeros((4, 2), dtype=torch.int32, device="cuda")
    wide = torch.zeros((2, (1 << 16) + 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="at most 65536 entries"):
        kernel.pop_table_emit(head, wide, feed, 16)
    with pytest.raises(ValueError, match="precision must be in"):
        kernel.pop_table_emit(head, wide[:, :3].contiguous(), feed, 17)


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


@pytest.mark.cuda
@pytest.mark.parametrize("bh,g,sq,sk,d,causal,window,dtype", [
    (4, 1, 64, 64, 16, True, 0, "float32"),
    (6, 3, 300, 300, 64, True, 0, "bfloat16"),     # GQA, ragged tiles
    (4, 2, 257, 257, 64, True, 100, "float32"),    # windowed
    (2, 1, 96, 160, 32, False, 0, "float32"),
    (4, 4, 130, 130, 128, True, 0, "bfloat16"),    # mistral-nemo's head
    (32, 4, 4096, 4096, 160, True, 0, "bfloat16"),  # stablelm-12b's layer
    (6, 3, 300, 300, 192, True, 0, "bfloat16"),     # the largest D
    (4, 2, 257, 257, 160, True, 100, "float32"),    # ragged, windowed
    (2, 2, 100, 84, 8, True, 0, "float32"),
    (14, 7, 4096, 4096, 64, True, 0, "bfloat16"),  # qwen2-0.5b's layer
    (14, 7, 4096, 4096, 128, True, 0, "bfloat16"),
    (6, 3, 300, 300, 40, True, 0, "bfloat16"),     # D padded to 48
    (2, 1, 96, 160, 24, False, 0, "bfloat16"),     # D padded to 32
    (6, 3, 700, 700, 64, True, 256, "bfloat16"),   # windowed
    # The float32 route's instances (D rounded up to 32, padded to 4):
    (7, 7, 65, 65, 1, True, 0, "float32"),       # one past a query tile
    (8, 4, 1, 300, 8, False, 0, "float32"),      # Sq = 1
    (14, 7, 129, 129, 60, True, 1, "float32"),   # window 1
    (8, 4, 300, 200, 100, False, 0, "float32"),  # Sq != Sk
    (14, 7, 129, 129, 128, True, 0, "float32"),
    (8, 4, 65, 65, 160, True, 32, "float32"),
    (14, 7, 1, 1, 192, True, 0, "float32"),
    (8, 4, 300, 300, 192, False, 0, "float32"),
    (280, 4, 129, 129, 64, True, 0, "float32"),  # 128-query blocks
    (280, 4, 257, 257, 32, True, 100, "float32"),
])
def test_flash_kernel_matches_twin(kernel, bh, g, sq, sk, d, causal,
                                   window, dtype):
    """The flash forward against its plain version on the same inputs on
    the card (float32 sums in another order: 2e-5; bfloat16 outputs and
    p: 2e-2, the Pallas kernel test's tolerances), through the route its
    dtype picks, launched once."""
    from repro_torch.kernels.flash import kernel as fk
    from repro_torch.kernels.flash import ops as f_ops
    from repro_torch.kernels.flash import twin as f_twin

    rng = np.random.default_rng(bh + sq + d)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (n, s, d)).astype(
        np.float32)).to(dt).cuda()
        for n, s in ((bh, sq), (bh // g, sk), (bh // g, sk)))
    kernel.reset_launches()
    got = fk.flash_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    route = "wgmma" if dtype == "bfloat16" else "simt"
    assert kernel.LAUNCHES["flash_fwd"] == 1
    assert kernel.LAUNCHES[f"flash_fwd/{route}"] == 1
    assert sum(kernel.LAUNCHES[f"flash_fwd/{r}"] for r in fk.ROUTES) == 1
    tiles = f_twin.simt_tiles(-(-d // 4) * 4, bh, sq) \
        if route == "simt" else None
    want = f_twin.flash_fwd(q, k, v, causal=causal, window=window,
                            tiles=tiles)
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    with pytest.raises(RuntimeError, match="only the kernel runs"):
        f_ops.flash_attention(q[None], k[None], v[None], backend="torch")


@pytest.mark.cuda
def test_flash_binding_refuses_what_a_route_does_not_take(kernel):
    q = torch.zeros((2, 64, 64), device="cuda")
    with pytest.raises(ValueError, match="route wgmma takes"):
        kernel.build().flash_fwd(q, q, q, True, 0, "wgmma", 64)
    b = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="route simt takes"):
        kernel.build().flash_fwd(b, b, b, True, 0, "simt", 64)
    b40 = torch.zeros((2, 64, 40), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernel.build().flash_fwd(b40, b40, b40, True, 0, "wgmma", 40)
    f6 = torch.zeros((2, 64, 6), device="cuda")
    with pytest.raises(ValueError, match="multiple of 4"):
        kernel.build().flash_fwd(f6, f6, f6, True, 0, "simt", 6)
    for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        big = torch.zeros((2, 64, 193), device="cuda", dtype=dtype)
        with pytest.raises(ValueError,
                           match=r"head dim must be in \[1, 192\]"):
            kernel.build().flash_fwd(big, big, big, True, 0, route, 193)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "logistic"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 132 * 1024, 132 * 1024 + 1,
                               1024 * 784])
def test_grid_starts_match_twin_at_the_ends(kernel, n, kind):
    """The starts kernel (two threads an element up to 132 x 1024
    elements, one above) against its plain version bit for bit, with
    indices at 0, 1, K - 1 and K among random ones, mu over [-8, 8] and
    sigma over [1e-3, 30]."""
    rng = np.random.default_rng(n)
    for lat_bits, precision in ((10, 16), (8, 12)):
        k = 1 << lat_bits
        idx = rng.integers(0, k + 1, n)
        idx[:4] = (0, 1, k - 1, k)[:n]
        mu = rng.uniform(-8.0, 8.0, n).astype(np.float32)
        sigma = np.exp(rng.uniform(np.log(1e-3), np.log(30.0), n)) \
            .astype(np.float32)
        args = [torch.from_numpy(a).reshape(1, n)
                for a in (idx.astype(np.int32), mu, sigma)]
        e = discretize.edge_table(lat_bits, "cpu")
        want = twin.grid_starts(*args, e, lat_bits, precision, kind)
        got = kernel.grid_starts(*(a.cuda() for a in args), e.cuda(),
                                 lat_bits, precision, kind)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _adversarial_push(lanes, steps, precision, seed):
    """Pushes at the edges of the kernel's reciprocal division: freq 1
    and 2^precision (where freq << (32 - precision) wraps to 0) among
    random ones, starts with start + freq <= 2^precision, and heads
    within 2^12 of 2^32."""
    rng = np.random.default_rng(seed)
    total = 1 << precision
    pick = rng.random((steps, lanes))
    freq = np.where(pick < 0.2, 1, np.where(
        pick < 0.4, total, rng.integers(1, total + 1, (steps, lanes))))
    start = rng.integers(0, total - freq + 1)
    head = (1 << 32) - 1 - rng.integers(0, 1 << 12, lanes)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return torch.from_numpy(head.astype(np.int64)), i32(start), i32(freq)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [12, 16])
@pytest.mark.parametrize("lanes,steps", [(1, 1), (33, 300), (4096, 784)])
def test_push_kernel_matches_twin_on_adversarial_inputs(kernel, lanes,
                                                        steps, precision):
    """Bit for bit, across tiles of the staged ring and lanes past a
    block's 32."""
    head, start, freq = _adversarial_push(lanes, steps, precision,
                                          lanes + steps + precision)
    got = kernel.push_emit(head.cuda(), start.cuda(), freq.cuda(),
                           precision)
    want = twin.push_emit(head, start, freq, precision)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))
    with pytest.raises(ValueError, match="precision must be in"):
        kernel.push_emit(head.cuda(), start.cuda(), freq.cuda(), 17)


def _grid_edges(lanes, steps, lat_bits, seed):
    """Grid-pop inputs at the edges: heads near 2^32 and heads whose
    first slot is 0 or 2^16 - 1, mu over [-8, 8] and sigma log-uniform
    over [1e-3, 30] with each range's ends, on the CPU."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1 << 16, 1 << 32, lanes, dtype=np.int64)
    head[::4] = (1 << 32) - 1 - rng.integers(0, 1 << 12, len(head[::4]))
    head[1::4] = head[1::4] & ~0xFFFF
    head[2::4] = head[2::4] | 0xFFFF
    mu = rng.uniform(-8.0, 8.0, (steps, lanes))
    mu[0, :2] = (-8.0, 8.0)[:lanes]
    sigma = np.exp(rng.uniform(np.log(1e-3), np.log(30.0), (steps, lanes)))
    sigma[1 % steps, :2] = (1e-3, 30.0)[:lanes]
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    return (torch.from_numpy(head), f32(mu), f32(sigma),
            torch.from_numpy(rng.integers(0, 1 << 16, (steps, lanes))
                             .astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "logistic"])
@pytest.mark.parametrize("lanes,steps,lat_bits", [
    (1, 40, 10), (3, 40, 10), (32, 392, 10), (130, 40, 12), (4101, 40, 10),
    (64, 40, 1), (64, 40, 2), (64, 40, 3), (64, 40, 4), (33, 40, 8),
    (512, 40, 10), (513, 40, 10), (1024, 40, 10), (1025, 40, 10),
    (1025, 40, 1), (1025, 40, 2), (1025, 40, 3), (1025, 40, 12)])
def test_grid_pop_group_walk_matches_twin(kernel, kind, lanes, steps,
                                          lat_bits):
    """The grid pop's group walk, bit for bit, at both group widths (the
    launcher takes 32 threads a lane up to 1024 gaussian or 512 logistic
    lanes, 16 above), lat_bits from 1 (one round over all points) to 12,
    and lane counts off the blocks' sizes."""
    head, mu, sigma, feed = _grid_edges(lanes, steps, lat_bits,
                                        lanes + steps + lat_bits)
    e = discretize.edge_table(lat_bits, "cpu")
    want = twin.pop_grid_emit(head, mu, sigma, feed, e, kind, lat_bits, 16)
    g = [t.cuda() for t in (head, mu, sigma, feed)]
    kernel.reset_launches()
    got = kernel.pop_grid_emit(*g[:4], e.cuda(), kind, lat_bits, 16)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES[f"pop_grid_emit/{kind}"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("lat_bits,precision", [(0, 16), (10, 16), (16, 16),
                                                (8, 12), (12, 12)])
@pytest.mark.parametrize("lanes,steps", [
    (1, 392), (3, 392), (32, 392), (33, 392), (1024, 392), (4101, 392),
    (1, 40), (33, 40), (1024, 40), (4101, 40), (32, 1), (33, 17)])
def test_uniform_pop_matches_twin(kernel, lanes, steps, lat_bits, precision):
    """The uniform grid pop, bit for bit, at lane counts off its blocks of
    32 and step counts off its tiles: at lat_bits 0 no lane reads, at
    lat_bits 16 (precision 16) every lane reads at every step, down to
    the feed's last row, and in between lanes read at their own steps."""
    head, _, _, feed = _grid_edges(lanes, steps, 10, lanes + steps + lat_bits)
    args = (None, None, feed, None, "uniform", lat_bits, precision)
    want = twin.pop_grid_emit(head, *args)
    if lat_bits == 0:
        assert int(want[2].max()) == 0
    if lat_bits == precision == 16:
        assert int(want[2].min()) == steps
    kernel.reset_launches()
    got = kernel.pop_grid_emit(head.cuda(), None, None, feed.cuda(), None,
                               *args[4:])
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["pop_grid_emit/uniform"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))


@pytest.mark.cuda
def test_uniform_pop_reads_past_its_feed_ring(kernel):
    """Lanes that read far apart: a head of 0 over a column of zero words
    stays 0 and reads at every step, while the other lanes read about
    every 1.6 steps, so the fast lanes run past the feed rows the kernel
    keeps in shared memory (128) and read device memory."""
    rng = np.random.default_rng(22)
    lanes, steps = 70, 700
    head = torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes,
                                         dtype=np.int64))
    feed = torch.from_numpy(rng.integers(0, 1 << 16, (steps, lanes))
                            .astype(np.int32))
    head[1::3] = 0
    feed[:, 1::3] = 0
    want = twin.pop_grid_emit(head, None, None, feed, None, "uniform", 10,
                              16)
    assert int(want[2][1::3].min()) - int(want[2][0::3].max()) > 128
    got = kernel.pop_grid_emit(head.cuda(), None, None, feed.cuda(), None,
                               "uniform", 10, 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("lat_bits", [10, 12])
@pytest.mark.parametrize("lanes", [1, 3, 32, 256, 1024, 1025, 4097])
def test_bucketize_group_walk_matches_twin(kernel, lanes, lat_bits):
    """The bucketize's group walk, bit for bit, at both group widths (32
    threads a lane up to 1024 lanes, 16 above: ``csrc/bucketize.cu``
    ``group_for``), lane counts off its blocks of 4 and 8 lanes, slots 0
    and 2^16 - 1 among random ones, mu out to +-8 and sigma from 1e-3 to
    30, each range's ends included."""
    from repro_torch.kernels.bucketize import kernel as bk
    from repro_torch.kernels.bucketize import twin as bk_twin

    rng = np.random.default_rng(7 * lanes + lat_bits)
    slot = rng.integers(0, 1 << 16, lanes)
    slot[::3] = 0
    slot[1::3] = (1 << 16) - 1
    mu = rng.uniform(-8.0, 8.0, lanes)
    mu[:2] = (-8.0, 8.0)[:lanes]
    sigma = np.exp(rng.uniform(np.log(1e-3), np.log(30.0), lanes))
    sigma[-2:] = (1e-3, 30.0)[-min(lanes, 2):]
    c = [torch.from_numpy(slot.astype(np.int32)),
         torch.from_numpy(mu.astype(np.float32)),
         torch.from_numpy(sigma.astype(np.float32))]
    e = discretize.edge_table(lat_bits, "cpu")
    kernel.reset_launches()
    got = bk.bucketize(*(t.cuda() for t in c), e.cuda(), lat_bits, 16)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["bucketize"] == 1
    want = bk_twin.bucketize(*c, e, lat_bits, 16)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _dyn_tables(rng, steps, lanes, a1, precision):
    """Non-decreasing per-step tables 0 .. 2^precision, some symbols of
    zero frequency."""
    w = rng.integers(1, 100, (steps, lanes, a1 - 1)) * \
        (rng.random((steps, lanes, a1 - 1)) > 0.2)
    w[..., 0] += 1
    cdf = np.floor(np.cumsum(w, -1) / w.sum(-1, keepdims=True)
                   * (1 << precision))
    t = np.concatenate([np.zeros((steps, lanes, 1)), cdf], -1)
    t[..., -1] = 1 << precision
    return torch.from_numpy(t.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,a1,steps", [
    (1, 3, 1), (32, 3, 784), (33, 3, 70), (4101, 3, 100), (32, 2, 70),
    (130, 13, 70), (64, 257, 37), (3, 401, 5), (4096, 2, 33)])
@pytest.mark.parametrize("precision", [12, 16])
def test_dyntable_kernel_matches_twin(kernel, lanes, a1, steps, precision):
    """The staged dyntable pop, bit for bit: A+1 from 2 to 257 (and 401,
    past the staging's width), steps off the staging tile, lanes off the
    block's 32."""
    rng = np.random.default_rng(lanes + a1 + steps + precision)
    head = torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes,
                                         dtype=np.int64))
    head[::3] = (1 << 32) - 1 - torch.from_numpy(
        rng.integers(0, 1 << 12, len(head[::3])))
    tables = _dyn_tables(rng, steps, lanes, a1, precision)
    feed = torch.from_numpy(rng.integers(0, 1 << 16, (steps, lanes))
                            .astype(np.int32))
    kernel.reset_launches()
    got = kernel.pop_dyntable_emit(head.cuda(), tables.cuda(), feed.cuda(),
                                   precision)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["pop_dyntable_emit"] == 1
    want = twin.pop_dyntable_emit(head, tables, feed, precision)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))


@pytest.mark.cuda
def test_dyntable_kernel_reads_past_its_feed_ring(kernel):
    """Lanes that read far apart: half the lanes pop 8 bits a step from
    uniform 256-symbol tables, half pop almost nothing from tables with
    one likely symbol, so the fast lanes run past the feed rows the
    kernel keeps in shared memory (256) and read device memory."""
    rng = np.random.default_rng(21)
    lanes, steps, a1 = 64, 700, 257
    uniform = np.arange(a1) * 256
    skewed = np.concatenate([np.arange(a1 - 1), [1 << 16]])
    tables = np.where((np.arange(lanes) % 2 == 0)[None, :, None],
                      uniform[None, None, :], skewed[None, None, :])
    tables = torch.from_numpy(np.broadcast_to(
        tables, (steps, lanes, a1)).astype(np.int32).copy())
    head = torch.from_numpy(rng.integers(1 << 16, 1 << 32, lanes,
                                         dtype=np.int64))
    feed = torch.from_numpy(rng.integers(0, 1 << 16, (steps, lanes))
                            .astype(np.int32))
    got = kernel.pop_dyntable_emit(head.cuda(), tables.cuda(), feed.cuda(),
                                   16)
    want = twin.pop_dyntable_emit(head, tables, feed, 16)
    assert int(want[2][0::2].min()) - int(want[2][1::2].max()) > 256
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().to(torch.int64), b.to(torch.int64))
