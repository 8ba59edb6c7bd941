"""The port's flash-attention forward (``repro_torch.kernels.flash``) and
``attention.sdpa_blockwise`` against the JAX reference on the CPU.

The plain version (``twin.py``, the CPU path and what the CUDA kernel is
held to on the card) and the exact-SDPA oracle (``ref.py``) are held to
the Pallas kernel in interpret mode and to its oracle at
``tests/test_kernels.py``'s five shapes, with that test's tolerances
(float32 2e-5, bfloat16 2e-2: the float32 sums run in another order).
The plain version is also held to the Pallas kernel at the kernels' own
tiles (``twin.BLOCK_Q``, ``twin.BLOCK_K``: 128 keys a softmax update, so
bfloat16 ``p`` is rounded against the same maxima) over several key
tiles, and at the float32 kernel's tiles (``twin.simt_tiles``) over head
dims 8-192 and GQA groups 1, 4 and 7, and the wrapper's zero-padding of
the head dim (both routes') against the oracle. The model-layout wrapper and
``sdpa_blockwise`` are held to the reference's in the GQA layout. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 14).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash import kernel as ref_kernel  # noqa: E402
from repro.kernels.flash import ops as ref_ops  # noqa: E402
from repro.kernels.flash import ref as ref_ref  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash import ops, ref, twin  # noqa: E402
from repro_torch.models import attention  # noqa: E402

SHAPES = [
    (64, 64, 16, True, 0, "float32"),
    (128, 128, 32, True, 40, "float32"),
    (96, 160, 16, False, 0, "float32"),
    (100, 84, 8, True, 0, "float32"),     # non-multiples of a block
    (64, 64, 16, True, 0, "bfloat16"),
]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _pair(shape, dtype, seed):
    """The same numpy draw as a JAX array and a torch tensor of ``dtype``
    (bfloat16 rounds once, identically, on both sides)."""
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(dtype), t


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("sq,sk,d,causal,window,dtype", SHAPES)
def test_twin_and_ref_match_the_pallas_kernel_and_its_oracle(
        sq, sk, d, causal, window, dtype):
    bh = 3
    (qj, q), (kj, k), (vj, v) = (
        _pair((bh, n, d), dtype, sq + sk + i)
        for i, n in enumerate((sq, sk, sk)))
    want = ref_kernel.flash_fwd(qj, kj, vj, causal=causal, window=window,
                                block_q=32, block_k=32, interpret=True)
    oracle = ref_ref.flash_ref(qj, kj, vj, causal=causal, window=window)
    got = twin.flash_fwd(q, k, v, causal=causal, window=window)
    exact = ref.flash_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = _tol(dtype)
    for a, b in ((got, want), (exact, oracle), (got, oracle)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0)])
def test_twin_matches_the_pallas_kernel_at_the_kernels_tiles(
        causal, window, dtype):
    bh, s, d = 2, 300, 64
    (qj, q), (kj, k), (vj, v) = (_pair((bh, s, d), dtype, 70 + i)
                                 for i in range(3))
    want = ref_kernel.flash_fwd(qj, kj, vj, causal=causal, window=window,
                                block_q=twin.BLOCK_Q, block_k=twin.BLOCK_K,
                                interpret=True)
    got = twin.flash_fwd(q, k, v, causal=causal, window=window)
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (150, 150, True, 0),       # ragged against the query and key tiles
    (150, 150, True, 40),
    (100, 170, False, 0),      # Sq != Sk
])
@pytest.mark.parametrize("g", [1, 4, 7])
@pytest.mark.parametrize("d", [8, 64, 100, 160, 192])
def test_twin_matches_the_pallas_kernel_at_the_simt_tiles(d, g, sq, sk,
                                                           causal, window):
    """The plain version on the float32 kernel's tiles (``simt_tiles``:
    the query tile it takes on a small grid and, up to D 64, on a grid
    that fills the card) against the Pallas kernel in interpret mode on
    the same tiles, with the key heads repeated for it (it has no GQA),
    at the Pallas kernel test's float32 tolerance."""
    (qj, q), (kj, k), (vj, v) = (
        _pair((n, s, d), "float32", d + g + s + i)
        for i, (n, s) in enumerate(((g, sq), (1, sk), (1, sk))))
    kr, vr = (jnp.repeat(t, g, axis=0) for t in (kj, vj))
    for tiles in {twin.simt_tiles(d, g, sq),
                  twin.simt_tiles(d, twin.SIMT_WIDE_GRID, sq)}:
        want = ref_kernel.flash_fwd(qj, kr, vr, causal=causal,
                                    window=window, block_q=tiles[0],
                                    block_k=tiles[1], interpret=True)
        got = twin.flash_fwd(q, k, v, causal=causal, window=window,
                             tiles=tiles)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=2e-5)


def test_simt_tiles_follow_the_head_dim_and_the_grid():
    wide = twin.SIMT_WIDE_GRID
    assert twin.simt_tiles(64, wide, 128) == (128, 64)
    assert twin.simt_tiles(64, wide, 127) == (128, 64)
    assert twin.simt_tiles(64, wide - 1, 128) == (64, 64)
    assert twin.simt_tiles(68, wide, 4096) == (64, 64)
    assert [twin.simt_tiles(d, 1, 1)[1] for d in (4, 128, 160, 164, 192)] \
        == [64, 64, 64, 32, 32]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 24, 40])
def test_zero_padded_head_dim_matches_the_oracle(d, dtype):
    """The tensor-core route's tiles take D in multiples of 16: the
    wrapper pads q, k, v with zero columns and passes the true D for the
    scale, which leaves the kept columns' function unchanged."""
    bh, s = 3, 150
    q, k, v = (_pair((bh, s, d), dtype, 90 + d + i)[1] for i in range(3))
    qp, kp, vp = flash_kernel.pad_head_dim(q, k, v)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == -(-d // 16) * 16
    assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    got = twin.flash_fwd(qp, kp, vp, causal=True, window=40,
                         head_dim=d)[..., :d]
    want = ref.flash_ref(q, k, v, causal=True, window=40)
    tol = _tol(dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [1, 6, 99])
def test_float32_route_pads_the_head_dim_to_four(d):
    """The float32 kernel loads 16-byte pieces of rows: the wrapper pads D
    to a multiple of 4 (``PAD["simt"]``) with zero columns, and the plain
    version on the padded heads, at the true D's scale, keeps the
    oracle's function."""
    bh, s = 2, 130
    q, k, v = (_pair((bh, s, d), "float32", 40 + d + i)[1]
               for i in range(3))
    qp, kp, vp = flash_kernel.pad_head_dim(q, k, v, flash_kernel.PAD["simt"])
    assert qp.shape[-1] == -(-d // 4) * 4
    assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    got = twin.flash_fwd(qp, kp, vp, causal=True, window=0, head_dim=d,
                         tiles=twin.simt_tiles(qp.shape[-1], bh, s))[..., :d]
    want = ref.flash_ref(q, k, v, causal=True, window=0)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_the_dtype_picks_the_kernel_route():
    assert flash_kernel.route(torch.bfloat16) == "wgmma"
    assert flash_kernel.route(torch.float32) == "simt"
    with pytest.raises(ValueError, match="no route"):
        flash_kernel.route(torch.float16)
    q = torch.zeros((1, 4, 32))
    assert flash_kernel.pad_head_dim(q, q, q)[0] is q


@pytest.mark.parametrize("backend", ["torch", "ref"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_gqa_layout_wrapper_matches_the_reference(backend, causal, window):
    b, s, hq, hkv, dh = 2, 150, 4, 2, 16
    (qj, q), (kj, k), (vj, v) = (
        _pair((b, s, h, dh), "float32", 11 + i)
        for i, h in enumerate((hq, hkv, hkv)))
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal,
                                   window=window, block_q=32, block_k=32)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              backend=backend)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,window,dtype", [
    (300, None, "float32"),        # causal, ragged against every tile
    (257, 40, "float32"),          # windowed
    (2100, 1 << 30, "float32"),    # the model's global window, blockwise
    (300, 64, "bfloat16"),
])
def test_sdpa_blockwise_matches_the_reference(sq, window, dtype):
    b, hq, hkv, dh = 1, 4, 2, 16
    (qj, q), (kj, k), (vj, v) = (
        _pair((b, sq, h, dh), dtype, sq + i)
        for i, h in enumerate((hq, hkv, hkv)))
    want = ref_attention.sdpa_blockwise(qj, kj, vj, causal=True,
                                        window=window)
    got = attention.sdpa_blockwise(q, k, v, causal=True, window=window)
    assert got.dtype == v.dtype and got.shape == q.shape
    # The reference rounds its scores and p . v blocks to bfloat16 in a
    # bfloat16 model (einsum outputs); the kernel's function keeps them in
    # float32 (the Pallas kernel's preferred_element_type), hence 4e-2.
    tol = 4e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_twin_visits_only_the_tiles_the_masks_leave():
    bq, bk = twin.BLOCK_Q, twin.BLOCK_K
    assert twin.kv_tiles(0, bq, 4096, True, 0) == (0, bq // bk)
    assert twin.kv_tiles(3 * bq, 4 * bq, 4096, True, 0) == (0, 4 * bq // bk)
    assert twin.kv_tiles(3 * bq, 4 * bq, 4096, False, 0) == (0, 4096 // bk)
    lo, hi = twin.kv_tiles(20 * bq, 21 * bq, 4096, True, 1024)
    assert lo == (20 * bq - 1023) // bk and hi == 21 * bq // bk


def test_sdpa_blockwise_is_forward_only():
    q = torch.zeros((1, 8, 2, 4), requires_grad=True)
    k = v = torch.zeros((1, 8, 2, 4))
    with pytest.raises(NotImplementedError, match="item 6"):
        attention.sdpa_blockwise(q, k, v, causal=True)
    with torch.no_grad():
        assert attention.sdpa_blockwise(q, k, v, causal=True).shape == \
            q.shape


def test_the_card_runs_the_kernel_or_raises():
    q = torch.zeros((1, 8, 2, 4))
    with pytest.raises(RuntimeError, match="cuda backend"):
        ops.flash_attention(q, q, q, backend="cuda")
    assert dispatch.resolve("flash", torch.device("cpu")) == "torch"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 192])
def test_twin_at_head_dims_above_128_matches_the_oracles(d, dtype):
    """stablelm-12b's head dim (160) and the kernels' largest (192): the
    plain version, on 64-key tiles there (``twin.block_k``, the
    tensor-core kernel's tile at 192 padded columns), against the port's
    exact oracle and the reference's, GQA-free, causal with a window."""
    bh, s = 2, 200
    (qj, q), (kj, k), (vj, v) = (_pair((bh, s, d), dtype, d + i)
                                 for i in range(3))
    got = twin.flash_fwd(q, k, v, causal=True, window=150)
    tol = _tol(dtype)
    for want in (ref.flash_ref(q, k, v, causal=True, window=150),
                 ref_ref.flash_ref(qj, kj, vj, causal=True, window=150)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=tol)


def test_key_tile_follows_the_head_dim():
    assert [twin.block_k(d) for d in (8, 64, 128, 129, 160, 192)] == \
        [128, 128, 128, 64, 64, 64]
    assert twin.kv_tiles(256, 384, 4096, True, 0, 64) == (0, 6)
