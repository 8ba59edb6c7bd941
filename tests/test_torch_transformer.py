"""The port's dense decoder (``repro_torch.models.{layers, attention,
transformer}``) against the JAX reference on the CPU, on the reference's
own weights carried across by ``weights.from_jax_params``.

Reduced configs (2 layers, width 64, head 16, vocab 300). At float32
compute the two packages differ only in summation order: logits within
2e-5. At bfloat16 they round at other places: the reference's own
tolerances for prefill against forward (0.1) and decode against forward
(0.15) (``tests/test_serving.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402

ARCHS = ["qwen2-0.5b", "smollm-360m", "mistral-nemo-12b"]
F32_TOL = 2e-5


def _cfgs(arch, compute="float32", vocab=300, **kw):
    ref = dataclasses.replace(ref_base.reduced(ref_base.get(arch)),
                              vocab=vocab, compute_dtype=compute, **kw)
    port = dataclasses.replace(base.reduced(base.get(arch)), vocab=vocab,
                               compute_dtype=compute, **kw)
    return ref, port


@functools.lru_cache(maxsize=None)
def _params(arch, seed=0):
    """The reference's params for the reduced ``arch`` (biases made
    non-zero, so the QKV bias is exercised) and the same in the port."""
    ref_cfg, _ = _cfgs(arch)
    with jax.threefry_partitionable(False):
        p = ref_transformer.init(jax.random.PRNGKey(seed), ref_cfg)
    p = jax.tree_util.tree_map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for name in ("wq", "wk", "wv"):
        leaf = p["blocks"]["attn"][name]
        if "b" in leaf:
            leaf["b"] = rng.normal(0, 0.5, leaf["b"].shape).astype(
                np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p), \
        weights.from_jax_params(p, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _toks(shape, vocab=300, seed=1):
    t = np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _draw(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).normal(0, scale, shape)
         .astype(np.float32))
    return jnp.asarray(x), torch.from_numpy(x)


def test_configs_and_reduced_match_the_reference():
    for arch in ("qwen2-0.5b", "smollm-360m", "mistral-nemo-12b",
                 "stablelm-12b"):
        ref, port = ref_base.get(arch), base.get(arch)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        assert ref.head_dim == port.head_dim
        assert ref.n_params() == port.n_params()
        assert dataclasses.asdict(ref_base.reduced(ref)) == \
            dataclasses.asdict(base.reduced(port))
    assert base.get("mistral-nemo-12b").head_dim == 128
    assert sorted(base.all_archs()) == ["mistral-nemo-12b", "qwen2-0.5b",
                                        "smollm-360m", "stablelm-12b"]


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    xj, xt = _draw((2, 5, 64), 0, 3.0)
    sj, st = _draw((64,), 1)
    p = {"scale": st, "bias": st * 0.5}
    pj = {"scale": sj, "bias": sj * 0.5}
    _close(layers.norm_apply(kind, p, xt),
           ref_layers.norm_apply(kind, pj, xj), 1e-5)
    out = layers.norm_apply(kind, p, xt.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_dense_and_mlps(compute):
    dt, jdt = getattr(torch, compute), getattr(jnp, compute)
    tol = F32_TOL if compute == "float32" else 2e-2
    xj, xt = _draw((2, 3, 16), 2)
    wj, wt = _draw((16, 4, 8), 3)
    bj, bt = _draw((4, 8), 4)
    got = layers.dense({"w": wt, "b": bt}, xt, dt)
    assert got.dtype == dt and got.shape == (2, 3, 4, 8)
    _close(got, ref_layers.dense({"w": wj, "b": bj}, xj, jdt), tol)
    for act in ("silu", "gelu"):
        pj = {k: {n: jnp.asarray(np.random.default_rng(5 + i).normal(
            0, 0.3, a.shape).astype(np.float32)) for n, a in v.items()}
            for i, (k, v) in enumerate(ref_layers.mlp_init(
                jax.random.PRNGKey(0), 16, 32, act).items())}
        pt = weights.from_jax_params(
            jax.tree_util.tree_map(np.asarray, pj), device="cpu")
        _close(layers.mlp_apply(pt, xt, act, dt),
               ref_layers.mlp_apply(pj, xj, act, jdt), tol)


def test_rope_and_embeddings():
    xj, xt = _draw((2, 7, 3, 16), 6)
    pos = np.random.default_rng(7).integers(0, 5000, (2, 7)).astype(
        np.int32)
    for theta in (1e4, 1e6):
        _close(layers.apply_rope(xt, torch.from_numpy(pos), theta),
               ref_layers.apply_rope(xj, jnp.asarray(pos), theta), 1e-5)
    tj, tt = _draw((300, 16), 8)
    ids_j, ids_t = _toks((2, 5))
    _close(layers.embed_apply({"table": tt}, ids_t, torch.float32),
           ref_layers.embed_apply({"table": tj}, ids_j, jnp.float32), 0)
    hj, ht = _draw((2, 5, 16), 9)
    _close(layers.unembed_apply({"table": tt}, ht, torch.float32),
           ref_layers.unembed_apply({"table": tj}, hj, jnp.float32),
           F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree_shapes_and_scales(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref = jax.tree_util.tree_map(np.asarray, _params(arch)[0])
    port = transformer.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    flat = lambda t, pre="": {
        k2: v2 for k, v in t.items()
        for k2, v2 in (flat(v, pre + k + ".").items()
                       if isinstance(v, dict) else [(pre + k, v)])}
    fr, fp = flat(ref), flat(port)
    assert sorted(fr) == sorted(fp)
    for name, a in fr.items():
        assert tuple(fp[name].shape) == a.shape, name
        assert fp[name].dtype == torch.float32
    w = fp["blocks.attn.wq.w"]           # [L, d, H, dh]: fan = H
    assert abs(float(w.std()) * w.shape[-2] ** 0.5 - 0.88) < 0.05
    assert float(w.abs().max()) <= 2.0 / w.shape[-2] ** 0.5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_the_reference(arch, compute):
    ref_cfg, cfg = _cfgs(arch, compute)
    pj, pt = _params(arch)
    tol_pre, tol_dec = (F32_TOL, F32_TOL) if compute == "float32" \
        else (0.1, 0.15)
    s, extra = 9, 3
    tj, tt = _toks((2, s + extra))
    want, _ = ref_transformer.forward(pj, ref_cfg, tj)
    got, aux = transformer.forward(pt, cfg, tt)
    assert aux == 0.0 and got.shape == want.shape
    _close(got, want, tol_pre)

    lj, sj = ref_transformer.prefill(pj, ref_cfg, {"tokens": tj[:, :s]},
                                     s + extra)
    lt, st = transformer.prefill(pt, cfg, {"tokens": tt[:, :s]}, s + extra)
    assert st["cache_len"] == int(sj["cache_len"]) == s
    _close(lt, lj, tol_pre)
    if compute == "float32":   # a bfloat16 cache differs by its ulps
        _close(st["k"], sj["k"], tol_pre)
    for t in range(s, s + extra):
        lj, sj = ref_transformer.decode_step(pj, ref_cfg, tj[:, t:t + 1],
                                             sj)
        lt, st = transformer.decode_step(pt, cfg, tt[:, t:t + 1], st)
        _close(lt, lj, tol_dec)
    assert st["cache_len"] == s + extra


def test_prefill_of_2100_tokens_runs_blockwise_and_matches():
    """At 2100 tokens (above ``BLOCKWISE_THRESHOLD``) both prefills attend
    blockwise: the reference through its jnp online softmax, the port
    through the flash kernel's plain version. The caches are held to
    1e-3: at positions in the thousands, XLA's and torch's sin and cos of
    angles of thousands of radians differ in their last bits (the same
    difference shows at 2047 tokens, below the threshold)."""
    arch = "qwen2-0.5b"
    ref_cfg, cfg = _cfgs(arch)
    pj, pt = _params(arch)
    s = 2100
    assert s >= attention.BLOCKWISE_THRESHOLD == \
        ref_attention.BLOCKWISE_THRESHOLD
    tj, tt = _toks((1, s), seed=3)
    lj, sj = ref_transformer.prefill(pj, ref_cfg, {"tokens": tj}, s + 2)
    lt, st = transformer.prefill(pt, cfg, {"tokens": tt}, s + 2)
    _close(lt, lj, 1e-4)
    _close(st["v"][:, :, :s], sj["v"][:, :, :s], 1e-3)
    nj, nt = _toks((1, 1), seed=4)
    _close(transformer.decode_step(pt, cfg, nt, st)[0],
           ref_transformer.decode_step(pj, ref_cfg, nj, sj)[0], 1e-4)


def test_stablelm_head_dim_160_prefill_of_2100_tokens_matches(monkeypatch):
    """stablelm-12b's head dim (160: d_model 5120 over 32 heads) at
    reduced width: a 2100-token prefill attends blockwise, the port
    through the flash kernel's plain version on 64-key tiles (the
    tensor-core kernel's tile above D 128), the reference through its jnp
    online softmax. Each blockwise path is held to its own package's
    exact softmax at float32's ``F32_TOL``. The two packages' last-token
    logits (up to 0.57) differ by up to 2e-4 (1.6e-4 here), and by as
    much where neither attends blockwise: the gap is between the two
    packages' float32 layers (it grows with the head dim and the depth:
    3e-6 at head dim 16), not in the D-160 attention path."""
    from repro_torch.kernels import dispatch

    ref_cfg, cfg = _cfgs("stablelm-12b", d_head=160)
    assert cfg.head_dim == ref_cfg.head_dim == 160
    with jax.threefry_partitionable(False):
        p = ref_transformer.init(jax.random.PRNGKey(0), ref_cfg)
    p = jax.tree_util.tree_map(np.asarray, p)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = weights.from_jax_params(p, device="cpu")
    s = 2100
    tj, tt = _toks((1, s), seed=5)
    lj, _ = ref_transformer.prefill(pj, ref_cfg, {"tokens": tj}, s)
    lt, _ = transformer.prefill(pt, cfg, {"tokens": tt}, s)
    with dispatch.use_backend("ref"):
        exact, _ = transformer.prefill(pt, cfg, {"tokens": tt}, s)
    monkeypatch.setattr(ref_attention, "BLOCKWISE_THRESHOLD", s + 1)
    lj_exact, _ = ref_transformer.prefill(pj, ref_cfg, {"tokens": tj}, s)
    _close(lt, exact, F32_TOL)
    _close(lj, lj_exact, F32_TOL)
    _close(lt, lj, 2e-4)
    _close(exact, lj_exact, 2e-4)


@pytest.mark.parametrize("start", ["prefill", "empty"])
def test_int8_kv_cache_matches_the_reference(start):
    arch = "qwen2-0.5b"
    ref_cfg, cfg = _cfgs(arch, kv_cache_dtype="int8")
    pj, pt = _params(arch)
    tj, tt = _toks((2, 8), seed=5)
    if start == "prefill":
        lj, sj = ref_transformer.prefill(pj, ref_cfg, {"tokens": tj[:, :5]},
                                         8)
        lt, st = transformer.prefill(pt, cfg, {"tokens": tt[:, :5]}, 8)
        _close(lt, lj, F32_TOL)
        t0 = 5
    else:
        sj = ref_transformer.init_decode_state(ref_cfg, 2, 8)
        st = transformer.init_decode_state(cfg, 2, 8, device="cpu")
        t0 = 0
    assert st["k"].dtype == torch.int8
    for t in range(t0, 8):
        lj, sj = ref_transformer.decode_step(pj, ref_cfg, tj[:, t:t + 1],
                                             sj)
        lt, st = transformer.decode_step(pt, cfg, tt[:, t:t + 1], st)
        _close(lt, lj, 1e-4)
    np.testing.assert_array_equal(
        np.abs(st["k"].numpy().astype(int) - np.asarray(sj["k"], int))
        .max() <= 1, True)
    _close(st["kv_scales"], sj["kv_scales"], 1e-6)


def test_quantize_kv_matches_the_reference():
    xj, xt = _draw((3, 4, 2, 16), 10, 2.0)
    qj, sj = ref_attention.quantize_kv(xj)
    qt, stt = attention.quantize_kv(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    _close(stt, sj, 0)
    _close(attention.dequantize_kv(qt, stt, torch.float32),
           ref_attention.dequantize_kv(qj, sj, jnp.float32), 0)


def test_layer_windows_match_the_reference():
    for kw in ({}, {"sliding_window": 32},
               {"sliding_window": 32, "global_attn_every": 3}):
        ref_cfg, cfg = _cfgs("qwen2-0.5b", **kw)
        assert transformer.layer_windows(cfg, 7) == \
            [int(w) for w in ref_transformer.layer_windows(ref_cfg, 7)]
        m = transformer._dyn_mask(9, 9, 4, device="cpu")
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(ref_transformer._dyn_mask(9, 9, 4)))


@pytest.mark.parametrize("kw", [{"n_experts": 4}, {"mixer": "rwkv6"},
                                {"mixer": "hymba"}, {"enc_dec": True},
                                {"rope_kind": "mrope"}])
def test_other_families_name_their_roadmap_item(kw):
    _, cfg = _cfgs("qwen2-0.5b", **kw)
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        transformer.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
