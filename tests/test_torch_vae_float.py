"""The port's float VAE, its BB-ANS codec, AdamW and the compressor
baselines against the JAX reference.

The network is float32 matmuls, which torch's CPU kernels and XLA's do
not sum in the same order, so the model is held to the reference within
float32 tolerances and the codec to the reference's *rate*; the port's
eager and compiled codecs write the same bytes as each other."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as ref_codecs  # noqa: E402
from repro.data import baselines as ref_baselines  # noqa: E402
from repro.models import vae as ref_vae  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch import codecs, weights  # noqa: E402
from repro_torch.codecs import combinators  # noqa: E402
from repro_torch.data import baselines  # noqa: E402
from repro_torch.models import vae  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

port_compile = importlib.import_module("repro_torch.codecs.compile")

SMALL = dict(input_dim=36, hidden=24, latent=6)
# float32 networks summed in another order: relative 1e-5 on values of
# order 1-100, absolute 1e-4 near zero.
RTOL, ATOL = 1e-5, 1e-4


def _ref_params(cfg_r, seed=0):
    with jax.threefry_partitionable(False):
        return ref_vae.init(jax.random.PRNGKey(seed), cfg_r)


def _port_params(ref_params):
    return weights.from_jax_params(
        {k: {n: np.asarray(v) for n, v in p.items()}
         for k, p in ref_params.items()}, device="cpu")


def _flat(tree, prefix=""):
    """{"layer.leaf": numpy array} of a nested dict of either package."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if hasattr(v, "detach")
                                         else v)
    return out


def _data(shape, seed=5):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)


@pytest.mark.parametrize("full_width", [False, True])
def test_encode_decode_elbo_match_reference(full_width):
    cfg_r = ref_vae.paper_config("bernoulli") if full_width \
        else ref_vae.VAEConfig(**SMALL)
    cfg = vae.paper_config("bernoulli") if full_width \
        else vae.VAEConfig(**SMALL)
    rp = _ref_params(cfg_r, seed=3)
    pp = _port_params(rp)
    s = _data((7, cfg.input_dim))
    mu_r, sg_r = ref_vae.encode(rp, cfg_r, jnp.asarray(s))
    mu, sg = vae.encode(pp, cfg, torch.from_numpy(s))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), RTOL, ATOL)
    np.testing.assert_allclose(sg.numpy(), np.asarray(sg_r), RTOL, ATOL)
    y = np.random.default_rng(1).normal(size=(7, cfg.latent)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        vae.decode(pp, cfg, torch.from_numpy(y)).numpy(),
        np.asarray(ref_vae.decode(rp, cfg_r, jnp.asarray(y))), RTOL, ATOL)
    key = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(key, mu_r.shape))
    want = np.asarray(ref_vae.elbo(rp, cfg_r, key, jnp.asarray(s)))
    got = vae.elbo(pp, cfg, None, torch.from_numpy(s),
                   eps=torch.from_numpy(eps)).numpy()
    np.testing.assert_allclose(got, want, 1e-5, 1e-3)
    bpd = float(vae.elbo_bits_per_dim(pp, cfg, None, torch.from_numpy(s),
                                      eps=torch.from_numpy(eps)))
    assert bpd == pytest.approx(float(ref_vae.elbo_bits_per_dim(
        rp, cfg_r, key, jnp.asarray(s))), rel=1e-5)


def test_network_bits_do_not_depend_on_input_layout():
    """A lowered pop hands the network a transposed view; the model gives
    it the bits of the row-major input (on the card cuBLAS would take
    another kernel for a transposed operand)."""
    cfg = vae.VAEConfig(**SMALL)
    pp = _port_params(_ref_params(ref_vae.VAEConfig(**SMALL), seed=5))
    s = torch.from_numpy(_data((36, 9), seed=3)).T
    for a, b in zip(vae.encode(pp, cfg, s), vae.encode(pp, cfg,
                                                       s.contiguous())):
        assert torch.equal(a, b)
    y = torch.from_numpy(np.random.default_rng(2).normal(
        size=(6, 9)).astype(np.float32)).T
    assert torch.equal(vae.decode(pp, cfg, y),
                       vae.decode(pp, cfg, y.contiguous()))


def test_elbo_gradient_matches_reference():
    cfg_r, cfg = ref_vae.VAEConfig(**SMALL), vae.VAEConfig(**SMALL)
    rp = _ref_params(cfg_r, seed=4)
    s = _data((9, 36), seed=2)
    key = jax.random.PRNGKey(2)
    eps = np.array(jax.random.normal(key, (9, 6)))
    g_r = jax.grad(ref_vae.loss)(rp, cfg_r, key, jnp.asarray(s))
    live = adamw.tree_map(lambda t: t.requires_grad_(True), _port_params(rp))
    loss = vae.loss(live, cfg, None, torch.from_numpy(s),
                    eps=torch.from_numpy(eps))
    grads = iter(torch.autograd.grad(loss, adamw.tree_leaves(live)))
    got = _flat(adamw.tree_map(lambda _: next(grads), live))
    want = _flat(g_r)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], 1e-4, 1e-5, err_msg=k)


def test_make_bb_codec_round_trip_eager_equals_compiled_and_rate():
    """BBX1 over a chain of 4 datapoints at 8 lanes, (36, 24, 6) on the
    reference's init weights: lossless, the compiled codec writes the
    eager codec's bytes, and bits/dim within 6% of the reference's. The
    logits differ from the reference's in their last bits, so now and
    then a bucket differs and the bits-back path moves; a moved path
    changes the rate about as much as another seed does, which at this
    size is a few percent (most seeds give the reference's very
    bytes)."""
    cfg_r, cfg = ref_vae.VAEConfig(**SMALL), vae.VAEConfig(**SMALL)
    rp = _ref_params(cfg_r)
    data = _data((4, 8, 36), seed=9)
    kw = dict(lanes=8, seed=0, init_chunks=16)
    with jax.threefry_partitionable(False):
        want = ref_codecs.compress(
            ref_codecs.Chained(ref_vae.make_bb_codec(rp, cfg_r), 4),
            jnp.asarray(data), **kw)
    eager = codecs.Chained(vae.make_bb_codec(_port_params(rp), cfg), 4)
    fused = codecs.compile(eager)
    assert isinstance(fused.lowered, combinators.Chained)
    blob = codecs.compress(fused, data, device="cpu", **kw)
    assert blob == codecs.compress(eager, data, device="cpu", **kw)
    np.testing.assert_array_equal(
        codecs.decompress(fused, blob, device="cpu").numpy(), data)
    np.testing.assert_array_equal(
        codecs.decompress(eager, blob, device="cpu").numpy(), data)
    assert len(blob) == pytest.approx(len(want), rel=0.06)


def test_compiled_float_bbans_lowers_its_leaves_per_call():
    cfg = vae.VAEConfig(**SMALL)
    pp = _port_params(_ref_params(ref_vae.VAEConfig(**SMALL)))
    lowered = codecs.compile(vae.make_bb_codec(pp, cfg)).lowered
    assert isinstance(lowered, combinators.BBANS)
    assert isinstance(lowered.prior, port_compile._GridRepeat)
    s = torch.from_numpy(_data((3, 36)))
    assert lowered.posterior(s).kind == "gaussian"
    idx = torch.zeros((3, 6), dtype=torch.int32)
    assert isinstance(lowered.likelihood(idx), port_compile._TableRepeat)


def test_beta_binomial_is_refused_with_its_roadmap_item():
    cfg = vae.paper_config("beta_binomial")
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        vae.make_bb_codec({}, cfg)
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        vae.decode({}, cfg, torch.zeros((1, 50)))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_steps_match_reference(weight_decay):
    """Five AdamW steps under cosine_lr on a two-layer tree, the gradients
    large enough that the global-norm clip binds on some steps."""
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (5, 3), "b": (3,)}, "c": {"w": (3, 2)}}
    params = {k: {n: rng.normal(size=sh).astype(np.float32)
                  for n, sh in v.items()} for k, v in shapes.items()}
    sched_r = ref_adamw.cosine_lr(1e-2, 2, 5)
    sched = adamw.cosine_lr(1e-2, 2, 5)
    opt_r = ref_adamw.AdamW(learning_rate=sched_r,
                            weight_decay=weight_decay)
    opt = adamw.AdamW(learning_rate=sched, weight_decay=weight_decay)
    p_r = jax.tree_util.tree_map(jnp.asarray, params)
    p = adamw.tree_map(torch.from_numpy, params)
    st_r, st = opt_r.init(p_r), opt.init(p)
    for step in range(5):
        g = {k: {n: (rng.normal(size=sh) * (0.2 + step)).astype(np.float32)
                 for n, sh in v.items()} for k, v in shapes.items()}
        p_r, st_r = opt_r.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 st_r, p_r)
        p, st = opt.update(adamw.tree_map(torch.from_numpy, g), st, p)
        got, want = _flat(p), _flat(p_r)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], 1e-6, 1e-7,
                                       err_msg=k)
    assert st.step == int(st_r.step) == 5
    for step in (0, 1, 2, 3, 5, 9):
        assert float(sched(step)) == pytest.approx(
            float(sched_r(jnp.asarray(step))), rel=1e-6, abs=1e-12)
    assert float(adamw.global_norm(p)) == pytest.approx(
        float(ref_adamw.global_norm(p_r)), rel=1e-6)


@pytest.mark.parametrize("binary", [True, False])
def test_baseline_rates_equal_the_reference(binary):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 2 if binary else 256, (6, 784)).astype(np.uint8)
    want = ref_baselines.baseline_rates(imgs, binary, with_png=True)
    assert baselines.baseline_rates(imgs, binary, with_png=True) == want
