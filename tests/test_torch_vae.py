"""The port's fixed-point VAE codec against the JAX reference: the
quantized network exactly, and the BB-ANS wire byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as ref_codecs  # noqa: E402
from repro.codecs import quantize as ref_quantize  # noqa: E402
from repro.models import vae as ref_vae  # noqa: E402
from repro_torch import codecs, weights  # noqa: E402
from repro_torch.models import vae  # noqa: E402

from tests.golden.make_torch_fixtures import VAE_PARAMS  # noqa: E402

SMALL = dict(input_dim=36, hidden=24, latent=6)


def _golden_params():
    flat = dict(np.load(VAE_PARAMS))
    nested = {}
    for key, v in flat.items():
        layer, leaf = key.rsplit(".", 1)
        nested.setdefault(layer, {})[leaf] = jnp.asarray(v)
    return flat, nested


def _data(shape, seed=1234):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)


@pytest.mark.parametrize("full_width", [False, True])
def test_fixed_point_network_matches_reference(full_width):
    if full_width:
        cfg_r = ref_vae.paper_config("bernoulli")
        cfg = vae.paper_config("bernoulli")
        with jax.threefry_partitionable(False):
            ref_params = ref_vae.init(jax.random.PRNGKey(3), cfg_r)
        flat = {f"{l}.{k}": np.asarray(v) for l, p in ref_params.items()
                for k, v in p.items()}
    else:
        cfg_r, cfg = ref_vae.VAEConfig(**SMALL), vae.VAEConfig(**SMALL)
        flat, ref_params = _golden_params()
    q_r, q = ref_quantize.QuantConfig(), codecs.QuantConfig()
    qp_r = ref_vae.quantize_model(ref_params, cfg_r, q_r)
    qp = vae.quantize_model(weights.from_jax_params(flat, device="cpu"), cfg,
                            q)
    s = _data((5, cfg.input_dim))
    mu_r, sg_r = ref_vae.encode_q(qp_r, cfg_r, q_r, jnp.asarray(s))
    mu, sg = vae.encode_q(qp, cfg, q, torch.from_numpy(s))
    np.testing.assert_array_equal(mu.numpy().view(np.uint32),
                                  np.asarray(mu_r).view(np.uint32))
    np.testing.assert_array_equal(sg.numpy().view(np.uint32),
                                  np.asarray(sg_r).view(np.uint32))
    idx = np.random.default_rng(5).integers(0, 1 << cfg.lat_bits,
                                            (5, cfg.latent)).astype(np.int32)
    f1_r = ref_vae.decode_freq1_q(qp_r, cfg_r, q_r, jnp.asarray(idx))
    f1 = vae.decode_freq1_q(qp, cfg, q, torch.from_numpy(idx))
    np.testing.assert_array_equal(f1.numpy(), np.asarray(f1_r))


def test_chain_wire_fused_eager_and_reference_agree():
    """(36, 24, 6), 4 lanes, a 3-image chain: the port's fused and eager
    codecs and the reference's fused codec write the same bytes."""
    flat, ref_params = _golden_params()
    cfg_r, cfg = ref_vae.VAEConfig(**SMALL), vae.VAEConfig(**SMALL)
    data = _data((3, 4, 36), seed=77)
    kw = dict(lanes=4, seed=0, init_chunks=16, capacity=512)
    with jax.threefry_partitionable(False):
        want = ref_codecs.compress(
            ref_codecs.compile(ref_codecs.Chained(
                ref_vae.make_bb_codec_q(ref_params, cfg_r), 3)),
            jnp.asarray(data), **kw)
    params = weights.from_jax_params(flat, device="cpu")
    eager = codecs.Chained(vae.make_bb_codec_q(params, cfg), 3)
    fused = codecs.compile(eager)
    got_fused = codecs.compress(fused, data, device="cpu", **kw)
    got_eager = codecs.compress(eager, data, device="cpu", **kw)
    assert got_fused.hex() == want.hex()
    assert got_eager.hex() == want.hex()
    back = codecs.decompress(fused, want, device="cpu")
    np.testing.assert_array_equal(back.numpy(), data)
    np.testing.assert_array_equal(
        codecs.decompress(eager, want, device="cpu").numpy(), data)


def test_full_width_round_trip_is_lossless():
    cfg = vae.paper_config("bernoulli")
    params = vae.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    codec = vae.make_bb_codec_q(params, cfg, compiled=True)
    data = _data((2, 784), seed=3)
    blob, info = codecs.compress(codec, data, lanes=2, seed=0,
                                 with_info=True, device="cpu")
    assert info["lanes"] == 2 and info["net_bits"] > 0
    np.testing.assert_array_equal(
        codecs.decompress(codec, blob, device="cpu").numpy(), data)


def test_one_lane_chain_matches_reference_eager_wire():
    """The reference's compiled path faults on some 1-lane shapes (ROADMAP
    H2), so the port's 1-lane wire is held to the reference's eager one;
    the port's fused and eager codecs agree at any lane count."""
    flat, ref_params = _golden_params()
    cfg = vae.VAEConfig(**SMALL)
    data = _data((2, 1, 36), seed=11)
    with jax.threefry_partitionable(False):
        want = ref_codecs.compress(
            ref_codecs.Chained(ref_vae.make_bb_codec_q(
                ref_params, ref_vae.VAEConfig(**SMALL)), 2),
            jnp.asarray(data), lanes=1, seed=4)
    params = weights.from_jax_params(flat, device="cpu")
    eager = codecs.Chained(vae.make_bb_codec_q(params, cfg), 2)
    blob = codecs.compress(codecs.compile(eager), data, lanes=1, seed=4,
                           device="cpu")
    assert blob.hex() == want.hex()
    assert blob == codecs.compress(eager, data, lanes=1, seed=4,
                                   device="cpu")
    np.testing.assert_array_equal(
        codecs.decompress(codecs.compile(eager), blob, device="cpu").numpy(),
        data)


def test_init_is_seeded_and_he_scaled():
    cfg = vae.paper_config("bernoulli")
    a = vae.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = vae.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in a)
    assert a["enc_h"]["w"].shape == (784, 100)
    assert a["dec_out"]["w"].shape == (100, 784)
    assert abs(float(a["enc_h"]["w"].std()) - (2 / 784) ** 0.5) < 0.003
    assert not torch.any(a["enc_h"]["b"])


def test_compile_refuses_what_it_does_not_lower():
    # A Repeat of Uniform leaves is lowered now, and writes the bytes of
    # the interpreted Repeat.
    rep = codecs.Repeat(lambda d: codecs.Uniform(4), 3)
    data = _data((2, 3), seed=9) * 7
    kw = dict(lanes=2, seed=0, init_chunks=0, device="cpu")
    assert codecs.compress(codecs.compile(rep), data, **kw) == \
        codecs.compress(rep, data, **kw)

    class Opaque(codecs.Codec):
        def push(self, stack, x):
            return stack

        def pop(self, stack):
            return stack, None

    # Every combinator the reference lowers is ported, so the refusal names
    # the codec and what the compiler does lower.
    with pytest.raises(NotImplementedError, match="cannot lower Opaque"):
        codecs.compile(Opaque())
    with pytest.raises(ValueError, match="bernoulli"):
        vae.make_bb_codec_q({}, vae.paper_config("beta_binomial"))
