"""The port's hierarchical VAE under Bit-Swap (``repro_torch.models.hvae``)
against the JAX reference at small sizes (ch 8, z_ch 2, 6 x 6 and 8 x 8
images, 2-3 lanes), on the reference's own weights carried across by
``weights.from_jax_params``.

The fixed-point codec is integer-exact, so it is held to the reference's
bytes hex for hex, eager and compiled. The float networks round
differently in torch and XLA, so the float codec is held to the
reference's rate within a stated tolerance, and to itself byte for byte
across the bucketize kernel leaf, the plain leaf and ``codecs.compile``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as ref_codecs  # noqa: E402
from repro.codecs import quantize as ref_quantize  # noqa: E402
from repro.data import images as ref_images  # noqa: E402
from repro.models import hvae as ref_hvae  # noqa: E402
from repro_torch import codecs, stream, weights  # noqa: E402
from repro_torch.codecs import quantize  # noqa: E402
from repro_torch.configs import hvae_img  # noqa: E402
from repro_torch.data import images  # noqa: E402
from repro_torch.models import hvae  # noqa: E402

SMALL = dict(ch=8, z_ch=2, n_res=1)
KW = dict(seed=0, init_chunks=16, capacity=512)


@functools.lru_cache(maxsize=None)
def _models(levels):
    """(reference config, reference params, config, the same params in the
    port), drawn from ``PRNGKey(levels)``; shared, never changed."""
    cfg_r = ref_hvae.HVAEConfig(levels=levels, **SMALL)
    with jax.threefry_partitionable(False):
        ref_params = ref_hvae.init(jax.random.PRNGKey(levels), cfg_r)
    params = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return cfg_r, ref_params, hvae.HVAEConfig(levels=levels, **SMALL), params


def _images(shape, n, lanes, seed):
    return np.random.default_rng(seed).integers(
        0, 2, (n, lanes) + shape).astype(np.int32)


@pytest.mark.parametrize("stride,hw", [(1, (6, 8)), (2, (8, 6)),
                                       (2, (7, 9))])
def test_conv_q_and_deconv_q_equal_the_reference(stride, hw):
    """Integer convolutions with XLA's SAME padding (asymmetric at stride
    2) and the transpose convolution (zero-dilated, padded (2, 1),
    unflipped kernel): the reference's integers, tolerance 0."""
    rng = np.random.default_rng(stride * 10 + hw[0])
    x = rng.integers(-2048, 2049, (3,) + hw + (5,)).astype(np.int32)
    w = rng.integers(-512, 513, (3, 3, 5, 4)).astype(np.int32)
    b = rng.integers(-(1 << 20), 1 << 20, 4).astype(np.int32)
    q_r, q = ref_quantize.QuantConfig(), quantize.QuantConfig()
    p_r = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    p = {"w": torch.from_numpy(w).long(), "b": torch.from_numpy(b).long()}
    xt = torch.from_numpy(x).long()
    for fn_r, fn in ((ref_quantize.conv_q, quantize.conv_q),
                     (ref_quantize.deconv_q, quantize.deconv_q)):
        want = np.asarray(fn_r(p_r, jnp.asarray(x), q_r, stride=stride))
        got = fn(p, xt, q, stride=stride).numpy()
        np.testing.assert_array_equal(got, want)


def test_fixed_point_networks_equal_the_reference():
    """Every fixed-point network of a 2-level model: the reference's
    (mu, sigma) bits and pixel frequencies."""
    cfg_r, ref_params, cfg, params = _models(2)
    q_r, q = ref_quantize.QuantConfig(), quantize.QuantConfig()
    qp_r = ref_hvae.quantize_model(ref_params, cfg_r, q_r)
    qp = hvae.quantize_model(params, cfg, q)
    x = _images((8, 6), 1, 3, seed=2)[0]
    lat_hw = cfg.latent_shape((8, 6))
    idx = np.random.default_rng(3).integers(
        0, 1 << cfg.lat_bits, (3, int(np.prod(lat_hw)))).astype(np.int32)
    pairs = [
        (ref_hvae.infer_z1_q(qp_r, cfg_r, q_r, jnp.asarray(x)),
         hvae.infer_z1_q(qp, cfg, q, torch.from_numpy(x))),
        (ref_hvae.stage_gaussian_q(qp_r, cfg_r, q_r, "q2", jnp.asarray(idx),
                                   lat_hw),
         hvae.stage_gaussian_q(qp, cfg, q, "q2", torch.from_numpy(idx),
                               lat_hw)),
        (ref_hvae.stage_gaussian_q(qp_r, cfg_r, q_r, "p2", jnp.asarray(idx),
                                   lat_hw),
         hvae.stage_gaussian_q(qp, cfg, q, "p2", torch.from_numpy(idx),
                               lat_hw)),
    ]
    for (mu_r, sg_r), (mu, sg) in pairs:
        np.testing.assert_array_equal(mu.numpy().view(np.uint32),
                                      np.asarray(mu_r).view(np.uint32))
        np.testing.assert_array_equal(sg.numpy().view(np.uint32),
                                      np.asarray(sg_r).view(np.uint32))
    f1_r = ref_hvae.decode_obs_freq1_q(qp_r, cfg_r, q_r, jnp.asarray(idx),
                                       lat_hw)
    f1 = hvae.decode_obs_freq1_q(qp, cfg, q, torch.from_numpy(idx), lat_hw)
    np.testing.assert_array_equal(f1.numpy(), np.asarray(f1_r))


@pytest.mark.parametrize("levels", [2, 3])
def test_fixed_point_bitswap_writes_the_reference_bytes(levels):
    """A 2-image chain at 3 lanes of 6 x 6 images: the port's eager and
    compiled fixed-point codecs and the reference's compiled one write the
    same blob, hex for hex, and the port decodes it."""
    cfg_r, ref_params, cfg, params = _models(levels)
    hw, n = (6, 6), 2
    data = _images(hw, n, 3, seed=levels)
    with jax.threefry_partitionable(False):
        want = ref_codecs.compress(
            ref_codecs.Chained(ref_hvae.make_bitswap_codec_q(
                ref_params, cfg_r, hw, compiled=True), n),
            jnp.asarray(data), lanes=3, **KW)
    eager = codecs.Chained(hvae.make_bitswap_codec_q(params, cfg, hw), n)
    fused = codecs.compile(eager)
    assert type(fused.lowered).__name__ == "_FusedChained"
    for codec in (eager, fused):
        assert codecs.compress(codec, data, lanes=3, device="cpu",
                               **KW).hex() == want.hex()
    back = codecs.decompress(fused, want, device="cpu")
    np.testing.assert_array_equal(back.numpy(), data)


def test_float_networks_and_elbo_follow_the_reference():
    """The float posterior and the ELBO on the reference's weights and
    noise: torch's and XLA's convolutions sum in other orders, so they
    agree to float32 rounding (rtol 1e-4; about 1e-6 seen)."""
    cfg_r, ref_params, cfg, params = _models(2)
    x = _images((8, 8), 1, 3, seed=4)[0]
    mu_r, sg_r = ref_hvae.infer_z1(ref_params, cfg_r, jnp.asarray(x))
    mu, sg = hvae.infer_z1(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sg.numpy(), np.asarray(sg_r), rtol=1e-4)
    key = jax.random.PRNGKey(7)
    with jax.threefry_partitionable(False):
        elbo_r = ref_hvae.elbo(ref_params, cfg_r, key, jnp.asarray(x))
        eps = []
        for _ in range(cfg.levels):          # the reference's draws
            key, sub = jax.random.split(key)
            eps.append(torch.from_numpy(np.array(
                jax.random.normal(sub, mu_r.shape))))
    elbo = hvae.elbo(params, cfg, None, torch.from_numpy(x), eps)
    np.testing.assert_allclose(elbo.detach().numpy(), np.asarray(elbo_r),
                               rtol=1e-4)


def test_float_bitswap_rate_and_paths_agree():
    """The float codec: the bucketize-kernel leaf, the plain leaf and the
    compiled codec write the same bytes; the blob decodes; its size is
    within 3% of the reference's blob on the same weights (one bucket
    that rounds the other way moves the bits-back path; on this tree the
    two blobs were the same size, often the same bytes)."""
    cfg_r, ref_params, cfg, params = _models(2)
    hw, n, lanes = (6, 6), 2, 3
    data = _images(hw, n, lanes, seed=5)
    with jax.threefry_partitionable(False):
        want = ref_codecs.compress(
            ref_codecs.Chained(ref_hvae.make_bitswap_codec(
                ref_params, cfg_r, hw, compiled=True), n),
            jnp.asarray(data), lanes=lanes, **KW)
    blobs = [codecs.compress(
        codecs.Chained(hvae.make_bitswap_codec(params, cfg, hw, **opt), n),
        data, lanes=lanes, device="cpu", **KW)
        for opt in ({}, {"use_bucketize_kernel": True}, {"compiled": True})]
    assert blobs[0] == blobs[1] == blobs[2]
    assert len(blobs[0]) == pytest.approx(len(want), rel=0.03)
    kernel = codecs.Chained(hvae.make_bitswap_codec(
        params, cfg, hw, use_bucketize_kernel=True), n)
    np.testing.assert_array_equal(
        codecs.decompress(kernel, blobs[0], device="cpu").numpy(), data)


def test_float_bitswap_streams_losslessly():
    """Through the BBX2 stream (compiled, 2 blocks of 2 images at 2 lanes,
    8 x 8), decoded with the bucketize-kernel leaf."""
    _, _, cfg, params = _models(2)
    hw = (8, 8)
    data = torch.from_numpy(_images(hw, 4, 2, seed=6))
    codec = hvae.make_bitswap_codec(params, cfg, hw)
    wire = stream.encode_stream(codec, data, lanes=2, block_symbols=2,
                                compile=True, device="cpu", **KW)
    kernel = hvae.make_bitswap_codec(params, cfg, hw,
                                     use_bucketize_kernel=True)
    assert torch.equal(stream.decode_stream(kernel, wire, device="cpu"),
                       data)


def test_tree_codec_visits_sorted_keys_like_the_reference():
    """A dict of codecs written with unsorted keys: leaves go in sorted
    key order (and lists by position), so a push leaves the reference's
    stack, word for word, and the pop returns the tree."""
    rng = np.random.default_rng(9)
    lanes = 3
    logits = rng.normal(0, 1, (lanes,)).astype(np.float32)
    sym = {"z": rng.integers(0, 32, lanes), "a": rng.integers(0, 2, lanes),
           "m": [rng.integers(0, 4, lanes), rng.integers(0, 8, lanes)]}
    ref_codec = ref_codecs.TreeCodec({
        "z": ref_codecs.Uniform(5),
        "a": ref_codecs.Bernoulli(jnp.asarray(logits)),
        "m": [ref_codecs.Uniform(2), ref_codecs.Uniform(3)]})
    codec = codecs.TreeCodec({
        "z": codecs.Uniform(5),
        "a": codecs.Bernoulli(torch.from_numpy(logits)),
        "m": [codecs.Uniform(2), codecs.Uniform(3)]})
    to_jax = lambda v: jnp.asarray(v, jnp.int32)
    with jax.threefry_partitionable(False):
        ref_stack = ref_codec.push(
            ref_codecs.fresh_stack(lanes, 64, seed=1, init_chunks=4),
            {"z": to_jax(sym["z"]), "a": to_jax(sym["a"]),
             "m": [to_jax(v) for v in sym["m"]]})
    t_sym = {"z": torch.from_numpy(sym["z"]), "a": torch.from_numpy(sym["a"]),
             "m": [torch.from_numpy(v) for v in sym["m"]]}
    for c in (codec, codecs.compile(codec)):
        stack = c.push(codecs.fresh_stack(lanes, 64, seed=1, init_chunks=4,
                                          device="cpu"), t_sym)
        np.testing.assert_array_equal(stack.head.numpy(),
                                      np.asarray(ref_stack.head))
        np.testing.assert_array_equal(stack.ptr.numpy(),
                                      np.asarray(ref_stack.ptr))
        np.testing.assert_array_equal(stack.buf.numpy(),
                                      np.asarray(ref_stack.buf))
        stack, out = c.pop(stack)
        assert list(out) == ["a", "m", "z"]
        for k in ("a", "z"):
            np.testing.assert_array_equal(out[k].numpy(), sym[k])
        for got, exp in zip(out["m"], sym["m"]):
            np.testing.assert_array_equal(got.numpy(), exp)


def test_image_data_equals_the_reference():
    for split, seed, hw in (("train", 0, (20, 30)), ("test", 3, (28, 28))):
        np.testing.assert_array_equal(
            images.load(split, 40, seed, hw=hw),
            ref_images.load(split, 40, seed, hw=hw))
    np.testing.assert_array_equal(
        images.load("train", 10, 1, binarized=False),
        ref_images.load("train", 10, 1, binarized=False))
    src = images.load("train", 30, 2)
    got = images.image_batch_fn(src, 8, (16, 12))(5, 3, 1, 2)["images"]
    want = ref_images.image_batch_fn(src, 8, (16, 12))(5, 3, 1, 2)["images"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    odd = np.ones((2, 5, 7), np.uint8)
    np.testing.assert_array_equal(images.pad_to_even(odd),
                                  ref_images.pad_to_even(odd))
    shapes = [(8, 8), (12, 6)]
    assert [images.shape_schedule(shapes, s) for s in range(3)] == \
        [ref_images.shape_schedule(shapes, s) for s in range(3)]


def test_configs_and_the_unported_likelihood():
    from repro.configs import hvae_img as ref_configs
    for name in ("hvae-small2", "hvae-small3", "hvae-base2", "hvae-base3"):
        cfg, ref = hvae_img.get(name), ref_configs.get(name)
        assert (cfg.levels, cfg.ch, cfg.z_ch, cfg.n_res) == \
            (ref.levels, ref.ch, ref.z_ch, ref.n_res)
    with pytest.raises(KeyError):
        hvae_img.get("hvae-huge")
    with pytest.raises(NotImplementedError, match="item 3"):
        hvae.HVAEConfig(likelihood="beta_binomial")
    with pytest.raises(ValueError, match="even"):
        hvae_img.SMALL2.latent_shape((7, 8))
    params = hvae.init(hvae_img.SMALL2, torch.Generator().manual_seed(0),
                       device="cpu")
    with pytest.raises(ValueError, match="rank|shape"):
        hvae.codec_family(params, hvae_img.SMALL2)((28,))
