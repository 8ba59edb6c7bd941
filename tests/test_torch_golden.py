"""The committed golden blobs, re-encoded by the PyTorch port hex for hex
and decoded losslessly (the port reproduces the reference's threefry
draws itself, so these hold whatever JAX's PRNG mode): the BBX1
containers, the BBX2 stream and the BBX3 corpora. ``bbx3_cluster`` was
written by the reference's gateway cluster with a host killed mid-stream;
its bytes are those of the synchronous sharded path, which the port
runs."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import codecs, shard_codec, stream, weights  # noqa: E402
from repro_torch.models import vae  # noqa: E402

from tests.golden.make_golden import GOLDEN_DIR, LANES  # noqa: E402
from tests.golden.make_torch_fixtures import VAE_PARAMS  # noqa: E402


def _read(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.bin"), "rb") as f:
        return f.read()


def _uniform_codec():
    return codecs.Shaped(codecs.Repeat(lambda d: codecs.Uniform(6), 9),
                         (9,))


def _container(codec, data, **kw):
    """(encode, decode, data) of a one-shot BBX1 fixture."""
    return (lambda: codecs.compress(codec, data, lanes=LANES, seed=0,
                                    device="cpu", **kw),
            lambda blob: codecs.decompress(codec, blob, device="cpu"), data)


def _uniform():
    """``make_golden``'s bbx1_uniform: 9 uniform 6-bit symbols per lane."""
    rng = np.random.default_rng(42)
    data = rng.integers(0, 64, (LANES, 9)).astype(np.int32)
    return _container(_uniform_codec(), data)


def _categorical():
    """``make_golden``'s bbx1_categorical: a static table from seeded
    logits (drawn after bbx1_uniform's data from the same generator)."""
    rng = np.random.default_rng(42)
    rng.integers(0, 64, (LANES, 9))
    logits = rng.normal(size=(LANES, 12)).astype(np.float32)
    data = rng.integers(0, 12, (LANES,)).astype(np.int32)
    return _container(codecs.Categorical(torch.from_numpy(logits)), data)


def _vae_codec(compiled=False):
    """The (36, 24, 6) quantized VAE on its committed parameters."""
    params = weights.from_jax_params(dict(np.load(VAE_PARAMS)), device="cpu")
    return vae.make_bb_codec_q(params, vae.VAEConfig(36, 24, 6),
                               compiled=compiled)


def _vae_data(n):
    return np.random.default_rng(1234).integers(
        0, 2, (n, LANES, 36)).astype(np.int32)


def _vae(compiled):
    """``make_golden``'s bbx1_vae_fixedpoint: one image per lane."""
    return _container(_vae_codec(compiled), _vae_data(1)[0], init_chunks=16,
                      capacity=512)


def _stream(fast):
    """``make_golden``'s bbx2_stream: 6 images per lane in blocks of 2;
    written compiled and pipelined, and by the eager synchronous path."""
    codec = _vae_codec()
    kw = dict(lanes=LANES, block_symbols=2, seed=0, init_chunks=16,
              capacity=512, compile=fast, pipeline=fast, device="cpu")
    return (lambda: stream.encode_stream(codec, _vae_data(6), **kw),
            lambda blob: stream.decode_stream(codec, blob, compile=fast,
                                              device="cpu"), _vae_data(6))


def _corpus():
    """``make_golden``'s bbx3_corpus: 4 images per lane, 2 lane shards."""
    codec = _vae_codec()
    return (lambda: shard_codec.compress_dataset(
                codec, _vae_data(4), n_shards=2, block_symbols=2, seed=0,
                init_chunks=16, capacity=512, devices=["cpu"] * 2),
            lambda blob: shard_codec.decompress_dataset(
                codec, blob, devices=["cpu"] * 2), _vae_data(4))


def _cluster():
    """``make_golden``'s bbx3_cluster data: 8 x 8 lanes of 9 uniform 6-bit
    symbols, 4 shards, shard s seeded s, no clean bits."""
    codec = _uniform_codec()
    data = np.random.default_rng(2024).integers(0, 64, (8, 8, 9)) \
        .astype(np.int32)
    return (lambda: shard_codec.compress_dataset(
                codec, data, n_shards=4, block_symbols=2, seed=0,
                init_chunks=0, devices=["cpu"] * 4),
            lambda blob: shard_codec.decompress_dataset(
                codec, blob, devices=["cpu"] * 4), data)


FIXTURES = {
    "bbx1_uniform": _uniform,
    "bbx1_categorical": _categorical,
    "bbx1_vae_fixedpoint[fused]": lambda: _vae(True),
    "bbx1_vae_fixedpoint[eager]": lambda: _vae(False),
    "bbx2_stream[compiled-pipelined]": lambda: _stream(True),
    "bbx2_stream[eager]": lambda: _stream(False),
    "bbx3_corpus": _corpus,
    "bbx3_cluster": _cluster,
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_reencodes_committed_bytes(name):
    encode, _, _ = FIXTURES[name]()
    assert encode().hex() == _read(name.split("[")[0]).hex()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_decodes_committed_bytes(name):
    _, decode, data = FIXTURES[name]()
    out = decode(_read(name.split("[")[0]))
    np.testing.assert_array_equal(out.numpy(), data)


def test_corrupt_blobs_raise_container_error():
    blob = _read("bbx1_uniform")
    codec = _uniform_codec()
    for bad in (blob[:5], b"XXXX" + blob[4:], blob[:-2], blob + b"\0\0"):
        with pytest.raises(codecs.ContainerError):
            codecs.decompress(codec, bad, device="cpu")
    info = codecs.blob_info(blob)
    assert info["lanes"] == LANES and info["total_bits"] == 8 * len(blob)
