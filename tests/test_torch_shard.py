"""The port's BBX3 sharded corpus against the reference's: the same data
cut into 1, 2 or 4 lane shards gives the same corpus bytes through
``repro_torch.shard_codec`` as through ``repro.shard_codec``; one shard
decodes alone; 1-lane shards work on the port's compiled path (the
reference's compiled path raises there, ROADMAP H2, so they are held to
its eager wire)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import shard_codec as ref_shard  # noqa: E402
from repro.stream import format as ref_fmt  # noqa: E402
from repro.models import vae as ref_vae  # noqa: E402
from repro_torch import codecs, shard_codec, stream, weights  # noqa: E402
from repro_torch.models import vae  # noqa: E402

from tests.golden.make_torch_fixtures import VAE_PARAMS  # noqa: E402

LANES = 4
KW = dict(block_symbols=2, seed=0, init_chunks=16, capacity=512)


def _data(n=3):
    return np.random.default_rng(77).integers(
        0, 2, (n, LANES, 36)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _codecs():
    flat = dict(np.load(VAE_PARAMS))
    nested = {}
    for key, v in flat.items():
        layer, leaf = key.rsplit(".", 1)
        nested.setdefault(layer, {})[leaf] = jnp.asarray(v)
    cfg = (36, 24, 6)
    return (ref_vae.make_bb_codec_q(nested, ref_vae.VAEConfig(*cfg)),
            vae.make_bb_codec_q(weights.from_jax_params(flat, device="cpu"),
                                vae.VAEConfig(*cfg)))


@functools.lru_cache(maxsize=None)
def _ref_corpus(n_shards):
    with jax.threefry_partitionable(False):
        return ref_shard.compress_dataset(_codecs()[0], jnp.asarray(_data()),
                                          n_shards=n_shards, **KW)


def _cpu(n):
    return ["cpu"] * n


@pytest.mark.parametrize("compile", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_corpus_matches_reference(n_shards, compile):
    codec = _codecs()[1]
    blob = shard_codec.compress_dataset(codec, _data(), n_shards=n_shards,
                                        devices=_cpu(n_shards),
                                        compile=compile, pipeline=compile,
                                        **KW)
    assert blob.hex() == _ref_corpus(n_shards).hex()
    out = shard_codec.decompress_dataset(codec, blob, devices=_cpu(n_shards),
                                         compile=compile)
    np.testing.assert_array_equal(out.numpy(), _data())


def test_each_shard_decodes_alone():
    codec, blob = _codecs()[1], _ref_corpus(4)
    for s in range(4):
        xs = shard_codec.decompress_shard(codec, blob, s, device="cpu")
        np.testing.assert_array_equal(xs.numpy(), _data()[:, s:s + 1])
    info = shard_codec.corpus_info(blob)
    assert info == ref_shard.corpus_info(blob)
    assert info["n_shards"] == 4 and info["total_symbols"] == 12
    for hosts in (1, 3):
        assert stream.corpus_assignments(blob, hosts) == \
            ref_fmt.corpus_assignments(blob, hosts)


def test_chunked_input_and_lane_trees():
    """A list of chunks codes as the whole array does; split and merge
    invert each other; bad layouts raise."""
    codec, data = _codecs()[1], _data(4)
    whole = shard_codec.compress_dataset(codec, data, n_shards=2,
                                         devices=_cpu(2), **KW)
    chunked = shard_codec.compress_dataset(
        codec, iter([data[:1], data[1:]]), n_shards=2, devices=_cpu(2), **KW)
    assert whole == chunked
    parts = shard_codec.split_lane_tree(torch.from_numpy(data), 4)
    assert [tuple(p.shape) for p in parts] == [(4, 1, 36)] * 4
    assert torch.equal(shard_codec.merge_lane_tree(parts),
                       torch.from_numpy(data))
    with pytest.raises(ValueError, match="do not divide"):
        shard_codec.compress_dataset(codec, data, n_shards=3,
                                     devices=_cpu(3), **KW)
    with pytest.raises(ValueError, match="devices for"):
        shard_codec.compress_dataset(codec, data, n_shards=2,
                                     devices=_cpu(1), **KW)
    with pytest.raises(ValueError, match="no data"):
        shard_codec.compress_dataset(codec, [], n_shards=2, devices=_cpu(2))
    with pytest.raises(codecs.ContainerError, match="out of range"):
        shard_codec.decompress_shard(codec, whole, 2, device="cpu")
