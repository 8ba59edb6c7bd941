"""The port's BBX2 block stream against the reference's: the same data
through ``repro_torch.stream`` and ``repro.stream`` gives the same wire,
byte for byte, whichever execution path the port takes (``use_kernel``,
``compile``, ``pipeline``), across ragged blocks, snapshot/resume,
resumed decodes and grow-and-retry; the port decodes it losslessly.

Reference encodes that draw random bits run inside
``jax.threefry_partitionable(False)`` (the mode of the golden blobs); the
port needs no flag.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as ref_codecs  # noqa: E402
from repro import stream as ref_stream  # noqa: E402
from repro.models import vae as ref_vae  # noqa: E402
from repro_torch import codecs, stream, weights  # noqa: E402
from repro_torch.models import vae  # noqa: E402

from tests.golden.make_torch_fixtures import VAE_PARAMS  # noqa: E402

CAT_LANES, CAT_A = 5, 20
VAE_LANES = 3


def _cat_data(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, CAT_A, (n, CAT_LANES)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _logits():
    return np.random.default_rng(99).normal(
        size=(CAT_LANES, CAT_A)).astype(np.float32) * 2


def _cat():
    return codecs.Categorical(torch.from_numpy(_logits()))


def _vae_data(n, seed=1234):
    return np.random.default_rng(seed).integers(
        0, 2, (n, VAE_LANES, 36)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _vae_codecs():
    flat = dict(np.load(VAE_PARAMS))
    nested = {}
    for key, v in flat.items():
        layer, leaf = key.rsplit(".", 1)
        nested.setdefault(layer, {})[leaf] = jnp.asarray(v)
    ref = ref_vae.make_bb_codec_q(nested, ref_vae.VAEConfig(36, 24, 6))
    port = vae.make_bb_codec_q(
        weights.from_jax_params(flat, device="cpu"), vae.VAEConfig(36, 24, 6))
    return ref, port


def _ref_codec(kind):
    if kind == "cat":
        return ref_codecs.Categorical(jnp.asarray(_logits()))
    return _vae_codecs()[0]


def _port_codec(kind):
    return _cat() if kind == "cat" else _vae_codecs()[1]


@functools.lru_cache(maxsize=None)
def _ref_wire(kind, n, block_symbols, seed, init_chunks, capacity):
    data = _cat_data(n) if kind == "cat" else _vae_data(n)
    with jax.threefry_partitionable(False):
        return ref_stream.encode_stream(
            _ref_codec(kind), jnp.asarray(data),
            lanes=data.shape[1], block_symbols=block_symbols, seed=seed,
            init_chunks=init_chunks, capacity=capacity)


def _port_wire(kind, n, block_symbols, seed, init_chunks, capacity, **kw):
    data = _cat_data(n) if kind == "cat" else _vae_data(n)
    return stream.encode_stream(
        _port_codec(kind), data, lanes=data.shape[1],
        block_symbols=block_symbols, seed=seed, init_chunks=init_chunks,
        capacity=capacity, device="cpu", **kw), data


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("compile", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seed", [None, 0])
def test_categorical_stream_matches_reference(seed, use_kernel, compile,
                                              pipeline):
    """11 datapoints in blocks of 4: two full blocks and a ragged one."""
    args = ("cat", 11, 4, seed, 0, None)
    wire, data = _port_wire(*args, use_kernel=use_kernel, compile=compile,
                            pipeline=pipeline)
    assert wire.hex() == _ref_wire(*args).hex()
    out = stream.decode_stream(_cat(), wire, use_kernel=use_kernel,
                               compile=compile, device="cpu")
    np.testing.assert_array_equal(out.numpy(), data)


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("compile", [False, True])
def test_vae_stream_matches_reference(compile, pipeline):
    """The fixed-point VAE, 5 images per lane in blocks of 2 (ragged
    last block), with per-block clean bits."""
    args = ("vae", 5, 2, 0, 16, 512)
    wire, data = _port_wire(*args, compile=compile, pipeline=pipeline)
    assert wire.hex() == _ref_wire(*args).hex()
    out = stream.decode_stream(_port_codec("vae"), wire, compile=compile,
                               device="cpu")
    np.testing.assert_array_equal(out.numpy(), data)


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("case", ["overflow", "underflow"])
def test_grow_and_retry_matches_reference(case, pipeline):
    """A capacity of 1 chunk overflows and makes every block grow;
    ``init_chunks=0`` with a seed underflows the first posterior pop and
    makes the clean-bit supply grow. Both wires equal the reference's."""
    args = ("vae", 4, 2, 0, 0, None) if case == "underflow" \
        else ("cat", 16, 8, 0, 0, 1)
    wire, data = _port_wire(*args, compile=True, pipeline=pipeline)
    assert wire.hex() == _ref_wire(*args).hex()
    out = stream.decode_stream(_port_codec(args[0]), wire, device="cpu")
    np.testing.assert_array_equal(out.numpy(), data)
    enc = stream.StreamEncoder(_port_codec(args[0]), lanes=data.shape[1],
                               block_symbols=args[2], seed=0,
                               capacity=args[5], device="cpu")
    enc.write(data)
    if case == "underflow":
        assert enc._init_chunks >= 32
    else:
        assert enc._capacity > 1


@pytest.mark.parametrize("kind", ["cat", "vae"])
def test_snapshot_resume_continues_the_reference_wire(kind):
    """Encode two blocks, snapshot, resume in a fresh encoder, write the
    rest: the bytes equal the uninterrupted reference stream, and the
    snapshot equals the reference's at the same point."""
    args = ("cat", 10, 4, 0, 0, None) if kind == "cat" \
        else ("vae", 5, 2, 0, 16, 512)
    _, n, bs, seed, chunks, cap = args
    data = _cat_data(n) if kind == "cat" else _vae_data(n)
    codec = _port_codec(kind)
    enc = stream.StreamEncoder(codec, lanes=data.shape[1], block_symbols=bs,
                               seed=seed, init_chunks=chunks, capacity=cap,
                               pipeline=True, device="cpu")
    wire = enc.write(data[:2 * bs])
    wire += enc.drain()
    snap = enc.snapshot()
    enc2 = stream.StreamEncoder.resume(codec, snap, compile=True,
                                       device="cpu")
    wire += enc2.write(data[2 * bs:]) + enc2.flush()
    assert wire.hex() == _ref_wire(*args).hex()
    with jax.threefry_partitionable(False):
        ref_enc = ref_stream.StreamEncoder(
            _ref_codec(kind), lanes=data.shape[1], block_symbols=bs,
            seed=seed, init_chunks=chunks, capacity=cap)
        ref_enc.write(jnp.asarray(data[:2 * bs]))
        ref_snap = ref_enc.snapshot()
    for f in ("lanes", "block_symbols", "precision", "seed", "init_chunks",
              "capacity", "n_blocks", "n_symbols", "wire_bytes", "started",
              "heads"):
        assert getattr(snap, f) == getattr(ref_snap, f), f
    assert snap.net_bits == pytest.approx(ref_snap.net_bits, rel=1e-5)


def test_decode_from_offset_and_piecewise_reads():
    args = ("cat", 14, 3, 0, 0, None)
    wire, data = _port_wire(*args)
    header, offsets, trailer = stream.format.scan(wire)
    r_header, r_offsets, r_trailer = ref_stream.format.scan(wire)
    assert offsets == r_offsets and len(offsets) == 5
    assert (header.lanes, header.block_symbols) == (CAT_LANES, 3)
    assert (trailer.n_blocks, trailer.total_symbols) == \
        (r_trailer.n_blocks, r_trailer.total_symbols) == (5, 14)
    tail = stream.decode_from_offset(_cat(), wire, offsets[2], device="cpu")
    np.testing.assert_array_equal(tail.numpy(), data[6:])
    dec = stream.StreamDecoder(_cat(), device="cpu")
    blocks = []
    for i in range(0, len(wire), 37):
        blocks += dec.read(wire[i:i + 37])
    assert dec.finished and [b.shape[0] for b in blocks] == [3, 3, 3, 3, 2]
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), data)


def test_corrupt_streams_and_refusals():
    wire, _ = _port_wire("cat", 8, 4, 0, 0, None)
    off = stream.format.scan(wire)[1][1]
    bad = wire[:off] + b"\x00\x00" + wire[off + 2:]
    with pytest.raises(codecs.ContainerError, match="block 1"):
        stream.format.scan(bad)
    with pytest.raises(codecs.ContainerError, match="bad magic"):
        stream.decode_stream(_cat(), b"XXXX" + wire[4:], device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        stream.decode_stream(_cat(), wire[:-16], device="cpu")
    enc = stream.StreamEncoder(_cat(), lanes=CAT_LANES, block_symbols=4,
                               device="cpu")
    enc.write(_cat_data(3))
    with pytest.raises(RuntimeError, match="mid-block"):
        enc.snapshot()
    enc.flush()
    assert enc.flush() == b""
    with pytest.raises(RuntimeError, match="after flush"):
        enc.write(_cat_data(1))
    with pytest.raises(ValueError, match="lanes="):
        stream.StreamEncoder(_cat(), lanes=CAT_LANES, block_symbols=4,
                             device="cpu").write(np.zeros((2, 3), np.int32))
    for cls in (stream.StreamEncoder, stream.StreamDecoder):
        kw = dict(lanes=2, block_symbols=2) if cls is stream.StreamEncoder \
            else {}
        with pytest.raises(NotImplementedError, match="queue 1, item 11"):
            cls(_cat(), verify=True, device="cpu", **kw)


def test_tuple_datapoints_match_reference():
    """``Serial`` datapoints are tuples: the stream splits, buffers and
    stacks each leaf, and the wire equals the reference's."""
    rng = np.random.default_rng(5)
    data = (rng.integers(0, 16, (7, 3)).astype(np.int32),
            rng.integers(0, 64, (7, 3)).astype(np.int32))
    kw = dict(lanes=3, block_symbols=3, seed=0)
    with jax.threefry_partitionable(False):
        want = ref_stream.encode_stream(
            ref_codecs.Serial([ref_codecs.Uniform(4), ref_codecs.Uniform(6)]),
            tuple(jnp.asarray(d) for d in data), **kw)
    codec = codecs.Serial([codecs.Uniform(4), codecs.Uniform(6)])
    wire = stream.encode_stream(codec, data, device="cpu", **kw)
    assert wire.hex() == want.hex()
    out = stream.decode_stream(codec, wire, device="cpu")
    for o, d in zip(out, data):
        np.testing.assert_array_equal(o.numpy(), d)
