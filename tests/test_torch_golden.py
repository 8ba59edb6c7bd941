"""The committed golden blobs, re-encoded by the PyTorch port hex for hex
and decoded losslessly (the port reproduces the reference's threefry
draws itself, so these hold whatever JAX's PRNG mode)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import codecs, weights  # noqa: E402
from repro_torch.models import vae  # noqa: E402

from tests.golden.make_golden import GOLDEN_DIR, LANES  # noqa: E402
from tests.golden.make_torch_fixtures import VAE_PARAMS  # noqa: E402


def _read(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.bin"), "rb") as f:
        return f.read()


def _uniform():
    """``make_golden``'s bbx1_uniform: 9 uniform 6-bit symbols per lane."""
    rng = np.random.default_rng(42)
    codec = codecs.Shaped(codecs.Repeat(lambda d: codecs.Uniform(6), 9),
                          (9,))
    data = rng.integers(0, 64, (LANES, 9)).astype(np.int32)
    return codec, data, {}


def _vae(compiled):
    """``make_golden``'s bbx1_vae_fixedpoint: the (36, 24, 6) quantized
    VAE on its committed parameters, one image per lane."""
    params = weights.from_jax_params(dict(np.load(VAE_PARAMS)), device="cpu")
    codec = vae.make_bb_codec_q(params, vae.VAEConfig(36, 24, 6),
                                compiled=compiled)
    data = np.random.default_rng(1234).integers(0, 2, (1, LANES, 36))[0]
    return codec, data.astype(np.int32), dict(init_chunks=16, capacity=512)


FIXTURES = {
    "bbx1_uniform": _uniform,
    "bbx1_vae_fixedpoint[fused]": lambda: _vae(True),
    "bbx1_vae_fixedpoint[eager]": lambda: _vae(False),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_reencodes_committed_bytes(name):
    codec, data, kw = FIXTURES[name]()
    blob = codecs.compress(codec, data, lanes=LANES, seed=0, device="cpu",
                           **kw)
    assert blob.hex() == _read(name.split("[")[0]).hex()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_decodes_committed_bytes(name):
    codec, data, _ = FIXTURES[name]()
    out = codecs.decompress(codec, _read(name.split("[")[0]), device="cpu")
    np.testing.assert_array_equal(out.numpy(), data)


def test_corrupt_blobs_raise_container_error():
    blob = _read("bbx1_uniform")
    codec = _uniform()[0]
    for bad in (blob[:5], b"XXXX" + blob[4:], blob[:-2], blob + b"\0\0"):
        with pytest.raises(codecs.ContainerError):
            codecs.decompress(codec, bad, device="cpu")
    info = codecs.blob_info(blob)
    assert info["lanes"] == LANES and info["total_bits"] == 8 * len(blob)
