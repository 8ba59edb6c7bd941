"""The port stands alone: importing all of ``repro_torch`` loads neither
JAX nor the reference package, its entry points refuse to fall back to
the CPU, and ``chip_smoke.py`` fails without the port or a card."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import codecs, shard_codec, stream  # noqa: E402
from repro_torch.models import vae  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout.split(maxsplit=1)
    assert int(out[0]) >= 30
    assert out[1].strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_of_the_port_names_jax_or_repro():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    bad = {f: m for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad


def test_entry_points_without_a_device_raise_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codec = codecs.Repeat(lambda d: codecs.Uniform(4), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.compress(codec, torch.zeros((2, 2), dtype=torch.int32),
                        lanes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.fresh_stack(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vae.init(vae.paper_config("bernoulli"), torch.Generator())
    layer = {"w": torch.zeros((3, 2)), "b": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.quantize_params({"enc": layer}, codecs.QuantConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.StreamEncoder(codec, lanes=2, block_symbols=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.StreamDecoder(codec)
    data = torch.zeros((2, 2, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_codec.compress_dataset(codec, data, n_shards=2)
    blob = shard_codec.compress_dataset(codec, data, n_shards=2,
                                        devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_codec.decompress_dataset(codec, blob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_codec.decompress_shard(codec, blob, 0)


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
