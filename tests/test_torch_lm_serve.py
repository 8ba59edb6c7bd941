"""The port's LM serving path (``repro_torch.core.lm_codec``,
``repro_torch.serve.engine.Engine``, ``repro_torch.launch.serve``) and
``FactoredCategorical`` against the JAX reference on the CPU.

``FactoredCategorical`` is integer coding over float32 logits: given the
same logits it writes the reference's stack word for word (XLA-CPU's
logsumexp, ``log_f32`` included). The engine runs a float model whose
logits differ from the reference's in the last bits, so its blobs are
held to losslessness and to the reference's rate: at float32 compute
within 0.1% (a table boundary moves rarely), at bfloat16 within 1%.
Greedy generation at float32 compute picks the reference's tokens.
"""

import contextlib
import dataclasses
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import codecs as ref_codecs  # noqa: E402
from repro.codecs import container as ref_container  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.core import distributions as ref_dist  # noqa: E402
from repro.core import lm_codec as ref_lm  # noqa: E402
from repro.data import tokens as ref_tokens  # noqa: E402
from repro.launch import serve as ref_launch  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch import codecs, stream, weights  # noqa: E402
from repro_torch.codecs import container  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import ans, distributions, lm_codec  # noqa: E402
from repro_torch.core import xla_ndtr  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402


def _stack_words(s):
    return {f: np.asarray(getattr(s, f).numpy() if isinstance(
        getattr(s, f), torch.Tensor) else getattr(s, f)).astype(np.int64)
        for f in ("head", "buf", "ptr", "underflows", "overflows")}


def _same_stack(p, r):
    a, b = _stack_words(p), _stack_words(r)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


# ---------------------------------------------------------------------------
# FactoredCategorical
# ---------------------------------------------------------------------------

def test_log_f32_is_xla_cpu_log():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(1, 600, 200_000), np.exp(rng.uniform(-87, 88, 200_000)),
        rng.uniform(0.5, 2, 100_000),
        [0.0, np.inf, -1.0, np.nan, 1e-40, 1.0, 2.0 ** -126]]
    ).astype(np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = xla_ndtr.log_f32(torch.from_numpy(x)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | \
        (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:8]


@pytest.mark.parametrize("vocab,chunk,lanes,steps", [
    (300, 64, 3, 6), (200, 256, 3, 6), (1000, 256, 4, 4),
    (151_936, 256, 2, 3)])
def test_factored_categorical_writes_the_reference_stack(vocab, chunk, lanes,
                                                         steps):
    rng = np.random.default_rng(vocab)
    logits = [(rng.normal(0, 3, (lanes, vocab))
               + rng.choice([0.0, 40.0], (lanes, 1))).astype(np.float32)
              for _ in range(steps)]
    syms = rng.integers(0, vocab, (steps, lanes)).astype(np.int32)
    with jax.threefry_partitionable(False):
        r = ref_container.fresh_stack(lanes, 64, seed=None)
    p = container.fresh_stack(lanes, 64, seed=None, device="cpu")
    r_jit = r
    push = ref_lm._jitted_push(16)
    for lg, s in zip(logits, syms):
        r = ref_dist.FactoredCategorical(jnp.asarray(lg), chunk).push(
            r, jnp.asarray(s))
        if chunk == 256:
            r_jit = push(r_jit, jnp.asarray(lg), jnp.asarray(s))
        p = distributions.FactoredCategorical(torch.from_numpy(lg),
                                              chunk).push(
            p, torch.from_numpy(s))
    _same_stack(p, r)
    if chunk == 256:
        _same_stack(p, r_jit)
    for lg, s in zip(reversed(logits), syms[::-1]):
        p, got = distributions.FactoredCategorical(
            torch.from_numpy(lg), chunk).pop(p)
        np.testing.assert_array_equal(got.numpy(), s)
    assert int(p.ptr.sum()) == 0 and int(p.underflows.sum()) == 0


def test_factored_categorical_log_prob():
    lg = np.random.default_rng(1).normal(0, 2, (3, 300)).astype(np.float32)
    sym = np.array([0, 150, 299])
    np.testing.assert_allclose(
        distributions.FactoredCategorical(torch.from_numpy(lg), 64)
        .log_prob(torch.from_numpy(sym)).numpy(),
        np.asarray(ref_dist.FactoredCategorical(jnp.asarray(lg), 64)
                   .log_prob(jnp.asarray(sym))), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _models(compute, seed=2, vocab=300):
    ref_cfg = dataclasses.replace(ref_base.reduced(ref_base.get(
        "qwen2-0.5b")), vocab=vocab, compute_dtype=compute)
    cfg = dataclasses.replace(base.reduced(base.get("qwen2-0.5b")),
                              vocab=vocab, compute_dtype=compute)
    with jax.threefry_partitionable(False):
        p = ref_transformer.init(jax.random.PRNGKey(seed), ref_cfg)
    tp = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                                 device="cpu")
    return ref_cfg, p, cfg, tp


def _tokens(lanes, n, vocab=300, seed=3):
    t = np.random.default_rng(seed).integers(0, vocab, (lanes, n)) \
        .astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


RATE_TOL = {"float32": 1e-3, "bfloat16": 1e-2}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_engine_compress_is_lossless_at_the_reference_rate(compute):
    ref_cfg, pj, cfg, pt = _models(compute)
    lanes, n = 3, 12
    tj, tt = _tokens(lanes, n)
    ref_blob = ref_engine.Engine(pj, ref_cfg, max_len=n,
                                 jit=False).compress(tj)
    eng = Engine(pt, cfg, max_len=n, jit=False, device="cpu")
    blob = eng.compress(tt)
    assert torch.equal(eng.decompress(blob, n), tt)
    assert eng.compress(tt) == blob
    bits = codecs.blob_info(blob)["payload_bits"]
    ref_bits = ref_codecs.blob_info(ref_blob)["payload_bits"]
    assert abs(bits - ref_bits) <= RATE_TOL[compute] * ref_bits, \
        (bits, ref_bits)
    # The coding bound: the rate sits on the model's cross-entropy.
    expected = lm_codec.expected_bits(pt, cfg, tt)
    assert bits == pytest.approx(expected + 32 * lanes, rel=0.03)


def test_engine_stream_round_trip_and_resume():
    ref_cfg, pj, cfg, pt = _models("float32")
    lanes, n, block = 2, 12, 4
    tj, tt = _tokens(lanes, n, seed=4)
    eng = Engine(pt, cfg, max_len=n, device="cpu")
    wire = eng.compress_stream(tt, block_symbols=block)
    assert torch.equal(eng.decompress_stream(wire), tt)
    _, offsets, _ = stream.format.scan(wire)
    assert len(offsets) == n // block
    tail = stream.decode_from_offset(None, wire, offsets[1],
                                     block_codec_fn=eng._block_codec_fn(),
                                     device="cpu")
    assert torch.equal(tail.T, tt[:, block:])
    ref_wire = ref_engine.Engine(pj, ref_cfg, max_len=n).compress_stream(
        tj, block_symbols=block)
    assert abs(len(wire) - len(ref_wire)) <= RATE_TOL["float32"] * \
        len(ref_wire) + 2, (len(wire), len(ref_wire))


def test_token_stream_codec_matches_the_reference_stack_at_f32():
    """Per-position logits within 1e-6 of the reference's give the same
    tables here, so the stacks agree word for word."""
    ref_cfg, pj, cfg, pt = _models("float32", seed=5)
    lanes, n = 2, 8
    tj, tt = _tokens(lanes, n, seed=6)
    got = lm_codec.collect_decoder_logits(pt, cfg, tt)
    want = ref_lm.collect_decoder_logits(pj, ref_cfg, tj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    r = ref_lm.encode_tokens(pj, ref_cfg, tj, ref_container.fresh_stack(
        lanes, 32, seed=None))
    p = lm_codec.encode_tokens(pt, cfg, tt, container.fresh_stack(
        lanes, 32, seed=None, device="cpu"))
    _same_stack(p, r)
    p, back = lm_codec.decode_tokens(pt, cfg, p, n)
    assert torch.equal(back, tt) and int(p.ptr.sum()) == 0


def test_generate_picks_the_reference_tokens_at_f32():
    ref_cfg, pj, cfg, pt = _models("float32", seed=1)
    tj, tt = _tokens(2, 6, seed=7)
    want = ref_engine.Engine(pj, ref_cfg, max_len=32, jit=False).generate(
        {"tokens": tj}, 8)
    eng = Engine(pt, cfg, max_len=32, device="cpu")
    got = eng.generate({"tokens": tt}, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(eng.generate({"tokens": tt}, 8), got)


def test_markov_corpus_is_the_reference_s():
    for seed, vocab in ((0, 64), (3, 256)):
        got, h = tokens.markov_corpus(3000, vocab=vocab, seed=seed)
        want, h_ref = ref_tokens.markov_corpus(3000, vocab=vocab, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert h == h_ref


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGS = ["--lanes", "2", "--tokens", "16", "--block-symbols", "8"]
NUM = r"([0-9.]+)"


def _ref_lines(mode, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--mode", mode] + ARGS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), jax.threefry_partitionable(False):
        ref_launch.main()
    return out.getvalue().splitlines()


def _port_lines(mode):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--mode", mode, "--device", "cpu"] + ARGS)
    return out.getvalue().splitlines()


def _shape(line):
    """The line with its numbers taken out."""
    return re.sub(NUM, "#", line)


@pytest.mark.parametrize("mode", ["compress", "stream", "generate"])
def test_launcher_prints_the_reference_lines(mode, monkeypatch):
    ref, got = _ref_lines(mode, monkeypatch), _port_lines(mode)
    assert [_shape(x) for x in got] == [_shape(x) for x in ref]
    if mode == "generate":
        assert got[0].startswith("generated (2, 16) in ")
        return
    assert all("lossless=True" in x for x in got)
    # The same numpy corpus; different random weights (torch.Generator
    # and jax.random draw differently), each near log2 V = 8 bits/tok.
    assert re.findall(r"entropy " + NUM, got[0]) == \
        re.findall(r"entropy " + NUM, ref[0])
    rate = lambda x: float(re.findall(NUM + " (?:wire )?bits/tok", x)[0])
    assert rate(got[0]) == pytest.approx(rate(ref[0]), rel=0.03)
    if mode == "stream":
        assert "mid-stream resume from block 1" in got[1]


@pytest.mark.parametrize("mode", ["serve-many", "hvae", "gateway",
                                  "cluster"])
def test_launcher_modes_of_the_batcher_name_their_item(mode):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        launch.main(["--mode", mode, "--device", "cpu"])


def test_engine_needs_a_dense_config():
    _, _, cfg, pt = _models("float32")
    with pytest.raises(NotImplementedError, match="item 8"):
        Engine(pt, dataclasses.replace(cfg, n_experts=4), device="cpu")
