"""The paper's VAE (section 3.1-3.2) in fixed point, as a BB-ANS codec
(port of the fixed-point half of ``repro.models.vae``).

Fully-connected, ReLU, diagonal-Gaussian posterior, N(0, 1) prior; the
binarized-MNIST configuration is 784-100-40 with Bernoulli pixels.
Parameters are plain dicts ``{layer: {"w": [n_in, n_out], "b": [n_out]}}``
of float32 tensors; ``make_bb_codec_q`` quantizes them and returns
``BBANS`` over ``FixedPointFn`` children, which ``codecs.compile`` fuses.
The float model (``encode``/``decode``/``elbo``/``make_bb_codec``) and
training are not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import codecs
from repro_torch import device as dev
from repro_torch.codecs import quantize

Params = Dict[str, Any]

LAYERS = ("enc_h", "enc_mu", "enc_logvar", "dec_h", "dec_out")


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    input_dim: int = 784
    hidden: int = 100
    latent: int = 40
    likelihood: str = "bernoulli"  # or "beta_binomial"
    lat_bits: int = 10
    precision: int = 16
    obs_precision: int = 16


def paper_config(likelihood: str) -> VAEConfig:
    """The paper's two configurations."""
    if likelihood == "bernoulli":
        return VAEConfig(hidden=100, latent=40, likelihood="bernoulli")
    if likelihood == "beta_binomial":
        return VAEConfig(hidden=200, latent=50, likelihood="beta_binomial")
    raise ValueError(likelihood)


def _shapes(cfg: VAEConfig) -> Dict[str, Tuple[int, int]]:
    out_mult = 1 if cfg.likelihood == "bernoulli" else 2
    return {"enc_h": (cfg.input_dim, cfg.hidden),
            "enc_mu": (cfg.hidden, cfg.latent),
            "enc_logvar": (cfg.hidden, cfg.latent),
            "dec_h": (cfg.latent, cfg.hidden),
            "dec_out": (cfg.hidden, cfg.input_dim * out_mult)}


def init(cfg: VAEConfig, generator: torch.Generator, *,
         device: dev.DeviceLike = None) -> Params:
    """He-normal weights (std sqrt(2 / n_in)), zero biases, drawn on the
    CPU from ``generator`` and moved to ``device``. (Same distribution as
    the reference's ``init``, not the same numbers: to run the reference's
    weights, convert them with ``repro_torch.weights.from_jax_params``.)"""
    device = dev.resolve(device)
    params = {}
    for name, (n_in, n_out) in _shapes(cfg).items():
        w = torch.randn((n_in, n_out), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / n_in)
        params[name] = {"w": w.to(device),
                        "b": torch.zeros((n_out,), dtype=torch.float32,
                                         device=device)}
    return params


def quantize_model(params: Params, cfg: VAEConfig,
                   qcfg: quantize.QuantConfig = quantize.QuantConfig()
                   ) -> Params:
    """int64 fixed-point weights and biases, on the parameters' device."""
    del cfg
    device = params["enc_h"]["w"].device
    return quantize.quantize_params(params, qcfg, device)


def encode_q(qparams: Params, cfg: VAEConfig, qcfg: quantize.QuantConfig,
             s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """s int[lanes, input_dim] -> float32 (mu, sigma) [lanes, latent]."""
    x_q = quantize.quantize_input(s, qcfg)
    h = quantize.relu_q(quantize.dense_q(qparams["enc_h"], x_q, qcfg))
    mu_q = quantize.dense_q(qparams["enc_mu"], h, qcfg)
    lv_q = quantize.dense_q(qparams["enc_logvar"], h, qcfg)
    return quantize.gaussian_head(mu_q, lv_q, qcfg)


def decode_freq1_q(qparams: Params, cfg: VAEConfig,
                   qcfg: quantize.QuantConfig,
                   idx: torch.Tensor) -> torch.Tensor:
    """Bucket indices int[lanes, latent] -> int64[lanes, input_dim]
    fixed-point frequency of pixel = 1."""
    y_q = quantize.latent_centres_q(idx, cfg.lat_bits, qcfg)
    h = quantize.relu_q(quantize.dense_q(qparams["dec_h"], y_q, qcfg))
    logit_q = quantize.dense_q(qparams["dec_out"], h, qcfg)
    return quantize.bernoulli_head(logit_q, cfg.obs_precision, qcfg)


def make_bb_codec_q(params: Params, cfg: VAEConfig, *,
                    qcfg: quantize.QuantConfig = quantize.QuantConfig(),
                    compiled: bool = False) -> codecs.Codec:
    """The quantized VAE as a ``BBANS`` codec; ``compiled=True`` returns
    ``codecs.compile`` of it. Both write the same bytes, and the same
    bytes as the reference's ``make_bb_codec_q`` on the same weights."""
    if cfg.likelihood != "bernoulli":
        raise ValueError(
            "make_bb_codec_q: fixed-point inference supports the "
            f"bernoulli likelihood only (got {cfg.likelihood!r})")
    qp = quantize_model(params, cfg, qcfg)
    posterior = quantize.FixedPointFn(
        lambda s: encode_q(qp, cfg, qcfg, s),
        "gaussian", cfg.latent, cfg.lat_bits, cfg.precision)
    likelihood = quantize.FixedPointFn(
        lambda idx: decode_freq1_q(qp, cfg, qcfg, idx),
        "bernoulli", cfg.input_dim, 0, cfg.obs_precision)
    prior = codecs.Repeat(
        lambda d: codecs.Uniform(cfg.lat_bits, cfg.precision), cfg.latent)
    bb = codecs.BBANS(prior=prior, likelihood=likelihood,
                      posterior=posterior)
    return codecs.compile(bb) if compiled else bb
