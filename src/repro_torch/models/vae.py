"""The paper's VAE (section 3.1-3.2) and its BB-ANS codecs (port of
``repro.models.vae``).

Fully-connected, ReLU, diagonal-Gaussian posterior, N(0, 1) prior; the
binarized-MNIST configuration is 784-100-40 with Bernoulli pixels.
Parameters are plain dicts ``{layer: {"w": [n_in, n_out], "b": [n_out]}}``
of float32 tensors, the reference's tree (``weights.from_jax_params``
carries the reference's own across).

Two codecs: ``make_bb_codec`` runs the float network (``encode`` /
``decode``) eagerly and codes its outputs through ``DiscretizedGaussian``
and ``Bernoulli`` leaves, which ``codecs.compile`` lowers onto the grid
and table kernels; ``make_bb_codec_q`` quantizes the network and returns
``BBANS`` over ``FixedPointFn`` children, which ``codecs.compile`` fuses.

The float matmuls are ``torch.matmul``, in full float32 on the card: the
model pins TF32 off around its own products (``_ieee_fp32``), scoped, and
hands them row-major inputs, so that the encoder and the decoder of a
blob compute the same bits. Card
and CPU still round differently (ROADMAP H10), so a float-model blob
decodes on the kind of device that wrote it. The beta-binomial
likelihood is not ported yet (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch import codecs
from repro_torch import device as dev
from repro_torch.codecs import quantize
from repro_torch.core import discretize
from repro_torch.core.distributions import Bernoulli

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

    @property
    def obs_symbols(self) -> int:
        return 2 if self.likelihood == "bernoulli" else 256


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


def _need_bernoulli(cfg: VAEConfig, what: str) -> None:
    if cfg.likelihood != "bernoulli":
        raise NotImplementedError(
            f"vae.{what}: the {cfg.likelihood!r} likelihood is not ported "
            "yet (BetaBinomial: ROADMAP queue 1, item 3)")


@contextlib.contextmanager
def _ieee_fp32() -> Iterator[None]:
    """Full float32 matmuls on the card (TF32 off) for the body, restored
    after: the model's own scoped setting, never a process-wide one."""
    mm = torch.backends.cuda.matmul
    name = "fp32_precision" if hasattr(mm, "fp32_precision") \
        else "allow_tf32"
    old = getattr(mm, name)
    setattr(mm, name, "ieee" if name == "fp32_precision" else False)
    try:
        yield
    finally:
        setattr(mm, name, old)


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    # Row-major input always: cuBLAS takes a transposed operand through
    # another kernel, which sums in another order, so a decoder handed the
    # transposed view a lowered pop returns would not compute the
    # encoder's bits.
    with _ieee_fp32():
        return torch.matmul(x.contiguous(), p["w"]) + p["b"]


def _norm_input(cfg: VAEConfig, s: torch.Tensor) -> torch.Tensor:
    scale = 1.0 if cfg.likelihood == "bernoulli" else 255.0
    return s.to(torch.float32) / scale


def encode(params: Params, cfg: VAEConfig,
           s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """s int[lanes, input_dim] -> (mu, sigma), each float32[lanes,
    latent]."""
    h = torch.relu(_dense(params["enc_h"], _norm_input(cfg, s)))
    mu = _dense(params["enc_mu"], h)
    logvar = torch.clamp(_dense(params["enc_logvar"], h), -10.0, 10.0)
    return mu, torch.exp(0.5 * logvar)


def decode(params: Params, cfg: VAEConfig, y: torch.Tensor) -> torch.Tensor:
    """y float[lanes, latent] -> Bernoulli logits float32[lanes,
    input_dim]."""
    _need_bernoulli(cfg, "decode")
    h = torch.relu(_dense(params["dec_h"], y))
    return _dense(params["dec_out"], h)


def obs_log_prob(cfg: VAEConfig, obs_params: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Sum of log p(s | y) over pixels -> float32[lanes]."""
    _need_bernoulli(cfg, "obs_log_prob")
    lp = Bernoulli(obs_params.reshape(-1)).log_prob(
        s.reshape(-1).to(torch.float32))
    return lp.reshape(s.shape).sum(-1)


def elbo(params: Params, cfg: VAEConfig,
         generator: Optional[torch.Generator], s: torch.Tensor,
         eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example ELBO in nats, float32[lanes]; -ELBO is the expected
    BB-ANS message length (paper eq. 1-2). The reparameterization noise
    is ``eps`` when given, else drawn from ``generator`` (on the
    parameters' device)."""
    mu, sigma = encode(params, cfg, s)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
    y = mu + sigma * eps
    recon = obs_log_prob(cfg, decode(params, cfg, y), s)
    kl = 0.5 * torch.sum(mu ** 2 + sigma ** 2 - 1.0 - 2.0 * torch.log(sigma),
                         dim=-1)
    return recon - kl


def elbo_bits_per_dim(params: Params, cfg: VAEConfig,
                      generator: Optional[torch.Generator], s: torch.Tensor,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    return -torch.mean(elbo(params, cfg, generator, s, eps)) / (
        cfg.input_dim * math.log(2.0))


def loss(params: Params, cfg: VAEConfig,
         generator: Optional[torch.Generator], s: torch.Tensor,
         eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    return -torch.mean(elbo(params, cfg, generator, s, eps))


def make_bb_codec(params: Params, cfg: VAEConfig, *,
                  compiled: bool = False) -> codecs.Codec:
    """The float VAE as a ``codecs.BBANS`` codec. The latent is carried as
    bucket indices int32[lanes, latent] under the max-entropy
    discretization of the prior; the network consumes bucket centres.
    ``compiled=True`` returns ``codecs.compile`` of it: the networks stay
    eager and the leaves they parameterize are lowered onto the kernels
    at each call. Both write the same bytes on one device."""
    _need_bernoulli(cfg, "make_bb_codec")
    params = {k: {n: t.detach() for n, t in v.items()}
              for k, v in params.items()}

    def posterior(s):
        mu, sigma = encode(params, cfg, s)
        return codecs.Repeat(
            lambda d: codecs.DiscretizedGaussian(
                mu[:, d], sigma[:, d], cfg.lat_bits, cfg.precision),
            cfg.latent)

    def likelihood(idx):
        y = discretize.bucket_centre(idx, cfg.lat_bits)
        logits = decode(params, cfg, y)
        return codecs.Repeat(
            lambda d: Bernoulli(logits[:, d], cfg.obs_precision),
            cfg.input_dim)

    prior = codecs.Repeat(
        lambda d: codecs.Uniform(cfg.lat_bits, cfg.precision), cfg.latent)
    bb = codecs.BBANS(prior=prior, likelihood=likelihood,
                      posterior=posterior)
    return codecs.compile(bb) if compiled else bb


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
