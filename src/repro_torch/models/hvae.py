"""Hierarchical ResNet-VAE with a Bit-Swap codec (port of
``repro.models.hvae``).

An L-level Markov latent hierarchy x <- z_1 <- ... <- z_L with fully
convolutional residual stages, so one parameter set codes images of any
even H x W. Inference: q(z_1|x) is a stride-2 stem conv and a stage;
q(z_l|z_{l-1}) a stage at the latent resolution. Generation: p(z_{l-1}|z_l)
a stage; p(x|z_1) a stage, a stride-2 transpose conv and a head;
p(z_L) = N(0, I). Every latent lives on an [H/2, W/2, z_ch] grid and every
conditional is a diagonal Gaussian coded over the shared max-entropy
N(0, 1) buckets (``core.discretize``).

Tensors are the reference's layout at every public function: images
[lanes, H, W], latents and activations NHWC, weights HWIO in the
reference's parameter tree (``weights.from_jax_params`` carries the
reference's own across). Convolutions reproduce XLA's ``SAME`` padding
(``codecs.quantize.same_pad`` / ``transpose_pad``).

Codecs: ``make_bitswap_codec`` runs the float networks eagerly inside a
``codecs.BitSwap`` (``use_bucketize_kernel=True`` decodes each latent
position through the bucketize kernel, ``KernelDiscretizedGaussian``;
``compiled=True`` lowers the leaves onto the grid kernels);
``make_bitswap_codec_q`` quantizes the networks and hands
``FixedPointFn`` layers to ``codecs.compile``, which fuses them. The
fixed-point codec writes the reference's bytes on the same weights.

Float convolutions run in full float32 on the card: the model pins cuDNN
to deterministic, non-benchmarked, TF32-free algorithms around its own
convolutions (``conv_flags``, scoped) and hands them contiguous NCHW
inputs, so that encoder and decoder compute the same bits. Card and CPU
still round differently (ROADMAP H10): a float-model blob decodes on the
kind of device that wrote it. The beta-binomial likelihood is not ported
yet (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import codecs
from repro_torch import device as dev
from repro_torch.codecs import quantize
from repro_torch.core import ans, discretize
from repro_torch.core.distributions import Bernoulli
from repro_torch.kernels.bucketize import ops as bucketize_ops
from repro_torch.optim.adamw import tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class HVAEConfig:
    """Shape-free model spec: no image size anywhere."""

    levels: int = 2
    in_channels: int = 1
    ch: int = 32
    z_ch: int = 4
    n_res: int = 1
    likelihood: str = "bernoulli"
    lat_bits: int = 10
    precision: int = 16
    obs_precision: int = 16

    def __post_init__(self):
        if self.likelihood == "beta_binomial":
            raise NotImplementedError(
                "HVAEConfig: the 'beta_binomial' likelihood is not ported "
                "yet (BetaBinomial: ROADMAP queue 1, item 3)")
        if self.likelihood != "bernoulli":
            raise ValueError(f"HVAEConfig: unknown likelihood "
                             f"{self.likelihood!r}")

    def latent_shape(self, hw: Tuple[int, int]) -> Tuple[int, int, int]:
        """Latent grid for an H x W image: (H/2, W/2, z_ch)."""
        h, w = hw
        if h % 2 or w % 2:
            raise ValueError(
                f"hvae: image dims must be even (got {h}x{w}); pad with "
                "data.images.pad_to_even")
        return h // 2, w // 2, self.z_ch


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    w = torch.randn((kh, kw, cin, cout), generator=gen,
                    dtype=torch.float32) * math.sqrt(2.0 / (kh * kw * cin))
    return {"w": w.to(device),
            "b": torch.zeros((cout,), dtype=torch.float32, device=device)}


@contextlib.contextmanager
def conv_flags() -> Iterator[None]:
    """cuDNN pinned for the body, restored after: deterministic, not
    benchmarked (the algorithm must not change between encode and
    decode), full float32 (no TF32). The model's own scoped setting."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        yield


def _conv_nchw(x: torch.Tensor, w: torch.Tensor, stride: int,
               b: torch.Tensor) -> torch.Tensor:
    # Contiguous NCHW input and OIHW weight always, so encode and decode
    # hand cuDNN the same layout (another layout may take another
    # algorithm, which sums in another order).
    with conv_flags():
        out = F.conv2d(x.contiguous(), w.permute(3, 2, 0, 1).contiguous(),
                       stride=stride)
    return out.permute(0, 2, 3, 1) + b


def _conv(p: Dict[str, torch.Tensor], x: torch.Tensor,
          stride: int = 1) -> torch.Tensor:
    """NHWC conv with HWIO weights, XLA ``SAME`` padding."""
    kh, kw = p["w"].shape[:2]
    return _conv_nchw(quantize.same_pad(x.permute(0, 3, 1, 2), kh, kw,
                                        stride), p["w"], stride, p["b"])


def _deconv(p: Dict[str, torch.Tensor], x: torch.Tensor,
            stride: int = 2) -> torch.Tensor:
    """NHWC transpose conv, ``SAME``: an exact x``stride`` upsample, as
    ``jax.lax.conv_transpose`` computes it (zero-dilated input, (2, 1)
    padding, the unflipped kernel)."""
    kh, kw = p["w"].shape[:2]
    return _conv_nchw(quantize.transpose_pad(x.permute(0, 3, 1, 2), kh, kw,
                                             stride), p["w"], 1, p["b"])


def _resblock_init(gen, ch, device):
    return {"c1": _conv_init(gen, 3, 3, ch, ch, device),
            "c2": _conv_init(gen, 3, 3, ch, ch, device)}


def _resblock(p, x):
    h = _conv(p["c1"], torch.relu(x))
    h = _conv(p["c2"], torch.relu(h))
    return x + h


def _stage_init(gen, cin, ch, cout, n_res, device):
    """conv in -> n_res resblocks -> conv head."""
    return {"in": _conv_init(gen, 3, 3, cin, ch, device),
            "res": [_resblock_init(gen, ch, device) for _ in range(n_res)],
            "head": _conv_init(gen, 3, 3, ch, cout, device)}


def _stage(p, x):
    h = _conv(p["in"], x)
    for rp in p["res"]:
        h = _resblock(rp, h)
    return _conv(p["head"], torch.relu(h))


def init(cfg: HVAEConfig, generator: torch.Generator, *,
         device: dev.DeviceLike = None) -> Params:
    """He-normal weights, zero biases, drawn on the CPU from ``generator``
    and moved to ``device``; the reference's tree, image-size
    independent. (The reference's distribution, not its numbers: convert
    its weights with ``weights.from_jax_params``.)"""
    device = dev.resolve(device)
    g, c, z = generator, cfg.ch, cfg.z_ch
    params: Params = {
        "enc_stem": _conv_init(g, 3, 3, cfg.in_channels, c, device),
        "q1": _stage_init(g, c, c, 2 * z, cfg.n_res, device),
        "p_obs": {
            "stage": _stage_init(g, z, c, c, cfg.n_res, device),
            "up": _conv_init(g, 3, 3, c, c, device),
            "out": _conv_init(g, 3, 3, c, cfg.in_channels, device),
        },
    }
    for level in range(2, cfg.levels + 1):
        params[f"q{level}"] = _stage_init(g, z, c, 2 * z, cfg.n_res, device)
        params[f"p{level}"] = _stage_init(g, z, c, 2 * z, cfg.n_res, device)
    return params


# ---------------------------------------------------------------------------
# conditionals
# ---------------------------------------------------------------------------

def _split_mu_sigma(out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mu, logvar = out.chunk(2, dim=-1)
    return mu, torch.exp(0.5 * torch.clamp(logvar, -10.0, 10.0))


def _norm_input(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x[..., None] if x.dim() == 3 else x


def infer_z1(params: Params, cfg: HVAEConfig, x: torch.Tensor):
    """x int[lanes, H, W] -> q(z_1|x) = (mu, sigma) [lanes, H/2, W/2,
    z_ch]."""
    h = _conv(params["enc_stem"], _norm_input(x), stride=2)
    return _split_mu_sigma(_stage(params["q1"], torch.relu(h)))


def infer_up(params: Params, cfg: HVAEConfig, level: int,
             z_prev: torch.Tensor):
    """q(z_level | z_{level-1}) from z_{level-1} values (level >= 2)."""
    return _split_mu_sigma(_stage(params[f"q{level}"], z_prev))


def gen_down(params: Params, cfg: HVAEConfig, level: int, z: torch.Tensor):
    """p(z_{level-1} | z_level) from z_level values (level >= 2)."""
    return _split_mu_sigma(_stage(params[f"p{level}"], z))


def decode_obs(params: Params, cfg: HVAEConfig,
               z1: torch.Tensor) -> torch.Tensor:
    """z_1 values [lanes, h, w, z_ch] -> Bernoulli logits [lanes, H, W]."""
    p = params["p_obs"]
    h = _stage(p["stage"], z1)
    h = _deconv(p["up"], torch.relu(h), stride=2)
    return _conv(p["out"], torch.relu(h))[..., 0]


def obs_log_prob(cfg: HVAEConfig, obs_params: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Sum of log p(x|z_1) over pixels -> float32[lanes]."""
    xf = x.to(torch.float32)
    lp = xf * F.logsigmoid(obs_params) + (1.0 - xf) * F.logsigmoid(
        -obs_params)
    return lp.sum(dim=(1, 2))


def _gauss_logpdf(z, mu, sigma):
    return (-0.5 * ((z - mu) / sigma) ** 2 - torch.log(sigma)
            - 0.5 * math.log(2.0 * math.pi))


# ---------------------------------------------------------------------------
# training objective
# ---------------------------------------------------------------------------

def elbo(params: Params, cfg: HVAEConfig,
         generator: Optional[torch.Generator], x: torch.Tensor,
         eps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Per-example ELBO in nats, float32[lanes]; -ELBO is the expected
    Bit-Swap message length (up to the discretization penalty). The
    reparameterization noise of level l is ``eps[l-1]`` when given, else
    drawn from ``generator`` on the parameters' device."""
    zs: List[torch.Tensor] = []
    logq = 0.0
    mu, sigma = infer_z1(params, cfg, x)
    for level in range(1, cfg.levels + 1):
        noise = eps[level - 1] if eps is not None else torch.randn(
            mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        z = mu + sigma * noise
        logq = logq + _gauss_logpdf(z, mu, sigma).sum(dim=(1, 2, 3))
        zs.append(z)
        if level < cfg.levels:
            mu, sigma = infer_up(params, cfg, level + 1, z)
    logp = obs_log_prob(cfg, decode_obs(params, cfg, zs[0]), x)
    for level in range(2, cfg.levels + 1):
        mu, sigma = gen_down(params, cfg, level, zs[level - 1])
        logp = logp + _gauss_logpdf(zs[level - 2], mu,
                                    sigma).sum(dim=(1, 2, 3))
    prior = -0.5 * zs[-1] ** 2 - 0.5 * math.log(2.0 * math.pi)  # N(0, 1)
    return logp + prior.sum(dim=(1, 2, 3)) - logq


def elbo_bits_per_dim(params: Params, cfg: HVAEConfig,
                      generator: Optional[torch.Generator], x: torch.Tensor,
                      eps: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
    n_dims = x.shape[1] * x.shape[2]
    return -torch.mean(elbo(params, cfg, generator, x, eps)) / (
        n_dims * math.log(2.0))


def loss(params: Params, cfg: HVAEConfig,
         generator: Optional[torch.Generator], x: torch.Tensor,
         eps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    return -torch.mean(elbo(params, cfg, generator, x, eps))


# ---------------------------------------------------------------------------
# Bit-Swap codec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelDiscretizedGaussian(codecs.DiscretizedGaussian):
    """``DiscretizedGaussian`` whose pop asks the bucketize op for (idx,
    start, freq) in one call - the CUDA kernel on the card - and then
    advances the state. Push is inherited. The op and the plain bisection
    give the same integers, so the two leaves read each other's bytes."""

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        slot = ans.peek(stack, self.precision)
        idx, start, freq = bucketize_ops.bucketize(
            slot, self.mu, self.sigma, self.bits, self.precision)
        return ans.pop_update(stack, start, freq, self.precision), idx


def _gaussian_grid_codec(cfg: HVAEConfig, mu: torch.Tensor,
                         sigma: torch.Tensor, use_kernel: bool
                         ) -> codecs.Codec:
    """A latent grid as flat bucket indices [lanes, n]: one Gaussian leaf
    per position over the shared N(0, 1) buckets, (mu, sigma) from the
    context (Bit-Swap's dynamic discretization)."""
    lanes = mu.shape[0]
    mu_f = mu.reshape(lanes, -1)
    sg_f = sigma.reshape(lanes, -1)
    leaf = KernelDiscretizedGaussian if use_kernel \
        else codecs.DiscretizedGaussian
    return codecs.Repeat(
        lambda d: leaf(mu_f[:, d], sg_f[:, d], cfg.lat_bits, cfg.precision),
        mu_f.shape[1])


def _centres(cfg: HVAEConfig, idx: torch.Tensor,
             lat_hw: Tuple[int, int, int]) -> torch.Tensor:
    """Flat bucket indices [lanes, n] -> latent values [lanes, h, w, c]."""
    vals = discretize.bucket_centre(idx, cfg.lat_bits)
    return vals.reshape((idx.shape[0],) + lat_hw)


def _uniform_prior(cfg: HVAEConfig, n_lat: int) -> codecs.Codec:
    return codecs.Repeat(
        lambda d: codecs.Uniform(cfg.lat_bits, cfg.precision), n_lat)


def make_bitswap_codec(params: Params, cfg: HVAEConfig,
                       hw: Tuple[int, int], *,
                       use_bucketize_kernel: bool = False,
                       compiled: bool = False) -> codecs.Codec:
    """The float HVAE as a ``codecs.BitSwap`` for H x W images: symbols
    int[lanes, H, W], latents flat bucket indices int32[lanes, (H/2) *
    (W/2) * z_ch]. ``use_bucketize_kernel`` decodes every latent position
    through the bucketize op (one launch each on the card);
    ``compiled=True`` returns ``codecs.compile`` of it (the networks stay
    eager, their leaves lowered onto the grid and table kernels at each
    call). All three write the same bytes on one device."""
    h, w = hw
    lat_hw = cfg.latent_shape(hw)
    uk = use_bucketize_kernel
    params = tree_map(lambda t: t.detach(), params)

    def posterior1(x):
        mu, sigma = infer_z1(params, cfg, x)
        return _gaussian_grid_codec(cfg, mu, sigma, uk)

    def likelihood1(z1_idx):
        logits = decode_obs(params, cfg, _centres(cfg, z1_idx, lat_hw))
        logits = logits.reshape(logits.shape[0], -1)
        return codecs.Shaped(codecs.Repeat(
            lambda d: Bernoulli(logits[:, d], cfg.obs_precision), h * w),
            (h, w))

    layers = [(posterior1, likelihood1)]
    for level in range(2, cfg.levels + 1):
        def posterior_l(z_prev_idx, _level=level):
            mu, sigma = infer_up(params, cfg, _level,
                                 _centres(cfg, z_prev_idx, lat_hw))
            return _gaussian_grid_codec(cfg, mu, sigma, uk)

        def likelihood_l(z_idx, _level=level):
            mu, sigma = gen_down(params, cfg, _level,
                                 _centres(cfg, z_idx, lat_hw))
            return _gaussian_grid_codec(cfg, mu, sigma, uk)

        layers.append((posterior_l, likelihood_l))

    n_lat = lat_hw[0] * lat_hw[1] * lat_hw[2]
    swap = codecs.BitSwap(prior=_uniform_prior(cfg, n_lat),
                          layers=tuple(layers))
    return codecs.compile(swap) if compiled else swap


# ---------------------------------------------------------------------------
# fixed-point inference and the fused Bit-Swap codec
# ---------------------------------------------------------------------------

def quantize_model(params: Params, cfg: HVAEConfig,
                   qcfg: quantize.QuantConfig = quantize.QuantConfig()
                   ) -> Params:
    """int64 fixed-point weights and biases of every conv, on the
    parameters' device."""
    del cfg
    device = params["enc_stem"]["w"].device
    return quantize.quantize_params(params, qcfg, device)


def _stage_q(pq: Params, x_q: torch.Tensor,
             qcfg: quantize.QuantConfig) -> torch.Tensor:
    """Fixed-point ``_stage``."""
    h = quantize.conv_q(pq["in"], x_q, qcfg)
    for rp in pq["res"]:
        r = quantize.conv_q(rp["c1"], quantize.relu_q(h), qcfg)
        r = quantize.conv_q(rp["c2"], quantize.relu_q(r), qcfg)
        h = torch.clamp(h + r, -qcfg.act_clip, qcfg.act_clip)
    return quantize.conv_q(pq["head"], quantize.relu_q(h), qcfg)


def _gaussian_head_q(out_q: torch.Tensor, qcfg: quantize.QuantConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A quantized stage head -> flat float32 (mu, sigma) [lanes, n]."""
    mu_q, lv_q = out_q.chunk(2, dim=-1)
    mu, sigma = quantize.gaussian_head(mu_q, lv_q, qcfg)
    lanes = mu.shape[0]
    return mu.reshape(lanes, -1), sigma.reshape(lanes, -1)


def infer_z1_q(qparams: Params, cfg: HVAEConfig,
               qcfg: quantize.QuantConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-point q(z_1|x): x int[lanes, H, W] -> flat (mu, sigma)."""
    x_q = quantize.quantize_input(x, qcfg)[..., None]
    h = quantize.conv_q(qparams["enc_stem"], x_q, qcfg, stride=2)
    return _gaussian_head_q(_stage_q(qparams["q1"], quantize.relu_q(h),
                                     qcfg), qcfg)


def _latent_grid_q(cfg: HVAEConfig, qcfg: quantize.QuantConfig,
                   idx: torch.Tensor,
                   lat_hw: Tuple[int, int, int]) -> torch.Tensor:
    """Flat bucket indices [lanes, n] -> int64 Q(act) [lanes, h, w, c]."""
    vals = quantize.latent_centres_q(idx, cfg.lat_bits, qcfg)
    return vals.reshape((idx.shape[0],) + lat_hw)


def stage_gaussian_q(qparams: Params, cfg: HVAEConfig,
                     qcfg: quantize.QuantConfig, name: str,
                     idx: torch.Tensor, lat_hw: Tuple[int, int, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-point q(z_l|z_{l-1}) or p(z_{l-1}|z_l) from bucket indices."""
    z_q = _latent_grid_q(cfg, qcfg, idx, lat_hw)
    return _gaussian_head_q(_stage_q(qparams[name], z_q, qcfg), qcfg)


def decode_obs_freq1_q(qparams: Params, cfg: HVAEConfig,
                       qcfg: quantize.QuantConfig, idx: torch.Tensor,
                       lat_hw: Tuple[int, int, int]) -> torch.Tensor:
    """Fixed-point p(x|z_1): bucket indices -> int64 [lanes, H*W]
    fixed-point frequency of pixel = 1."""
    p = qparams["p_obs"]
    z_q = _latent_grid_q(cfg, qcfg, idx, lat_hw)
    h = _stage_q(p["stage"], z_q, qcfg)
    h = quantize.deconv_q(p["up"], quantize.relu_q(h), qcfg, stride=2)
    logit_q = quantize.conv_q(p["out"], quantize.relu_q(h), qcfg)[..., 0]
    f1 = quantize.bernoulli_head(logit_q, cfg.obs_precision, qcfg)
    return f1.reshape(f1.shape[0], -1)


def make_bitswap_codec_q(params: Params, cfg: HVAEConfig,
                         hw: Tuple[int, int], *,
                         qcfg: quantize.QuantConfig = quantize.QuantConfig(),
                         compiled: bool = False) -> codecs.Codec:
    """The quantized HVAE as a ``BitSwap`` over ``FixedPointFn`` layers
    (HiLLoC-style); ``compiled=True`` returns ``codecs.compile`` of it,
    which fuses the schedule onto the kernels. Both write the same bytes,
    and the reference's ``make_bitswap_codec_q`` bytes on the same
    weights."""
    h, w = hw
    lat_hw = cfg.latent_shape(hw)
    n_lat = lat_hw[0] * lat_hw[1] * lat_hw[2]
    qp = quantize_model(params, cfg, qcfg)

    def gauss_fn(fn):
        return quantize.FixedPointFn(fn, "gaussian", n_lat, cfg.lat_bits,
                                     cfg.precision)

    posterior1 = gauss_fn(lambda x: infer_z1_q(qp, cfg, qcfg, x))
    likelihood1 = quantize.FixedPointFn(
        lambda idx: decode_obs_freq1_q(qp, cfg, qcfg, idx, lat_hw),
        "bernoulli", h * w, 0, cfg.obs_precision, (h, w))
    layers = [(posterior1, likelihood1)]
    for level in range(2, cfg.levels + 1):
        layers.append((
            gauss_fn(lambda idx, _l=level: stage_gaussian_q(
                qp, cfg, qcfg, f"q{_l}", idx, lat_hw)),
            gauss_fn(lambda idx, _l=level: stage_gaussian_q(
                qp, cfg, qcfg, f"p{_l}", idx, lat_hw)),
        ))
    swap = codecs.BitSwap(prior=_uniform_prior(cfg, n_lat),
                          layers=tuple(layers))
    return codecs.compile(swap) if compiled else swap


def codec_family(params: Params, cfg: HVAEConfig, **kwargs):
    """``shape -> Codec``: the float codec for per-lane images [H, W] of
    any even shape (one model, any image size)."""
    def make(shape: Tuple[int, ...]) -> codecs.Codec:
        if len(shape) != 2:
            raise ValueError(
                f"hvae: expected per-lane symbols [H, W], got shape "
                f"{shape}")
        return make_bitswap_codec(params, cfg, (shape[0], shape[1]),
                                  **kwargs)
    return make
