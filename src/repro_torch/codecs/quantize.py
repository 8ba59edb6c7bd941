"""Fixed-point model inference (port of ``repro.codecs.quantize``).

A quantized network computes the same integers on every device and in
every evaluation order, so the codec compiler may run it inside the fused
coder program. The operation set: integer add/multiply/matmul, gathers
from host-built lookup tables, arithmetic right shifts, integer clips,
and the int -> float32 conversion of values below 2^24 followed by a
power-of-two multiply (both exact).

Tables are built with numpy float64 exactly as the reference builds them
(``sigma_table``, ``freq1_table``; ``centre_q_table`` from the committed
centre table) and cached per device.

PyTorch has no integer matmul or convolution on CUDA, so ``dense_q``,
``conv_q`` and ``deconv_q`` multiply in float64 (an im2col copy and a
matmul for the convolutions), which is exact: every partial sum
stays far inside float64's 2^53 integer range, so any summation order
gives the same integer. cuDNN is not used for them: its float64
algorithms may include an FFT, which is not exact. The convolutions
reproduce XLA's ``SAME`` padding (``same_pad``, ``transpose_pad``), which
torch's symmetric ``padding=`` cannot express.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as dev
from repro_torch.core import ans, discretize
from repro_torch.core.codec import Codec
from repro_torch.codecs import combinators as C
from repro_torch.codecs import leaves as L


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Fixed-point format: fractional bits and integer clip bounds.

    With ``|act| <= act_clip = 2^11`` and ``|w| <= w_clip = 2^9``, a
    1024-input dense layer accumulates at most 2^30 before the shift back
    down; biases are clipped to 2^30.
    """

    act_bits: int = 6
    w_bits: int = 6
    act_clip: int = 1 << 11
    w_clip: int = 1 << 9
    logit_range: float = 16.0
    logvar_range: float = 10.0


def _r(q: QuantConfig, value_range: float) -> int:
    return int(round(value_range * (1 << q.act_bits)))


@functools.lru_cache(maxsize=None)
def _sigma_np(act_bits: int, logvar_range: float) -> np.ndarray:
    r = int(round(logvar_range * (1 << act_bits)))
    lv = np.arange(-r, r + 1, dtype=np.float64) * (2.0 ** -act_bits)
    return np.exp(0.5 * lv).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _freq1_np(precision: int, act_bits: int,
              logit_range: float) -> np.ndarray:
    total = 1 << precision
    r = int(round(logit_range * (1 << act_bits)))
    logit = np.arange(-r, r + 1, dtype=np.float64) * (2.0 ** -act_bits)
    p = np.reciprocal(1.0 + np.exp(-logit))
    return (np.rint(p * (total - 2)) + 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _centre_q_np(lat_bits: int, act_bits: int, act_clip: int) -> np.ndarray:
    c = discretize.centre_table(lat_bits, "cpu").numpy().astype(np.float64)
    return np.clip(np.rint(c * float(1 << act_bits)), -act_clip,
                   act_clip).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _on(fn: Callable, args: Tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fn(*args).copy()).to(device)


def sigma_table(q: QuantConfig, device: dev.DeviceLike = None) -> torch.Tensor:
    """``exp(0.5 * lv)`` on the quantized logvar grid, float32[2R+1]."""
    return _on(_sigma_np, (q.act_bits, q.logvar_range), dev.resolve(device))


def freq1_table(precision: int, q: QuantConfig,
                device: dev.DeviceLike = None) -> torch.Tensor:
    """Bernoulli fixed-point frequency of symbol 1 on the quantized logit
    grid, int64[2R+1], each in [1, 2^precision - 1]."""
    return _on(_freq1_np, (precision, q.act_bits, q.logit_range),
               dev.resolve(device))


def centre_q_table(lat_bits: int, q: QuantConfig,
                   device: dev.DeviceLike = None) -> torch.Tensor:
    """The bucket centres as int64 Q(act_bits) latent values."""
    return _on(_centre_q_np, (lat_bits, q.act_bits, q.act_clip),
               dev.resolve(device))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def quantize_weight(w: Any, q: QuantConfig,
                    device: dev.DeviceLike = None) -> torch.Tensor:
    """float weights -> int64 Q(w_bits), clipped to +-w_clip."""
    wq = np.clip(np.rint(_np64(w) * float(1 << q.w_bits)), -q.w_clip,
                 q.w_clip)
    return torch.from_numpy(wq.astype(np.int64)).to(dev.resolve(device))


def quantize_bias(b: Any, q: QuantConfig,
                  device: dev.DeviceLike = None) -> torch.Tensor:
    """float biases -> int64 at the accumulator scale Q(act + w bits)."""
    scale = float(1 << (q.act_bits + q.w_bits))
    bq = np.clip(np.rint(_np64(b) * scale), -(1 << 30), 1 << 30)
    return torch.from_numpy(bq.astype(np.int64)).to(dev.resolve(device))


def _np64(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def quantize_params(params: Any, q: QuantConfig,
                    device: dev.DeviceLike = None) -> Any:
    """Quantize a tree (dicts, lists, tuples) of ``{"w", "b"}`` dense or
    conv layer dicts onto ``device``."""
    device = dev.resolve(device)
    if isinstance(params, dict) and set(params) == {"w", "b"}:
        return {"w": quantize_weight(params["w"], q, device),
                "b": quantize_bias(params["b"], q, device)}
    if isinstance(params, dict):
        return {k: quantize_params(v, q, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_params(v, q, device) for v in params)
    raise TypeError(
        f"quantize_params: expected a tree of dense/conv layer dicts, got "
        f"{type(params).__name__}")


# ---------------------------------------------------------------------------
# fixed-point forward ops
# ---------------------------------------------------------------------------

def requantize(acc: torch.Tensor, q: QuantConfig) -> torch.Tensor:
    """Accumulator Q(act+w) -> activation Q(act): arithmetic shift (floor
    division by 2^w_bits), then clip."""
    return torch.clamp(acc >> q.w_bits, -q.act_clip, q.act_clip)


def dense_q(pq: Dict[str, torch.Tensor], x_q: torch.Tensor,
            q: QuantConfig) -> torch.Tensor:
    """int Q(act)[lanes, n_in] @ Q(w) -> Q(act)[lanes, n_out].

    PyTorch has no integer matmul on CUDA, so the product runs in
    float64, which is exact here: every product is below 2^11 * 2^9 = 2^20
    and ``QuantConfig`` keeps every partial sum below 2^31 (2^30 for a
    1024-input layer), far inside float64's 2^53 integer range, so any
    summation order gives the same integer.
    """
    acc = (x_q.to(torch.float64) @ pq["w"].to(torch.float64)) \
        .to(torch.int64)
    return requantize(acc + pq["b"], q)


def same_pad(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """NCHW ``x`` padded as XLA pads a ``SAME`` convolution: the output is
    ceil(size / stride), the odd padding row or column at the bottom or
    right (a stride-2 3x3 conv over an even size pads 0 above, 1 below)."""
    pads = []
    for size, k in ((x.shape[3], kw), (x.shape[2], kh)):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def transpose_pad(x: torch.Tensor, kh: int, kw: int,
                  stride: int) -> torch.Tensor:
    """NCHW ``x`` as ``jax.lax.conv_transpose(..., padding="SAME")``
    convolves it: zero-dilated by ``stride``, then padded (k + s - 2 split
    ``ceil`` before, rest after; k - 1 before when s > k - 1). A stride-1
    convolution of the result with the *unflipped* kernel is the
    transpose convolution (a 3x3 kernel at stride 2 pads (2, 1))."""
    n, c, h, w = x.shape
    z = x.new_zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
    z[:, :, ::stride, ::stride] = x
    pads = []
    for k in (kw, kh):
        total = k + stride - 2
        lo = k - 1 if stride > k - 1 else -(-total // 2)
        pads += [lo, total - lo]
    return F.pad(z, pads)


def _conv_exact(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Integer conv of padded NCHW ``x`` with HWIO ``w`` (no padding) as a
    float64 im2col matmul, exact: -> int64 NHWC. The columns are one copy
    of ``Tensor.unfold``'s windows view (``F.unfold`` on CUDA launches one
    im2col kernel per image: 1024 per convolution at 1024 lanes)."""
    kh, kw, cin, cout = w.shape
    n = x.shape[0]
    win = x.to(torch.float64).unfold(2, kh, stride).unfold(3, kw, stride)
    ho, wo = win.shape[2], win.shape[3]
    cols = win.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, cin * kh * kw)
    wm = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return (cols @ wm.to(torch.float64)).reshape(n, ho, wo, cout) \
        .to(torch.int64)


def conv_q(pq: Dict[str, torch.Tensor], x_q: torch.Tensor, q: QuantConfig,
           stride: int = 1) -> torch.Tensor:
    """Integer NHWC convolution, HWIO weights, XLA ``SAME`` padding (the
    quantized ``hvae._conv``): Q(act) -> Q(act)."""
    kh, kw = pq["w"].shape[:2]
    x = same_pad(x_q.permute(0, 3, 1, 2), kh, kw, stride)
    return requantize(_conv_exact(x, pq["w"], stride) + pq["b"], q)


def deconv_q(pq: Dict[str, torch.Tensor], x_q: torch.Tensor, q: QuantConfig,
             stride: int = 2) -> torch.Tensor:
    """Integer NHWC transpose convolution, ``SAME`` (the quantized
    ``hvae._deconv``): an exact x``stride`` upsample."""
    kh, kw = pq["w"].shape[:2]
    x = transpose_pad(x_q.permute(0, 3, 1, 2), kh, kw, stride)
    return requantize(_conv_exact(x, pq["w"], 1) + pq["b"], q)


def relu_q(x_q: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x_q, min=0)


def gaussian_head(mu_q: torch.Tensor, logvar_q: torch.Tensor,
                  q: QuantConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized (mu, logvar) -> float32 (mu, sigma): an exact scale and a
    table gather."""
    mu = mu_q.to(torch.float32) * float(2.0 ** -q.act_bits)
    r = _r(q, q.logvar_range)
    sigma = sigma_table(q, mu_q.device)[torch.clamp(logvar_q + r, 0, 2 * r)]
    return mu, sigma


def bernoulli_head(logit_q: torch.Tensor, precision: int,
                   q: QuantConfig) -> torch.Tensor:
    """Quantized logits -> int64 fixed-point frequency of symbol 1."""
    r = _r(q, q.logit_range)
    return freq1_table(precision, q, logit_q.device)[
        torch.clamp(logit_q + r, 0, 2 * r)]


def latent_centres_q(idx: torch.Tensor, lat_bits: int,
                     q: QuantConfig) -> torch.Tensor:
    """Bucket indices -> int64 Q(act) latent values."""
    k = 1 << lat_bits
    return centre_q_table(lat_bits, q, idx.device)[
        torch.clamp(idx.long(), 0, k - 1)]


def quantize_input(s: torch.Tensor, q: QuantConfig) -> torch.Tensor:
    """Binarized observations {0, 1} -> int64 Q(act), exactly."""
    return s.to(torch.int64) << q.act_bits


# ---------------------------------------------------------------------------
# the LUT-Bernoulli leaf and the fusion marker
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LutBernoulli(Codec):
    """Bernoulli coded from a fixed-point frequency of symbol 1
    (``f1`` in [1, 2^precision - 1]): symbol 0 is [0, f0), 1 is
    [f0, 2^precision)."""

    f1: torch.Tensor
    precision: int = ans.DEFAULT_PRECISION

    def _freqs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        f1 = self.f1.to(torch.int64)
        return (1 << self.precision) - f1, f1

    def push(self, stack: ans.ANSStack, sym: torch.Tensor) -> ans.ANSStack:
        f0, f1 = self._freqs()
        is1 = sym.bool()
        start = torch.where(is1, f0, 0)
        return ans.push(stack, start, torch.where(is1, f1, f0),
                        self.precision)

    def pop(self, stack: ans.ANSStack) -> Tuple[ans.ANSStack, torch.Tensor]:
        f0, f1 = self._freqs()
        is1 = ans.peek(stack, self.precision) >= f0
        start = torch.where(is1, f0, 0)
        stack = ans.pop_update(stack, start, torch.where(is1, f1, f0),
                               self.precision)
        return stack, is1.to(torch.int32)


FAMILIES = ("gaussian", "bernoulli")


@dataclasses.dataclass(frozen=True)
class FixedPointFn:
    """A codec-child builder whose parameters are computed in fixed point.

    ``fn(ctx)`` gives ``(mu, sigma)`` float32[lanes, n] (family
    ``gaussian``, coded as ``DiscretizedGaussian`` on the ``bits`` grid)
    or ``f1`` int[lanes, n] (family ``bernoulli``, coded as
    ``LutBernoulli``). Calling the instance builds the interpreted twin, a
    ``Repeat`` of leaves; ``codecs.compile`` recognizes the marker and
    fuses the model forward with the kernels instead. Both write the same
    bytes. ``shape`` presents the flat [lanes, n] symbols as [lanes,
    *shape] (images); empty for flat latent grids.
    """

    fn: Callable[[Any], Any]
    family: str
    n: int
    bits: int = 0
    precision: int = ans.DEFAULT_PRECISION
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(
                f"FixedPointFn: unknown family {self.family!r} "
                f"(expected one of {FAMILIES})")
        if self.family == "gaussian" and self.bits <= 0:
            raise ValueError(
                "FixedPointFn: the gaussian family needs grid bits > 0")

    def params(self, ctx: Any) -> Any:
        return self.fn(ctx)

    def __call__(self, ctx: Any) -> Codec:
        if self.family == "gaussian":
            mu, sigma = self.fn(ctx)
            inner: Codec = C.Repeat(
                lambda d: L.DiscretizedGaussian(
                    mu[:, d], sigma[:, d], self.bits, self.precision),
                self.n)
        else:
            f1 = self.fn(ctx)
            inner = C.Repeat(
                lambda d: LutBernoulli(f1[:, d], self.precision), self.n)
        return C.Shaped(inner, self.shape) if self.shape else inner
