"""XLA-CPU's float32 ``ndtr``, ``sigmoid`` and ``log``, op for op, in
PyTorch.

``torch.special.ndtr`` is not the function the JAX reference evaluates:
over 2M float32 inputs it differs from ``jax.scipy.special.ndtr`` on about
half of them, and flips ``floor(c * (2^16 - 2^10))`` (a fixed-point CDF
start) on 0.31%. A Gaussian grid coded with it could not reproduce the
reference's wire. This module copies the sequence XLA's CPU backend
actually runs for ``jax.jit(ndtr)``: the graph from the optimised LLVM IR
(``XLA_FLAGS=--xla_dump_to=DIR``, ``*.ir-with-opt.ll``) and the fused
multiply-adds from the machine code in the same dump (``*.o``), because
XLA lets LLVM's backend fuse a multiply into the add that consumes it:

  * ``x = a * 0.70710677``; for ``|x| < 0.70710677`` the result is
    ``0.5 * (1 + erf(x))``, otherwise ``0.5 * erfc(|x|)`` (``x <= 0``) or
    ``0.5 * (2 - erfc(|x|))``;
  * ``erf`` is XLA's rational approximation over ``x`` clamped to
    +-3.7439213, Horner steps as fma;
  * ``erfc`` is JAX's Cephes set (three ranges, Horner steps as fma,
    ``1 - |x| * T`` as one fma) and ``exp`` is XLA's ``exp_f32``
    (Cody-Waite reduction and polynomial as fma, ``2^n`` from bits);
  * the multiplies that stay separate: ``x * x``, ``e * (1/|x|) * P``,
    ``x * P(x^2)``, ``r * r`` and the final ``* 0.5``;
  * XLA's CPU runtime flushes subnormal results to zero; the result is
    flushed the same way (earlier subnormals cannot reach a normal
    result: see ``_flush``).

An fma is emulated exactly (``fma_f32``). Every float32 constant is a
hex literal taken from the IR. ``kernels/common/ndtr.cuh`` holds the same
sequence line for line for the CUDA kernels, so the card and this twin
compute identical bits.

``jax.nn.sigmoid`` lowers to ``1 / (1 + exp(-x))`` (eager and jitted
alike): ``sigmoid_f32`` is that, with XLA's ``exp_f32``, one correctly
rounded division, and the subnormal results (``x`` in about
``[-88.72, -87.34]``, where ``exp(-x)`` nears the float32 maximum)
flushed to zero as XLA's CPU runtime flushes them. ``kernels/common/
xla_math.cuh`` holds the same sequence for the CUDA kernels.

``jnp.log`` (and the log inside ``jax.nn.logsumexp``, the LM coder's
chunk marginal) is Cephes' ``logf`` with its fma sites read from the
machine code: ``log_f32``, 0 differences over 3M inputs.
"""

from __future__ import annotations

import torch

_h = float.fromhex

HALF_SQRT2 = _h("0x1.6a09e6p-1")           # 0.70710677

# erf(x) = x * P(x^2) / Q(x^2), x clamped to +-ERF_CLAMP.
ERF_CLAMP = _h("0x1.df38dp+1")             # 3.7439213
ERF_P = (_h("0x1.e05aa2p-13"), _h("0x1.bebb44p-9"), _h("0x1.a16dd6p-5"),
         _h("0x1.7b4e8p-3"), _h("0x1.20dd74p+0"))
ERF_Q = (_h("-0x1.fa720cp-24"), _h("0x1.8b11bep-16"), _h("0x1.0ada5p-10"),
         _h("0x1.cd0fa8p-7"), _h("0x1.c69842p-4"), _h("0x1.fd6894p-2"),
         1.0)

# erfc, |x| < 1: 1 - |x| * T(z), z = x*x.
ERFC_T = (_h("0x1.496a32p-14"), _h("-0x1.a3f7p-11"), _h("0x1.5405b2p-8"),
          _h("-0x1.b7f90ep-6"), _h("0x1.ce2cf8p-4"), _h("-0x1.81273ep-2"),
          _h("0x1.20dd74p+0"))
# erfc, 1 <= |x| < 2: exp(-z) / |x| * P(1/z).
ERFC_P = (_h("0x1.7d39e8p-6"), _h("-0x1.1c10dp-3"), _h("0x1.7997ap-2"),
          _h("-0x1.2a39fp-1"), _h("0x1.3df3c6p-1"), _h("-0x1.fa518p-2"),
          _h("0x1.5ca8e2p-2"), _h("-0x1.18b1p-2"), _h("0x1.20adccp-1"))
# erfc, |x| >= 2: exp(-z) / |x| * R(1/z), R's first step being
# ``w * -10.477664 + 12.9772``.
ERFC_R0, ERFC_R1 = _h("0x1.4f4906p+3"), _h("0x1.9f4538p+3")
ERFC_R = (_h("-0x1.dfb694p+2"), _h("0x1.75e3f4p+1"), _h("-0x1.03e86cp+0"),
          _h("0x1.aff87cp-2"), _h("-0x1.20d8bap-2"), _h("0x1.20dd72p-1"))
ERFC_UNDERFLOW = _h("0x1.62e43p+6")        # 88.72284: z above -> 0

# XLA's exp_f32.
EXP_LO, EXP_HI = _h("-0x1.5f3334p+6"), _h("0x1.633334p+6")   # -87.8, 88.8
EXP_LOG2E = _h("0x1.715476p+0")
EXP_C1, EXP_C2 = _h("0x1.63p-1"), _h("-0x1.bd0106p-13")
EXP_P = (_h("0x1.a0d2cep-13"), _h("0x1.6e879cp-10"), _h("0x1.11121p-7"),
         _h("0x1.555382p-5"), _h("0x1.555554p-3"))

FLT_MIN = _h("0x1p-126")


def fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (IEEE fma) on any device.

    The float64 product of two float32 values is exact. The float64 sum
    is rounded to odd (TwoSum error term, then a step to the odd
    neighbour when the sum was inexact and landed on an even one), which
    makes the final rounding to float32 a single correct rounding: no
    double rounding. Inputs here are finite and far from overflow.
    """
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    x = torch.where(x < EXP_LO, torch.full_like(x, EXP_LO), x)
    x = torch.where(x > EXP_HI, torch.full_like(x, EXP_HI), x)
    fx = torch.floor(fma_f32(x, _full(x, EXP_LOG2E), 0.5))
    fx = torch.where(fx < -127.0, torch.full_like(fx, -127.0), fx)
    fx = torch.where(fx > 127.0, torch.full_like(fx, 127.0), fx)
    r = fma_f32(fx, _full(fx, -EXP_C1), x)
    r = fma_f32(fx, _full(fx, -EXP_C2), r)
    p = fma_f32(r, _full(r, EXP_P[0]), EXP_P[1])
    for c in EXP_P[2:] + (0.5,):
        p = fma_f32(p, r, c)
    p = fma_f32(p, r * r, r) + 1.0
    n = torch.nan_to_num(fx, nan=0.0).to(torch.int32)
    pow2 = ((n + 127) << 23).view(torch.float32)
    return p * pow2


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` on XLA-CPU (float32), bit for bit: purely
    elementwise, so a table built over any shape has the same bits."""
    x = x.float()
    return _flush(torch.reciprocal(1.0 + _exp_f32(-x)))


def _flush(v: torch.Tensor) -> torch.Tensor:
    """Subnormal -> signed zero, as XLA's CPU runtime computes.

    Only the result needs it: a subnormal intermediate (exp(-z) for
    z > 87.3, or x*x for |x| < 2^-63) only ever meets constants it cannot
    lift above 2^-126, or is added to 1 or 2 where it vanishes.
    """
    return torch.where(v.abs() < FLT_MIN, v * 0.0, v)


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def ndtr(a: torch.Tensor) -> torch.Tensor:
    """``jax.jit(jax.scipy.special.ndtr)`` on XLA-CPU, bit for bit."""
    a = a.float()
    x = a * HALF_SQRT2
    z = x * x
    w = torch.reciprocal(z)
    # 1 <= |x| < 2 and |x| >= 2 polynomials in w = 1/z.
    pp = fma_f32(w, _full(w, ERFC_P[0]), ERFC_P[1])
    for c in ERFC_P[2:]:
        pp = fma_f32(w, pp, c)
    pr = fma_f32(w, _full(w, -ERFC_R0), ERFC_R1)
    for c in ERFC_R:
        pr = fma_f32(w, pr, c)
    # |x| < 1 polynomial in z.
    pt = fma_f32(z, _full(z, ERFC_T[0]), ERFC_T[1])
    for c in ERFC_T[2:]:
        pt = fma_f32(z, pt, c)
    ax = x.abs()
    e = _exp_f32(-z)
    big = (e * torch.reciprocal(ax)) * torch.where(ax < 2.0, pp, pr)
    big = torch.where(z > ERFC_UNDERFLOW, torch.zeros_like(big), big)
    small = fma_f32(-ax, pt, 1.0)
    erfc = torch.where(ax < 1.0, small, big)
    # erf branch over the clamped argument (NaN passes through).
    xc = torch.clamp(x, -ERF_CLAMP, ERF_CLAMP)
    xc = torch.where(torch.isnan(x), x, xc)
    x2 = xc * xc
    num = fma_f32(x2, _full(x2, ERF_P[0]), ERF_P[1])
    for c in ERF_P[2:]:
        num = fma_f32(x2, num, c)
    den = fma_f32(x2, _full(x2, ERF_Q[0]), ERF_Q[1])
    for c in ERF_Q[2:]:
        den = fma_f32(x2, den, c)
    erf = (xc * num) / den
    upper = torch.where(x > 0, 2.0 - erfc, erfc)
    y = torch.where(ax < HALF_SQRT2, erf + 1.0, upper)
    return _flush(y * 0.5)


# XLA's log_f32: Cephes' logf (the reference's ``jnp.log`` and the log of
# ``jax.nn.logsumexp``), read from the dumped IR and machine code.
LOG_SQRTHF = _h("0x1.6a09e6p-1")           # 0.70710677
LOG_P = (_h("0x1.204376p-4"), _h("-0x1.d7a37p-4"), _h("0x1.de4a34p-4"),
         _h("-0x1.fcba9ep-4"), _h("0x1.23d37ep-3"), _h("-0x1.555ca0p-3"),
         _h("0x1.999d58p-3"), _h("-0x1.fffff8p-3"), _h("0x1.555554p-2"))
LOG_Q1, LOG_Q2 = _h("-0x1.bd0106p-13"), _h("0x1.63p-1")


def log_f32(a: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` on XLA-CPU (float32), bit for bit, eager and jitted.

    The argument is split into a mantissa ``m`` in [0.5, 1) and an
    exponent ``e`` (inputs below 2^-126 read as 2^-126); ``x = m - 1``,
    or ``2m - 1`` with ``e - 1`` when ``m < sqrt(1/2)``. Then, with
    ``x2 = x * x`` and ``x3 = x2 * x``, three Horner pairs as fma
    (``p0..p2``, ``p3..p5``, ``p6..p8``), joined by ``fma(y, x3, .)``; the
    last joins ``e * q1``; ``fma(-0.5, x2, x) + y``; and
    ``fma(q2, e, .)``. ``a <= 0`` or NaN gives NaN, 0 gives -inf and
    +inf gives +inf; a subnormal argument reads as 0, as XLA's CPU
    runtime reads it.
    """
    a = _flush(a.float())
    xc = torch.where(a <= FLT_MIN, torch.full_like(a, FLT_MIN), a)
    bits = xc.view(torch.int32)
    emm0 = torch.bitwise_right_shift(bits, 23) & 0x1FF
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    e = (emm0 - 127).float() + 1.0
    small = m < LOG_SQRTHF
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    y = fma_f32(fma_f32(_full(x, LOG_P[0]), x, LOG_P[1]), x, LOG_P[2])
    y1 = fma_f32(fma_f32(_full(x, LOG_P[3]), x, LOG_P[4]), x, LOG_P[5])
    y2 = fma_f32(fma_f32(_full(x, LOG_P[6]), x, LOG_P[7]), x, LOG_P[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * LOG_Q1)
    out = fma_f32(_full(x, -0.5), x2, x) + y
    out = fma_f32(_full(e, LOG_Q2), e, out)
    out = torch.where(a == 0, torch.full_like(a, float("-inf")), out)
    out = torch.where(a == float("inf"), a, out)
    return torch.where((a < 0) | torch.isnan(a),
                       torch.full_like(a, float("nan")), out)
