"""A frozen copy of the port's threefry.py, the mock-scene draw: the JAX
package's mock-data draws, without JAX: JAX's threefry2x32
generator in its partitionable mode and the samplers the mock scene uses
(``uniform``, ``normal``, ``poisson``), then ``sample_prior``,
``constrain``, ``render_scene`` and ``make_mock_image`` as in
starcat/potential.py and starcat/scene.py.  Every
function keeps the name of its JAX counterpart
(jax/_src/prng.py, jax/_src/random.py).

A key is a pair of Python ints, the two uint32 words of JAX's raw key
data.  Words live in int64 tensors and are masked to 32 bits after every
add and shift, since torch's uint32 lacks those ops.  Everything runs on
the host CPU whatever the run's device is, so the draws never depend on
the card.

Floating point follows the float32 code that XLA compiles for the CPU,
op for op, so every draw is JAX's bit for bit, the render under the image
included: a multiply-add that XLA fuses is one rounding here too;
``exp``, ``log``, ``log1p`` and ``lgamma`` are XLA's own polynomials, not
the correctly rounded functions; subnormal results flush to zero; and the
render's contraction over stars runs in XLA's order.  Only IEEE 754's
basic operations, conversions and numpy's ``sqrt`` are used (torch's CPU
``sqrt`` may land an ulp off), so the bits do not depend on the torch
build or the host's vector units.
"""
from __future__ import annotations

import math

import numpy as np
import torch


MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = torch.float32
_F64 = torch.float64


def key(seed: int) -> tuple[int, int]:
    """jax.random.key(seed)'s raw data as JAX makes it with 64-bit types
    off: the seed is cast to 32 bits, so the high word is 0 and the low
    word the seed's low 32 bits (a negative seed in two's complement)."""
    return 0, seed & MASK


def threefry2x32(k: tuple[int, int], x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2),
    int64 tensors holding uint32 values, under key k."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) | (x2 >> (32 - r))) & MASK) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def iota_2x32_shape(shape) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-major 64-bit counter over ``shape`` as (high, low) words."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64).reshape(tuple(shape))
    return idx >> 32, idx & MASK


def split(k: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """jax.random.split(k, num): the fold-like split, key i being the hash
    of counter i."""
    b1, b2 = threefry2x32(k, *iota_2x32_shape((num,)))
    return list(zip(b1.tolist(), b2.tolist()))


def bits(k: tuple[int, int], shape) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): bits1 ^ bits2."""
    b1, b2 = threefry2x32(k, *iota_2x32_shape(shape))
    return b1 ^ b2


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c for float32 operands with one rounding, as XLA's fused
    multiply-add: the product is exact in float64, the sum is rounded to
    odd there (its error from 2Sum), and rounding that to float32 is then
    the correctly rounded result."""
    p = torch.as_tensor(a, dtype=_F64) * torch.as_tensor(b, dtype=_F64)
    c = torch.as_tensor(c, dtype=_F64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    sb = s.view(torch.int64)
    inexact_even = (err != 0) & ((sb & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(inexact_even, sb + step, sb).view(_F64).to(_F32)


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(np.float32(v))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's; torch's CPU sqrt may land
    an ulp away."""
    return torch.from_numpy(np.sqrt(x.numpy()))


# XLA's CPU float32 log (the Cephes polynomial, its multiply-adds fused)
_LOG_P = tuple(np.float32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log of a finite float32 tensor >= 0, bit for bit."""
    xi = torch.clamp_min(x, float(np.finfo(np.float32).tiny)).view(torch.int32)
    m = ((xi & ~0x7F800000) | 0x3F000000).view(_F32)     # mantissa in [0.5, 1)
    small = m < _f32(0.707106781186547524)
    e = 1.0 + ((xi >> 23) - 0x7F).to(_F32) - small.to(_F32)
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, t3, y1), t3, y2)
    y = _fma(y, t3, _f32(-2.12194440e-4) * e)
    t = ((t - 0.5 * t2) + y) + _f32(0.693359375) * e
    return torch.where(x == 0, -math.inf, t)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log1p: a Cephes rational function below sqrt(2) - 1 in
    magnitude, log(1 + x) above."""
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma(num, x, _f32(a))
        den = _fma(den, x, _f32(b))
    x2 = x * x
    small = x + _fma(_f32(-0.5), x2, (x * x2) * (num / den))
    return torch.where(torch.abs(x) < _f32(0.41421356237309504880), small,
                       _log(x + 1.0))


_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554706,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)


def _lgamma(x: torch.Tensor) -> torch.Tensor:
    """XLA's lgamma (Lanczos, g = 7) for x >= 0.5: every count the
    rejection loop can accept; below 0.5 it is only ever rejected."""
    z = x - 1.0
    log_t = _log1p(z * _f32(1.0 / 7.5)) + _f32(math.log(7.5))
    head = _fma((z + 0.5) - (z + 7.5) / log_t, log_t,
                _f32(0.5 * math.log(2.0 * math.pi)))
    series = _f32(_LANCZOS[0]) / (z + 1.0) + 1.0
    for i, c in enumerate(_LANCZOS[1:], start=2):
        series = series + _f32(c) / (z + float(i))
    return head + _log(series)


_EXP_P = tuple(np.float32(p) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_TINY = float(np.finfo(np.float32).tiny)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU code runs with subnormals flushed to zero."""
    return torch.where(torch.abs(x) < _TINY, torch.zeros_like(x), x)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU exp (the Cephes polynomial, e^a 2^n), bit for bit."""
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(_fma(x, _f32(1.44269504088896341), _f32(0.5))),
                    -127.0, 127.0)
    x = _fma(_f32(-0.693359375), n, x)
    x = _fma(_f32(2.12194440e-4), n, x)
    p = _EXP_P
    z = _fma(x, p[0], p[1])
    for c in p[2:]:
        z = _fma(z, x, c)
    z = 1.0 + _fma(z, x * x, x)
    pow2 = ((n.to(torch.int32) + 0x7F) << 23).view(_F32)
    return _ftz(z * pow2)


def uniform(k: tuple[int, int], shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in float32 on [minval, maxval)."""
    b = bits(k, shape)
    floats = (((b >> 9) | 0x3F800000).to(torch.int32).view(_F32)) - 1.0
    lo = torch.tensor(np.float32(minval))
    hi = torch.tensor(np.float32(maxval))
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: Giles' polynomials in w = -log1p(-x^2), the
    Horner steps fused.  |x| < 1."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    coef = [torch.where(lt, torch.tensor(np.float32(a)), torch.tensor(np.float32(b)))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return p * x


def normal(k: tuple[int, int], shape) -> torch.Tensor:
    """jax.random.normal in float32: sqrt(2) erf_inv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, float(lo), 1.0)
    return torch.tensor(np.float32(math.sqrt(2.0))) * erf_inv(u)


def _poisson_knuth(k: tuple[int, int], lam: torch.Tensor) -> torch.Tensor:
    count = torch.zeros(lam.shape, dtype=torch.int64)
    log_prod = torch.zeros(lam.shape, dtype=_F32)
    while bool((log_prod > -lam).any()):
        k, sub = split(k)
        count = torch.where(log_prod > -lam, count + 1, count)
        log_prod = log_prod + _log(uniform(sub, lam.shape))
    return count - 1


def _poisson_rejection(k: tuple[int, int], lam: torch.Tensor) -> torch.Tensor:
    log_lam = _log(lam)
    b = _fma(_f32(2.53), _sqrt(lam), _f32(0.931))
    a = _fma(_f32(0.02483), b, _f32(-0.059))
    # a scalar over a tensor is torch's reciprocal times the scalar: divide
    # by tensors, as XLA does
    inv_alpha = 1.1239 + _f32(1.1328) / (b - 3.4)
    v_r = 0.9277 - _f32(3.6224) / (b - 2)
    k_out = torch.full(lam.shape, -1.0, dtype=_F32)
    accepted = torch.zeros(lam.shape, dtype=torch.bool)
    while not bool(accepted.all()):
        k, sub0, sub1 = split(k, 3)
        u = uniform(sub0, lam.shape) - 0.5
        v = uniform(sub1, lam.shape)
        u_shifted = 0.5 - torch.abs(u)
        n = torch.floor(_fma(2 * a / u_shifted + b, u, lam) + 0.43)
        s = _log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = _fma(n, log_lam, -lam) - _lgamma(n + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (n < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, n, k_out)
        accepted |= accept
    return k_out.to(torch.int64)


def poisson(k: tuple[int, int], lam: torch.Tensor) -> torch.Tensor:
    """jax.random.poisson(k, lam) as int64 counts: Knuth's method below
    lam = 10 and Hormann's transformed rejection above, both run over the
    whole field on the same key with the stand-ins 0 and 1e5.  The
    rejection loop runs until every pixel has accepted once, and a later
    acceptance overwrites an earlier one, so the stand-ins set its length
    and with it every pixel's value."""
    lam = lam.detach().to("cpu", _F32)
    use_knuth = torch.isnan(lam) | (lam < 10)
    knuth = _poisson_knuth(k, torch.where(use_knuth, lam, torch.zeros_like(lam)))
    rejection = _poisson_rejection(
        k, torch.where(use_knuth, torch.full_like(lam, 1e5), lam))
    result = torch.where(use_knuth, knuth, rejection)
    return torch.where(lam == 0, torch.zeros_like(result), result)


def sample_prior(k: tuple[int, int], n: int, prior: PriorSpec) -> torch.Tensor:
    """starcat.potential.sample_prior: n stars' unconstrained parameters,
    (n, 3) float32, positions uniform, log flux normal."""
    kp, kf = split(k)
    u = uniform(kp, (n, 2), 1e-6, 1.0 - 1e-6)
    upos = _log(u / (1.0 - u))
    s = (torch.tensor(np.float32(prior.logf_mean))
         + torch.tensor(np.float32(prior.logf_sigma)) * normal(kf, (n,)))
    return torch.cat([upos, s[:, None]], dim=-1)


def constrain(theta: torch.Tensor, spec: SceneSpec):
    """starcat.potential.constrain of one (K, 3) catalog as XLA computes it:
    x = W sigmoid(ux), sigmoid(u) = 1 / (1 + exp(-u)), y likewise, f = exp(s)."""
    theta = theta.detach().to("cpu", _F32)

    def sigmoid(u):
        return _ftz(_f32(1.0) / (1.0 + _exp(-u)))

    return (spec.width * sigmoid(theta[:, 0]), spec.height * sigmoid(theta[:, 1]),
            _exp(theta[:, 2]))


def _profile(centers: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    z = ((torch.arange(n, dtype=_F32) + 0.5)[None, :] - centers[:, None]) / sigma
    norm = 1.0 / (math.sqrt(2.0 * math.pi) * sigma)
    return _ftz(_exp(-0.5 * z * z) * norm)


def render_scene(x: torch.Tensor, y: torch.Tensor, flux: torch.Tensor,
                 spec: SceneSpec) -> torch.Tensor:
    """starcat.scene.render_scene of one live catalog as XLA computes it:
    the separable profiles, then background + sum_k (gy_k flux_k) gx_k^T
    accumulated over k in order, each step one fused multiply-add."""
    gx = _profile(x, spec.width, spec.psf_sigma)
    gy = _ftz(_profile(y, spec.height, spec.psf_sigma) * flux[:, None])
    img = torch.zeros((spec.height, spec.width), dtype=_F32)
    for k in range(flux.shape[0]):
        img = _fma(gy[k][:, None], gx[k][None, :], img)
    return spec.background + img


def make_mock_image(k: tuple[int, int], x: torch.Tensor, y: torch.Tensor,
                    flux: torch.Tensor, spec: SceneSpec) -> torch.Tensor:
    """starcat.scene.make_mock_image: a Poisson draw of the rendered scene,
    (H, W) float32 counts."""
    x, y, flux = (t.detach().to("cpu", _F32) for t in (x, y, flux))
    return poisson(k, render_scene(x, y, flux, spec)).to(_F32)
