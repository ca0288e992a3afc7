"""Log-probability primitives in torch.

Counterpart of ``tensorbnn_tpu/distributions.py``. ``gaussian_logprob``
keeps that module's reference-exact normalization: sigma is clamped to
[1e-8, 1e8] and the log-determinant counts ``sigma.numel()`` dimensions,
while the quadratic form sums over every element of ``x``. With a scalar
sigma (the layer priors) the normalizer therefore counts one dimension per
block; with sigma broadcast to ``x``'s shape (the likelihoods) it is the
proper product density. ``exponential_logprob`` takes ``|rate|`` and
``bernoulli_logprob`` clips to [1e-8, 1 - 1e-7], as the reference does;
``categorical_logprob`` floors probabilities at 1e-8. Every function here
is written for one chain and batches over chains with
``torch.func.vmap``.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)

_SIGMA_MIN = 1e-8
_SIGMA_MAX = 1e8


def gaussian_logprob(sigma, mu, x):
    """Reference-exact Gaussian log probability; returns a scalar."""
    sigma = torch.as_tensor(sigma)
    x = torch.as_tensor(x)
    sigma = sigma.clamp(_SIGMA_MIN, _SIGMA_MAX)
    log_det = 2.0 * torch.sum(torch.log(sigma))
    k = float(sigma.numel())
    dif = (x - mu) / sigma
    quad = torch.sum(dif * dif)
    return -0.5 * (log_det + quad + k * LOG_2PI)


def normal_logprob(x, loc, scale):
    """Proper elementwise univariate normal log-density (hyperpriors)."""
    x = torch.as_tensor(x)
    z = (x - loc) / scale
    return -0.5 * (z * z) - math.log(scale) - 0.5 * LOG_2PI


def cauchy_logprob(gamma, x0, x):
    """Proper elementwise Cauchy log-density."""
    z = (x - x0) / gamma
    return -torch.log1p(z * z) - torch.log(math.pi * gamma)


def cauchy_logprob_compat(gamma, x0, x):
    """The reference's sign-flipped Cauchy "log prob" (its first term has
    the opposite sign of the true log-density)."""
    z = (x - x0) / gamma
    return torch.log1p(z * z) - torch.log(math.pi * gamma)


def _clip(x, lo: float, hi: float):
    """``jnp.clip``'s arithmetic and gradient: max then min, so at a tie
    with a bound the gradient splits in half (``torch.clamp`` passes it
    whole)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def exponential_logprob(rate, x):
    """Elementwise exponential log-density with ``|rate|`` (the reference
    passes the rate through abs() rather than constraining it)."""
    rate = torch.as_tensor(rate).abs()
    return -rate * torch.as_tensor(x) + torch.log(rate)


def bernoulli_logprob(probs, y):
    """Elementwise Bernoulli log pmf, probabilities clipped to [1e-8,
    1 - 1e-7]."""
    p = _clip(torch.as_tensor(probs), 1e-8, 1.0 - 1e-7)
    y = torch.as_tensor(y)
    return y * torch.log(p) + (1.0 - y) * torch.log1p(-p)


def categorical_logprob(probs, labels):
    """Per-row categorical log pmf of probability rows ``probs (..., k)``,
    floored at 1e-8. ``labels`` are integer class ids ``(...,)`` or
    one-hot rows ``(..., k)``: one-hot only when the trailing axis matches
    the class count, so an ``(N, 1)`` column of ids is taken as ids."""
    p = _clip(torch.as_tensor(probs), 1e-8, 1.0)
    labels = torch.as_tensor(labels)
    if labels.ndim == p.ndim and labels.shape[-1] == p.shape[-1]:
        return torch.sum(labels * torch.log(p), dim=-1)
    ids = labels.reshape(p.shape[:-1]).long()
    return torch.log(torch.gather(p, -1, ids[..., None]))[..., 0]
