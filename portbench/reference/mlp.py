"""The plain reference of the sampled models, in PyTorch and float64.

Written from the models' published semantics (the reference tensorBNN's
layers and likelihoods), independent of the program under test: it
imports nothing of it. A configuration file (``configs/<name>.json``)
describes the stack as a list of layers and a likelihood; this module
evaluates, batched over chains:

* the forward pass ``f(theta, x)``;
* the main potential ``log p(theta | eta) + log p(y | f, eta)``, the
  target of the main HMC block, and its gradient in theta;
* the hyper potential ``log p(eta) + log p(theta | eta)`` (plus the data
  term where the likelihood's noise scale is sampled), the target of the
  hyper HMC block, and its gradient in eta.

The flat layouts are the ones the program documents for its states: per
dense layer the bias, then the row-major ``(in, out)`` weights; per
SquarePrelu its slopes; the hypers per layer in sorted-name order (dense
``b_loc, b_scale, w_loc, w_scale``; SquarePrelu ``loc, scale``), then the
likelihood's (``sd_root``, whose square is the noise sd).

Densities, as the reference defines them: a layer's Gaussian prior has sd
``scale ** 2`` (SquarePrelu: ``scale``) and counts the normaliser of one
dimension per block; hyperpriors are proper normals (dense: N(0, 0.1) on
the locations and N(1, 0.1) on the squared scales; SquarePrelu: N(0, 0.3)
on the location and N(0.3, 0.1) on the scale, and in the hyper block the
slopes enter squared); sigmas are clamped to [1e-8, 1e8]; Bernoulli
probabilities are clipped to [1e-8, 1 - 1e-7]; these bounds are taken as
the float32 numbers that the configurations' float32 states.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
# the bounds as the configurations' float32 states them
SIGMA_MIN, SIGMA_MAX = float(np.float32(1e-8)), float(np.float32(1e8))
P_MIN, P_MAX = float(np.float32(1e-8)), float(np.float32(1.0 - 1e-7))


class Stack:
    """The configuration's stack: offsets of each layer's blocks in the
    flat theta and eta, and the potentials over ``(C, D)`` / ``(C, H)``
    blocks. ``dtype`` is the arithmetic's type (float64 for the
    reference, bfloat16 for the control)."""

    def __init__(self, config: dict, dtype=torch.float64):
        self.dtype = dtype
        self.layers: List[dict] = []
        d = h = 0
        for spec in config["layers"]:
            kind = spec["kind"]
            layer = {"kind": kind}
            if kind == "dense":
                i, o = spec["in"], spec["out"]
                layer.update(n_in=i, n_out=o, b=(d, d + o),
                             w=(d + o, d + o + i * o), hyper=h)
                d += o + i * o
                h += 4
            elif kind == "squareprelu":
                n = spec["width"]
                layer.update(width=n, slopes=(d, d + n), hyper=h)
                d += n
                h += 2
            elif kind not in ("tanh", "sigmoid"):
                raise ValueError(f"unknown layer kind {kind!r}")
            self.layers.append(layer)
        self.likelihood = dict(config["likelihood"])
        self.sd_index = None
        if self.likelihood["kind"] == "gaussian_learned":
            self.sd_index = h
            h += 1
        elif self.likelihood["kind"] not in ("gaussian_fixed", "bernoulli"):
            raise ValueError(f"unknown likelihood {self.likelihood['kind']!r}")
        self.D, self.H = d, h

    # -- forward ---------------------------------------------------------
    def forward(self, theta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``(C, N, out)`` outputs of the C networks at ``x (N, in)``."""
        theta = theta.to(self.dtype)
        x = x.to(self.dtype)
        c = theta.shape[0]
        out = None
        for layer in self.layers:
            kind = layer["kind"]
            if kind == "dense":
                i, o = layer["n_in"], layer["n_out"]
                w = theta[:, layer["w"][0]:layer["w"][1]].reshape(c, i, o)
                b = theta[:, layer["b"][0]:layer["b"][1]]
                if out is None:
                    # the shared input against every chain's weights in one
                    # product
                    out = (x @ w.permute(1, 0, 2).reshape(i, c * o)).reshape(
                        -1, c, o).permute(1, 0, 2) + b[:, None, :]
                else:
                    out = torch.baddbmm(b[:, None, :], out, w)
            elif kind == "tanh":
                out = torch.tanh(out)
            elif kind == "sigmoid":
                out = torch.sigmoid(out)
            else:
                s = theta[:, layer["slopes"][0]:layer["slopes"][1]]
                out = torch.where(out < 0, (s * s)[:, None, :] * out, out)
        return out

    # -- densities -------------------------------------------------------
    @staticmethod
    def _gauss_block(sd, loc, x):
        """Per chain: the reference's Gaussian log density of a block ``x
        (C, n)`` under one scalar ``sd (C,)`` and ``loc (C,)``, with the
        normaliser of one dimension."""
        sd = sd.clamp(SIGMA_MIN, SIGMA_MAX)
        z = (x - loc[:, None]) / sd[:, None]
        return -0.5 * (2.0 * torch.log(sd) + (z * z).sum(-1) + LOG_2PI)

    @staticmethod
    def _normal(x, loc, scale):
        z = (x - loc) / scale
        return -0.5 * z * z - math.log(scale) - 0.5 * LOG_2PI

    def log_prior(self, theta, eta):
        """``(C,)``: the layers' conditional priors of theta at eta."""
        total = 0.0
        for layer in self.layers:
            kind, k = layer["kind"], layer.get("hyper")
            if kind == "dense":
                b_loc, b_scale, w_loc, w_scale = (eta[:, k + j]
                                                  for j in range(4))
                total = total + self._gauss_block(
                    w_scale * w_scale, w_loc,
                    theta[:, layer["w"][0]:layer["w"][1]])
                total = total + self._gauss_block(
                    b_scale * b_scale, b_loc,
                    theta[:, layer["b"][0]:layer["b"][1]])
            elif kind == "squareprelu":
                loc, scale = eta[:, k], eta[:, k + 1]
                total = total + self._gauss_block(
                    scale, loc, theta[:, layer["slopes"][0]:layer["slopes"][1]])
        return total

    def hyper_stats(self, theta) -> list:
        """The blocks' sufficient statistics ``(n, sum x, sum x^2)`` (each
        ``(C,)``) that the hyper block's conditional priors read: per dense
        layer its weights and its biases, per SquarePrelu its squared
        slopes."""
        theta = theta.detach().to(self.dtype)
        out = []

        def block(x):
            out.append((x.shape[-1], x.sum(-1), (x * x).sum(-1)))

        for layer in self.layers:
            if layer["kind"] == "dense":
                block(theta[:, layer["w"][0]:layer["w"][1]])
                block(theta[:, layer["b"][0]:layer["b"][1]])
            elif layer["kind"] == "squareprelu":
                s = theta[:, layer["slopes"][0]:layer["slopes"][1]]
                block(s * s)
        return out

    @staticmethod
    def _gauss_stats(sd, loc, stats):
        """``_gauss_block`` from a block's ``(n, sum x, sum x^2)``."""
        n, s1, s2 = stats
        sd = sd.clamp(SIGMA_MIN, SIGMA_MAX)
        quad = (s2 - 2.0 * loc * s1 + n * loc * loc) / (sd * sd)
        return -0.5 * (2.0 * torch.log(sd) + quad + LOG_2PI)

    def log_hyper_prior(self, eta, stats):
        """``(C,)``: the hyperpriors and the conditional priors as the
        hyper block sees them, from ``hyper_stats(theta)``."""
        total = 0.0
        blocks = iter(stats)
        for layer in self.layers:
            kind, k = layer["kind"], layer.get("hyper")
            if kind == "dense":
                b_loc, b_scale, w_loc, w_scale = (eta[:, k + j]
                                                  for j in range(4))
                total = total + self._normal(w_loc, 0.0, 0.1) \
                    + self._normal(w_scale * w_scale, 1.0, 0.1) \
                    + self._normal(b_loc, 0.0, 0.1) \
                    + self._normal(b_scale * b_scale, 1.0, 0.1)
                total = total + self._gauss_stats(w_scale * w_scale, w_loc,
                                                  next(blocks))
                total = total + self._gauss_stats(b_scale * b_scale, b_loc,
                                                  next(blocks))
            elif kind == "squareprelu":
                loc, scale = eta[:, k], eta[:, k + 1]
                total = total + self._gauss_stats(scale, loc, next(blocks)) \
                    + self._normal(loc, 0.0, 0.3) \
                    + self._normal(scale, 0.3, 0.1)
        return total

    def noise_sd(self, eta) -> Optional[torch.Tensor]:
        """``(C,)`` Gaussian noise sd (None for a Bernoulli likelihood)."""
        kind = self.likelihood["kind"]
        if kind == "gaussian_fixed":
            return torch.full((eta.shape[0],), float(self.likelihood["sd"]),
                              dtype=eta.dtype, device=eta.device)
        if kind == "gaussian_learned":
            root = eta[:, self.sd_index]
            return root * root
        return None

    def log_likelihood(self, theta, eta, x, y):
        """``(C,)``: the data log-likelihood over the rows ``x``, ``y``."""
        f = self.forward(theta, x)
        y = y.to(self.dtype).reshape(1, *f.shape[1:])
        if self.likelihood["kind"] == "bernoulli":
            p = f.clamp(P_MIN, P_MAX)
            return (y * torch.log(p) + (1.0 - y) * torch.log1p(-p)).sum(
                dim=(1, 2))
        sd = self.noise_sd(eta).clamp(SIGMA_MIN, SIGMA_MAX)
        n = f.shape[1] * f.shape[2]
        r = ((y - f) ** 2).sum(dim=(1, 2))
        return -0.5 * (2.0 * n * torch.log(sd) + r / (sd * sd)
                       + n * LOG_2PI)

    def gaussian_loglik_from_rss(self, eta, rss, n):
        """The Gaussian log-likelihood at a residual sum of squares ``rss
        (C,)`` over ``n`` outputs: the hyper block's data term, where theta
        (and so the residuals) stay fixed."""
        sd = self.noise_sd(eta).clamp(SIGMA_MIN, SIGMA_MAX)
        return -0.5 * (2.0 * n * torch.log(sd) + rss / (sd * sd)
                       + n * LOG_2PI)

    def residual_power(self, theta, x, y, rows: int):
        """``(rss (C,), n)``: the residual sum of squares over ``x``, ``y``
        in blocks of ``rows`` rows."""
        rss = torch.zeros(theta.shape[0], dtype=self.dtype,
                          device=theta.device)
        n = 0
        with torch.no_grad():
            for i in range(0, x.shape[0], rows):
                f = self.forward(theta, x[i:i + rows])
                yy = y[i:i + rows].to(self.dtype).reshape(1, *f.shape[1:])
                rss += ((yy - f) ** 2).sum(dim=(1, 2))
                n += f.shape[1] * f.shape[2]
        return rss, n

    # -- potentials and gradients ------------------------------------------
    def main_value_grad(self, theta, eta, x, y, rows: int):
        """``(lp (C,), grad (C, D))`` of the main potential, the data term
        summed over blocks of ``rows`` rows (so that a block's activations
        fit on the card)."""
        theta = theta.detach().to(self.dtype).requires_grad_(True)
        eta = eta.detach().to(self.dtype)
        lp = self.log_prior(theta, eta)
        (grad,) = torch.autograd.grad(lp.sum(), theta)
        value = lp.detach()
        for i in range(0, x.shape[0], rows):
            ll = self.log_likelihood(theta, eta, x[i:i + rows], y[i:i + rows])
            (g,) = torch.autograd.grad(ll.sum(), theta)
            grad = grad + g
            value = value + ll.detach()
        return value, grad

    def hyper_value_grad(self, eta, stats, rss=None, n=None):
        """``(lp (C,), grad (C, H))`` of the hyper potential at fixed
        theta, given by its ``hyper_stats``; ``rss``/``n``
        (``residual_power``) carry the data term of a sampled noise
        scale."""
        eta = eta.detach().to(self.dtype).requires_grad_(True)
        lp = self.log_hyper_prior(eta, stats)
        if self.sd_index is not None:
            lp = lp + self.gaussian_loglik_from_rss(eta, rss.to(self.dtype),
                                                    n)
        (grad,) = torch.autograd.grad(lp.sum(), eta)
        return lp.detach(), grad
