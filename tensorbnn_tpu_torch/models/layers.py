"""Bayesian layer specs in torch.

Counterpart of ``tensorbnn_tpu/models/layers.py``. Each layer is an
immutable spec; its parameters and hypers live in plain dicts of tensors,
so a model's state is a tuple of per-layer dicts. Data is batch-major
``(batch, features)``; dense weights are stored ``(in, out)``.

Every spec provides ``init(generator, dtype, device)``, ``apply(params,
x)``, ``log_prior(hypers, params)`` (conditional prior of the params) and
``log_hyper_prior(hypers, params)`` (hyperprior plus the conditional prior
at the given hypers). Scale hypers are squared: prior sd (or Cauchy
gamma) = hyper ** 2 (SquarePrelu's slope prior takes its scale hyper as
the sd itself).
``Prelu`` and ``SquarePrelu`` carry sampled slopes (``{"slopes"}``, one
per feature) with hypers; ``LeakyRelu`` has a fixed slope and no rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from tensorbnn_tpu_torch.distributions import cauchy_logprob, \
    cauchy_logprob_compat, exponential_logprob, gaussian_logprob, \
    normal_logprob

Params = Dict[str, torch.Tensor]
Hypers = Dict[str, torch.Tensor]


class LayerSpec:
    """Base layer spec. Stateless layers inherit the no-op defaults."""

    name: str = "layer"

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cpu") -> Tuple[Params, Hypers]:
        del generator, dtype, device
        return {}, {}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_prior(self, hypers: Hypers, params: Params) -> torch.Tensor:
        del hypers, params
        return torch.zeros(())

    def log_hyper_prior(self, hypers: Hypers, params: Params) -> torch.Tensor:
        del hypers, params
        return torch.zeros(())

    @property
    def has_hypers(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class GaussianDenseLayer(LayerSpec):
    """Dense layer with Gaussian priors on weights and biases.

    Four scalar hypers (``w_loc``, ``w_scale``, ``b_loc``, ``b_scale``);
    the conditional prior is the reference-exact ``gaussian_logprob`` with
    sd = scale ** 2; hyperpriors are N(0, 0.1) on the locations and
    N(1, 0.1) on the squared scales.
    """

    in_dim: int
    out_dim: int
    name: str = "denseGaussian"

    @property
    def has_hypers(self) -> bool:
        return True

    def init(self, generator, dtype=torch.float32, device="cpu"):
        # weights and biases both ~ N(0, sqrt(2 / out_dim)), drawn on the
        # generator's device and then moved, so a seed gives the same start
        # on every device
        std = math.sqrt(2.0 / self.out_dim)
        w = std * torch.randn((self.in_dim, self.out_dim), generator=generator,
                              dtype=dtype)
        b = std * torch.randn((self.out_dim,), generator=generator,
                              dtype=dtype)
        params = {"w": w.to(device), "b": b.to(device)}
        hypers = {k: torch.tensor(v, dtype=dtype, device=device)
                  for k, v in (("w_loc", 0.0), ("w_scale", 1.0),
                               ("b_loc", 0.0), ("b_scale", 1.0))}
        return params, hypers

    def apply(self, params, x):
        return x @ params["w"] + params["b"]

    def log_prior(self, hypers, params):
        w_sd = hypers["w_scale"] ** 2
        b_sd = hypers["b_scale"] ** 2
        return gaussian_logprob(w_sd, hypers["w_loc"], params["w"]) + \
            gaussian_logprob(b_sd, hypers["b_loc"], params["b"])

    def log_hyper_prior(self, hypers, params):
        w_sd = hypers["w_scale"] ** 2
        b_sd = hypers["b_scale"] ** 2
        prob = normal_logprob(hypers["w_loc"], 0.0, 0.1)
        prob = prob + normal_logprob(w_sd, 1.0, 0.1)
        prob = prob + normal_logprob(hypers["b_loc"], 0.0, 0.1)
        prob = prob + normal_logprob(b_sd, 1.0, 0.1)
        return prob + self.log_prior(hypers, params)


@dataclasses.dataclass(frozen=True)
class CauchyDenseLayer(LayerSpec):
    """Dense layer with Cauchy priors (gamma = scale ** 2); hyperpriors
    N(0, 0.2) on the locations and N(sqrt(0.5), 0.5) on the squared
    scales. Uses the reference's sign-flipped Cauchy "log prob" unless
    ``proper=True``. K1 and K3 take its prior in closed form; its hyper
    block runs on the plain path (outside K2's stats layout)."""

    in_dim: int
    out_dim: int
    proper: bool = False
    name: str = "dense"

    @property
    def has_hypers(self) -> bool:
        return True

    def _cauchy(self, gamma, x0, x):
        fn = cauchy_logprob if self.proper else cauchy_logprob_compat
        return torch.sum(fn(gamma, x0, x))

    def init(self, generator, dtype=torch.float32, device="cpu"):
        params, _ = GaussianDenseLayer(self.in_dim, self.out_dim).init(
            generator, dtype, device)
        g0 = math.sqrt(0.5)
        hypers = {k: torch.tensor(v, dtype=dtype, device=device)
                  for k, v in (("w_loc", 0.0), ("w_scale", g0),
                               ("b_loc", 0.0), ("b_scale", g0))}
        return params, hypers

    def apply(self, params, x):
        return x @ params["w"] + params["b"]

    def log_prior(self, hypers, params):
        return (self._cauchy(hypers["w_scale"] ** 2, hypers["w_loc"],
                             params["w"])
                + self._cauchy(hypers["b_scale"] ** 2, hypers["b_loc"],
                               params["b"]))

    def log_hyper_prior(self, hypers, params):
        g0 = math.sqrt(0.5)
        prob = normal_logprob(hypers["w_loc"], 0.0, 0.2)
        prob = prob + normal_logprob(hypers["w_scale"] ** 2, g0, 0.5)
        prob = prob + normal_logprob(hypers["b_loc"], 0.0, 0.2)
        prob = prob + normal_logprob(hypers["b_scale"] ** 2, g0, 0.5)
        return prob + self.log_prior(hypers, params)


@dataclasses.dataclass(frozen=True)
class Activation(LayerSpec):
    """Stateless elementwise activation."""

    name: str = "activation"
    _fn: Callable = None  # type: ignore[assignment]

    def apply(self, params, x):
        del params
        return self._fn(x)


def Exp():
    return Activation(name="Exp", _fn=torch.exp)


def Relu():
    return Activation(name="relu", _fn=torch.relu)


def Sigmoid():
    return Activation(name="sigmoid", _fn=torch.sigmoid)


def Tanh():
    return Activation(name="tanh", _fn=torch.tanh)


def Elu():
    return Activation(name="elu", _fn=torch.nn.functional.elu)


def Softmax():
    """Softmax over the feature (last) axis. Under
    ``CategoricalLikelihood`` a trailing Softmax folds into the kernels'
    categorical tail."""
    return Activation(name="softmax",
                      _fn=lambda x: torch.softmax(x, dim=-1))


@dataclasses.dataclass(frozen=True)
class LeakyRelu(LayerSpec):
    """Leaky ReLU with a fixed slope ``alpha`` (no params, no hypers)."""

    alpha: float = 0.3
    name: str = "leakyrelu"

    def apply(self, params, x):
        del params
        return torch.where(x < 0, self.alpha * x, x)


@dataclasses.dataclass(frozen=True)
class Prelu(LayerSpec):
    """PReLU with sampled slopes (one per feature, starting at ``alpha``)
    under an exponential(rate) prior; the rate hyper (start 0.3) has an
    exponential(0.3) hyperprior, and the hyper chain's conditional takes
    ``abs(slopes)``."""

    in_dim: int
    alpha: float = 0.2
    name: str = "prelu"

    @property
    def has_hypers(self) -> bool:
        return True

    def init(self, generator, dtype=torch.float32, device="cpu"):
        del generator
        params = {"slopes": torch.full((self.in_dim,), self.alpha,
                                       dtype=dtype, device=device)}
        return params, {"rate": torch.tensor(0.3, dtype=dtype,
                                             device=device)}

    def apply(self, params, x):
        return torch.where(x < 0, params["slopes"] * x, x)

    def log_prior(self, hypers, params):
        return torch.sum(exponential_logprob(hypers["rate"],
                                             params["slopes"]))

    def log_hyper_prior(self, hypers, params):
        prob = torch.sum(exponential_logprob(0.3, hypers["rate"]))
        return prob + torch.sum(exponential_logprob(
            hypers["rate"], params["slopes"].abs()))


@dataclasses.dataclass(frozen=True)
class SquarePrelu(LayerSpec):
    """PReLU whose slope is the square of the sampled parameter. Gaussian
    prior (sd = the scale hyper, not squared) on the raw slopes in the main
    block and on the squared slopes in the hyper block; hyperpriors N(0,
    0.3) on the location and N(0.3, 0.1) on the scale."""

    in_dim: int
    alpha: float = 0.2
    name: str = "squareprelu"

    @property
    def has_hypers(self) -> bool:
        return True

    def init(self, generator, dtype=torch.float32, device="cpu"):
        del generator
        params = {"slopes": torch.full((self.in_dim,), self.alpha,
                                       dtype=dtype, device=device)}
        hypers = {k: torch.tensor(v, dtype=dtype, device=device)
                  for k, v in (("loc", 0.0), ("scale", 0.3))}
        return params, hypers

    def apply(self, params, x):
        return torch.where(x < 0, params["slopes"] ** 2 * x, x)

    def log_prior(self, hypers, params):
        return gaussian_logprob(hypers["scale"], hypers["loc"],
                                params["slopes"])

    def log_hyper_prior(self, hypers, params):
        prob = gaussian_logprob(hypers["scale"], hypers["loc"],
                                params["slopes"] ** 2)
        prob = prob + normal_logprob(hypers["loc"], 0.0, 0.3)
        return prob + normal_logprob(hypers["scale"], 0.3, 0.1)
