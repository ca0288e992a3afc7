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

The reference-format hooks (``n_ref_param_tensors``,
``n_ref_hyper_scalars``, ``ref_param_tensors``, ``params_from_ref``,
``ref_hyper_values``, ``hypers_from_ref``) convert a layer's state, with
an optional leading sample axis, to and from the reference text store's
layout (dense ``W (out, in)``, ``b (out, 1)``; hypers as scalars in
declaration order). They work on numpy arrays on the host, where the
store's writer and reader run.

The dense layers take the JAX package's ``compute_dtype`` and
``matmul_precision`` fields (``_DenseCompute``). On the card the
precisions map to TF32: ``"highest"`` runs the product, and both of its
gradient products, with TF32 off, ``"high"`` with TF32 on (JAX's own
meaning of ``HIGH`` on a GPU), None under whatever the process has set
(torch's default is TF32 off).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tensorbnn_tpu_torch.distributions import cauchy_logprob, \
    cauchy_logprob_compat, exponential_logprob, gaussian_logprob, \
    normal_logprob

Params = Dict[str, torch.Tensor]
Hypers = Dict[str, torch.Tensor]


class LayerSpec:
    """Base layer spec. Stateless layers inherit the no-op defaults."""

    #: registry name, written to architecture.txt
    name: str = "layer"
    #: state tensors the reference text store keeps for this layer
    n_ref_param_tensors = 0
    #: hyper scalars the reference text store keeps for this layer
    n_ref_hyper_scalars = 0

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

    def ref_param_tensors(self, params: Params) -> list:
        del params
        return []

    def params_from_ref(self, tensors: list) -> Params:
        del tensors
        return {}

    def ref_hyper_values(self, hypers: Hypers) -> list:
        del hypers
        return []

    def hypers_from_ref(self, values: list) -> Hypers:
        del values
        return {}


@contextlib.contextmanager
def _matmul_tf32(allow: bool):
    """Runs the enclosed float32 CUDA products with TF32 ``allow``ed or not,
    restoring the process's setting after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


#: ``matmul_precision`` -> TF32 allowed for the dense product
_PRECISION_TF32 = {"highest": False, "high": True}


class _PrecisionMatmul(torch.autograd.Function):
    """``x @ w`` whose forward and both backward products run under one TF32
    setting, so a layer's precision reaches its gradient as JAX's
    ``precision=`` does. ``setup_context`` and the generated vmap rule let
    the plain path run it under ``torch.func.vmap`` and
    ``grad_and_value``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, tf32):
        with _matmul_tf32(tf32):
            return x @ w

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, tf32 = inputs
        ctx.save_for_backward(x, w)
        ctx.tf32 = tf32

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _matmul_tf32(ctx.tf32):
            # the first layer's input is the data: no gradient to form
            if ctx.needs_input_grad[0]:
                gx = g @ w.transpose(-1, -2)
            if ctx.needs_input_grad[1]:
                gw = x.reshape(-1, x.shape[-1]).transpose(0, 1) @ g.reshape(
                    -1, g.shape[-1])
        return gx, gw, None


class _DenseCompute:
    """The dense forward pass with an optional precision or operand dtype
    (the JAX package's ``_DenseCompute``, ``models/layers.py:118-170``).

    ``compute_dtype="bfloat16"`` rounds both operands to bf16, forms the
    product and adds the bias in float32, and casts the output to bf16, so
    a stack of such layers keeps its activations in bf16. The product runs
    on the bf16-rounded operands upcast to float32: products of bf16 values
    are exact in float32, and bf16 values are exact in TF32, so under either
    TF32 setting it is the bf16 product with float32 accumulation.

    ``matmul_precision`` ("high" or "highest") sets the product's TF32 use
    instead (see the module docstring). The two are mutually exclusive:
    one asks for bf16 operands, the other for exact float32 products."""

    def __post_init__(self):
        if (getattr(self, "compute_dtype", None)
                and getattr(self, "matmul_precision", None)):
            raise ValueError(
                "compute_dtype and matmul_precision are mutually "
                "exclusive: one asks for bf16 operands, the other for "
                "exact-f32 matmuls")
        prec = getattr(self, "matmul_precision", None)
        if prec is not None and prec not in _PRECISION_TF32:
            raise ValueError(f"matmul_precision must be None, 'high' or "
                             f"'highest', got {prec!r}")

    def _dense_apply(self, params, x):
        cd = getattr(self, "compute_dtype", None)
        if cd is not None:
            dt = getattr(torch, cd)
            y = x.to(dt).to(torch.float32) @ params["w"].to(dt).to(
                torch.float32)
            return (y + params["b"]).to(dt)
        prec = getattr(self, "matmul_precision", None)
        if prec is not None:
            return _PrecisionMatmul.apply(x, params["w"],
                                          _PRECISION_TF32[prec]) + params["b"]
        return x @ params["w"] + params["b"]


class _DenseRefIO:
    """Reference-format conversions of both dense layers: ``(..., in,
    out)`` weights and ``(..., out)`` biases against the reference's
    ``(..., out, in)`` and ``(..., out, 1)``; the four hypers in the
    reference's order."""

    n_ref_param_tensors = 2
    n_ref_hyper_scalars = 4
    _HYPER_KEYS = ("w_loc", "w_scale", "b_loc", "b_scale")

    def ref_param_tensors(self, params):
        w = np.swapaxes(np.asarray(params["w"]), -1, -2)
        b = np.asarray(params["b"])[..., None]
        return [w, b]

    def params_from_ref(self, tensors):
        w, b = tensors
        return {"w": np.swapaxes(np.asarray(w), -1, -2),
                "b": np.asarray(b)[..., 0]}

    def ref_hyper_values(self, hypers):
        return [np.asarray(hypers[k]) for k in self._HYPER_KEYS]

    def hypers_from_ref(self, values):
        return {k: np.asarray(v) for k, v in zip(self._HYPER_KEYS, values)}


@dataclasses.dataclass(frozen=True)
class GaussianDenseLayer(_DenseCompute, _DenseRefIO, LayerSpec):
    """Dense layer with Gaussian priors on weights and biases.

    Four scalar hypers (``w_loc``, ``w_scale``, ``b_loc``, ``b_scale``);
    the conditional prior is the reference-exact ``gaussian_logprob`` with
    sd = scale ** 2; hyperpriors are N(0, 0.1) on the locations and
    N(1, 0.1) on the squared scales. ``compute_dtype`` and
    ``matmul_precision``: see ``_DenseCompute``.
    """

    in_dim: int
    out_dim: int
    name: str = "denseGaussian"
    compute_dtype: Optional[str] = None  # e.g. "bfloat16"
    matmul_precision: Optional[str] = None  # "high" / "highest"

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
        return self._dense_apply(params, x)

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
class CauchyDenseLayer(_DenseCompute, _DenseRefIO, LayerSpec):
    """Dense layer with Cauchy priors (gamma = scale ** 2); hyperpriors
    N(0, 0.2) on the locations and N(sqrt(0.5), 0.5) on the squared
    scales. Uses the reference's sign-flipped Cauchy "log prob" unless
    ``proper=True``. K1 and K3 take its prior in closed form; its hyper
    block runs on the plain path (outside K2's stats layout).
    ``compute_dtype`` and ``matmul_precision``: see ``_DenseCompute``."""

    in_dim: int
    out_dim: int
    proper: bool = False
    name: str = "dense"
    compute_dtype: Optional[str] = None  # e.g. "bfloat16"
    matmul_precision: Optional[str] = None  # "high" / "highest"

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
        return self._dense_apply(params, x)

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


#: the reference's ``DenseLayer = CauchyDenseLayer``
DenseLayer = CauchyDenseLayer


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
    """Leaky ReLU with a fixed slope ``alpha`` (no params, no hypers). The
    reference stores alpha as a state tensor its forward pass never reads,
    so the text store keeps one tensor for it (``n_ref_param_tensors = 1``,
    the constant itself, with no sample axis, as the JAX package writes
    it), and reading it back gives no params."""

    alpha: float = 0.3
    name: str = "leakyrelu"
    n_ref_param_tensors = 1

    def apply(self, params, x):
        del params
        return torch.where(x < 0, self.alpha * x, x)

    def ref_param_tensors(self, params):
        del params
        return [np.asarray([self.alpha])]


@dataclasses.dataclass(frozen=True)
class Prelu(LayerSpec):
    """PReLU with sampled slopes (one per feature, starting at ``alpha``)
    under an exponential(rate) prior; the rate hyper (start 0.3) has an
    exponential(0.3) hyperprior, and the hyper chain's conditional takes
    ``abs(slopes)``."""

    in_dim: int
    alpha: float = 0.2
    name: str = "prelu"
    n_ref_param_tensors = 1
    n_ref_hyper_scalars = 1

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

    def ref_param_tensors(self, params):
        return [np.asarray(params["slopes"])[..., None]]

    def params_from_ref(self, tensors):
        return {"slopes": np.asarray(tensors[0])[..., 0]}

    def ref_hyper_values(self, hypers):
        return [np.asarray(hypers["rate"])]

    def hypers_from_ref(self, values):
        return {"rate": np.asarray(values[0])}


@dataclasses.dataclass(frozen=True)
class SquarePrelu(LayerSpec):
    """PReLU whose slope is the square of the sampled parameter. Gaussian
    prior (sd = the scale hyper, not squared) on the raw slopes in the main
    block and on the squared slopes in the hyper block; hyperpriors N(0,
    0.3) on the location and N(0.3, 0.1) on the scale."""

    in_dim: int
    alpha: float = 0.2
    name: str = "squareprelu"
    n_ref_param_tensors = 1
    n_ref_hyper_scalars = 2

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

    def ref_param_tensors(self, params):
        return [np.asarray(params["slopes"])[..., None]]

    def params_from_ref(self, tensors):
        return {"slopes": np.asarray(tensors[0])[..., 0]}

    def ref_hyper_values(self, hypers):
        return [np.asarray(hypers["loc"]), np.asarray(hypers["scale"])]

    def hypers_from_ref(self, values):
        return {"loc": np.asarray(values[0]),
                "scale": np.asarray(values[1])}


#: architecture.txt names to layer constructors (the reference predictor's
#: layerDict); the Predictor rebuilds a stored model from it
LAYER_REGISTRY = {
    "Exp": lambda **kw: Exp(),
    "relu": lambda **kw: Relu(),
    "sigmoid": lambda **kw: Sigmoid(),
    "tanh": lambda **kw: Tanh(),
    "elu": lambda **kw: Elu(),
    "softmax": lambda **kw: Softmax(),
    "leakyrelu": lambda **kw: LeakyRelu(**kw),
    "prelu": lambda in_dim=1, **kw: Prelu(in_dim=in_dim, **kw),
    "squareprelu": lambda in_dim=1, **kw: SquarePrelu(in_dim=in_dim, **kw),
    "dense": lambda in_dim=1, out_dim=1, **kw: CauchyDenseLayer(
        in_dim=in_dim, out_dim=out_dim, **kw),
    "denseGaussian": lambda in_dim=1, out_dim=1, **kw: GaussianDenseLayer(
        in_dim=in_dim, out_dim=out_dim, **kw),
}
