"""Convenience MLP factory.

Counterpart of ``tensorbnn_tpu/models/mlp.py``: assembles the common
dense Bayesian MLPs in one call instead of a chain of ``add`` calls.
"""

from __future__ import annotations

from typing import Sequence

from tensorbnn_tpu_torch.models.layers import (
    CauchyDenseLayer,
    Elu,
    GaussianDenseLayer,
    LeakyRelu,
    Prelu,
    Relu,
    Sigmoid,
    Softmax,
    SquarePrelu,
    Tanh,
)
from tensorbnn_tpu_torch.models.sequential import Sequential

_FIXED_ACTIVATIONS = {
    "tanh": Tanh,
    "relu": Relu,
    "sigmoid": Sigmoid,
    "elu": Elu,
    "softmax": Softmax,
}


def make_mlp(dims: Sequence[int], activation: str = "tanh",
             prior: str = "gaussian", final_activation: str = None,
             leaky_alpha: float = 0.3, prelu_alpha: float = 0.2,
             proper_cauchy: bool = False) -> Sequential:
    """Builds a dense Bayesian MLP.

    Arguments:
        * dims: layer widths, e.g. (1, 10, 10, 10, 1)
        * activation: "tanh" | "relu" | "sigmoid" | "elu" | "softmax" |
          "leakyrelu" | "prelu" | "squareprelu" (the last two are
          HMC-sampled with their own priors)
        * prior: "gaussian" | "cauchy" weight priors
        * final_activation: optional activation after the last dense layer
          (e.g. "sigmoid" for Bernoulli likelihoods)
    """
    if prior == "gaussian":
        def dense(i, o):
            return GaussianDenseLayer(i, o)
    elif prior == "cauchy":
        def dense(i, o):
            return CauchyDenseLayer(i, o, proper=proper_cauchy)
    else:
        raise ValueError(f"unknown prior: {prior}")

    def act(width):
        if activation in _FIXED_ACTIVATIONS:
            return _FIXED_ACTIVATIONS[activation]()
        if activation == "leakyrelu":
            return LeakyRelu(alpha=leaky_alpha)
        if activation == "prelu":
            return Prelu(width, alpha=prelu_alpha)
        if activation == "squareprelu":
            return SquarePrelu(width, alpha=prelu_alpha)
        raise ValueError(f"unknown activation: {activation}")

    model = Sequential()
    for i in range(len(dims) - 1):
        model.add(dense(dims[i], dims[i + 1]))
        if i < len(dims) - 2:
            model.add(act(dims[i + 1]))
    if final_activation:
        model.add(_FIXED_ACTIVATIONS[final_activation]())
    return model
