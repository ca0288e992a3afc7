"""Shim for ``tensorBNN.activationFunctions`` (reference signatures)."""

from __future__ import annotations

import numpy as np

from tensorbnn_tpu_torch.models import layers as _layers


def Exp(inputDims=None, outputDims=None):
    del inputDims, outputDims
    return _layers.Exp()


def Relu(inputDims=None, outputDims=None):
    del inputDims, outputDims
    return _layers.Relu()


def Sigmoid(inputDims=None, outputDims=None):
    del inputDims, outputDims
    return _layers.Sigmoid()


def Tanh(inputDims=None, outputDims=None):
    del inputDims, outputDims
    return _layers.Tanh()


def Elu(inputDims=None, outputDims=None):
    del inputDims, outputDims
    return _layers.Elu()


def Softmax(inputDims=None, outputDims=None):
    del inputDims, outputDims
    return _layers.Softmax()


def Leaky_relu(alpha=0.3, inputDims=None, outputDims=None, activation=None):
    del inputDims, outputDims
    if activation is not None:
        alpha = float(activation)
    return _layers.LeakyRelu(alpha=alpha)


def _with_slopes(spec, activation):
    if activation is not None:
        # specs are frozen dataclasses; attach the override out-of-band
        object.__setattr__(spec, "_ref_warm_start",
                           {"slopes": np.asarray(activation).reshape(-1)})
    return spec


def Prelu(inputDims, outputDims=None, dtype=None, alpha=0.2,
          activation=None, seed=1):
    del outputDims, dtype, seed
    return _with_slopes(_layers.Prelu(in_dim=inputDims, alpha=alpha),
                        activation)


def SquarePrelu(inputDims, outputDims=None, dtype=None, alpha=0.2,
                activation=None, seed=1):
    del outputDims, dtype, seed
    return _with_slopes(_layers.SquarePrelu(in_dim=inputDims, alpha=alpha),
                        activation)
