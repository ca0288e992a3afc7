"""Shim for ``tensorBNN.BNN_functions``: the log-prob helpers plus the
camelCase pretraining entry points, over the port's ``distributions`` and
``training.pretrain``.

The log-probs take float32 tensors, as the JAX shim computes in float32.
The pretraining helpers run on ``device``, the CUDA card unless the
caller names another.
"""

import torch

from tensorbnn_tpu_torch.distributions import cauchy_logprob_compat, \
    gaussian_logprob
from tensorbnn_tpu_torch.training.pretrain import \
    train_basic_classification, train_basic_regression


def _f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def multivariateLogProb(sigmaIn, mu, x, dtype=None):
    del dtype
    return gaussian_logprob(_f32(sigmaIn), _f32(mu), _f32(x))


def cauchyLogProb(gamma, x0, x, dtype=None):
    del dtype
    return cauchy_logprob_compat(_f32(gamma), _f32(x0), _f32(x))


def trainBasicRegression(hidden, inputDims, outputDims, width, cycles,
                         epochs, alpha, trainIn, trainOut, valIn, valOut,
                         name=None, callbacks=True,
                         callbackMetric="val_loss", patience=10,
                         device="cuda"):
    del callbackMetric
    return train_basic_regression(hidden, inputDims, outputDims, width,
                                  cycles, epochs, alpha, trainIn, trainOut,
                                  valIn, valOut, name=name,
                                  callbacks=callbacks, patience=patience,
                                  device=device)


def trainBasicClassification(hidden, inputDims, outputDims, width, cycles,
                             epochs, alpha, trainIn, trainOut, valIn,
                             valOut, name=None, callbacks=True,
                             callbackMetric="val_loss", patience=10,
                             device="cuda"):
    del callbackMetric
    return train_basic_classification(hidden, inputDims, outputDims, width,
                                      cycles, epochs, alpha, trainIn,
                                      trainOut, valIn, valOut, name=name,
                                      callbacks=callbacks,
                                      patience=patience, device=device)
