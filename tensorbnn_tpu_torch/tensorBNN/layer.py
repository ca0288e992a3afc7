"""Shim for ``tensorBNN.layer``: reference constructor signatures
(inputDims/outputDims/weights/biases/dtype/seed) over the port's layer
specs. Warm-start weights are carried on the spec and picked up by the
shim network's ``add``."""

from __future__ import annotations

from tensorbnn_tpu_torch.models import layers as _layers
from tensorbnn_tpu_torch.tensorBNN._compat import ref_dense_warm_start


def _with_warm_start(spec, weights, biases):
    # specs are frozen dataclasses; attach the override out-of-band
    object.__setattr__(spec, "_ref_warm_start",
                       ref_dense_warm_start(weights, biases))
    return spec


def GaussianDenseLayer(inputDims, outputDims, weights=None, biases=None,
                       dtype=None, seed=1):
    del dtype, seed  # dtype comes from the network, draws from its seed
    return _with_warm_start(
        _layers.GaussianDenseLayer(inputDims, outputDims), weights, biases)


def CauchyDenseLayer(inputDims, outputDims, weights=None, biases=None,
                     dtype=None, seed=1):
    del dtype, seed
    return _with_warm_start(
        _layers.CauchyDenseLayer(inputDims, outputDims), weights, biases)


# reference alias (the reference's dense layer has Cauchy priors)
DenseLayer = CauchyDenseLayer
