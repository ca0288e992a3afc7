"""Shim for ``tensorBNN.likelihood``."""

from tensorbnn_tpu_torch.likelihoods import (  # noqa: F401
    BernoulliLikelihood,
    FixedGaussianLikelihood,
    GaussianLikelihood,
    Likelihood,
)
