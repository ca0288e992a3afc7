"""Output likelihoods in torch.

Counterpart of ``tensorbnn_tpu/likelihoods.py``: each likelihood is an
immutable spec with its own (possibly empty) dict of hypers, and
``log_likelihood(preds, y, hypers)`` returns the scalar data
log-likelihood of one chain's batch-major predictions. The Bernoulli and
categorical likelihoods have no hypers and do not couple into the hyper
block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from tensorbnn_tpu_torch.distributions import bernoulli_logprob, \
    categorical_logprob, gaussian_logprob

Hypers = Dict[str, torch.Tensor]


class Likelihood:
    """Base likelihood spec."""

    main_probs_in_hypers: bool = False

    def init_hypers(self, dtype=torch.float32, device="cpu") -> Hypers:
        del dtype, device
        return {}

    def log_likelihood(self, preds, y, hypers: Hypers) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood(Likelihood):
    """Gaussian likelihood with a learned noise scale stored as sqrt(sd)
    (the effective sd is ``sd_root ** 2``) under a flat prior."""

    sd: float = 0.1
    main_probs_in_hypers: bool = True

    def init_hypers(self, dtype=torch.float32, device="cpu"):
        return {"sd_root": torch.tensor(math.sqrt(self.sd), dtype=dtype,
                                        device=device)}

    def log_likelihood(self, preds, y, hypers):
        sd = hypers["sd_root"] ** 2
        sigma = torch.ones_like(preds) * sd
        return gaussian_logprob(sigma, preds, y.reshape(preds.shape))


@dataclasses.dataclass(frozen=True)
class FixedGaussianLikelihood(Likelihood):
    """Gaussian likelihood with a fixed noise scale, used as-is."""

    sd: float = 0.1
    main_probs_in_hypers: bool = False

    def log_likelihood(self, preds, y, hypers):
        del hypers
        sigma = torch.ones_like(preds) * self.sd
        return gaussian_logprob(sigma, preds, y.reshape(preds.shape))


@dataclasses.dataclass(frozen=True)
class BernoulliLikelihood(Likelihood):
    """Bernoulli likelihood over probability-valued predictions (the model
    ends with ``Sigmoid()``), probabilities clipped to [1e-8, 1 - 1e-7]."""

    main_probs_in_hypers: bool = False
    n_ref_hyper_scalars: int = 0

    def log_likelihood(self, preds, y, hypers):
        del hypers
        return torch.sum(bernoulli_logprob(preds, y.reshape(preds.shape)))


@dataclasses.dataclass(frozen=True)
class CategoricalLikelihood(Likelihood):
    """Categorical likelihood over probability rows (the model ends with
    ``Softmax()``); ``y`` holds class ids or one-hot rows."""

    main_probs_in_hypers: bool = False
    n_ref_hyper_scalars: int = 0

    def log_likelihood(self, preds, y, hypers):
        del hypers
        return torch.sum(categorical_logprob(preds, y))
