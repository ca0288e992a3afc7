"""tensorbnn_tpu_torch: the tensorbnn_tpu sampler in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``tensorbnn_tpu``, which stays the reference.
Module names mirror it. This package imports torch and numpy only, never
jax. It carries the sampler's main path: dense Bayesian MLPs sampled by
two-block Gibbs-within-HMC through ``Network(...).add(...).setup_mcmc(...)
.train(...)``, with the main block's whole leapfrog trajectory in one CUDA
kernel (K1, ``ops/fused_mlp.py``) or, for models K1 declines, each
leapfrog step's likelihood value and gradient in another (K3, same
module), and the hyper block's trajectory in a third (K2,
``ops/fused_hyper.py``). The kernels are built from ``csrc/`` with
``nvcc`` on first use; ``Network`` runs on the CUDA card unless given
another device.
"""

from tensorbnn_tpu_torch import distributions
from tensorbnn_tpu_torch.likelihoods import (
    FixedGaussianLikelihood,
    GaussianLikelihood,
    Likelihood,
)
from tensorbnn_tpu_torch.models.layers import (
    CauchyDenseLayer,
    Elu,
    Exp,
    GaussianDenseLayer,
    LayerSpec,
    Relu,
    Sigmoid,
    Tanh,
)
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.network import Network

__version__ = "0.1.0"

__all__ = [
    "distributions",
    "Likelihood",
    "GaussianLikelihood",
    "FixedGaussianLikelihood",
    "LayerSpec",
    "GaussianDenseLayer",
    "CauchyDenseLayer",
    "Exp",
    "Relu",
    "Sigmoid",
    "Tanh",
    "Elu",
    "Sequential",
    "Network",
    "__version__",
]
