"""Compatibility shim: the reference's ``tensorBNN`` import surface over
the torch port.

Counterpart of the JAX package's ``tensorBNN/`` shim, module by module:
``network`` (and the examples' ``networkFinal``), ``layer``,
``activationFunctions``, ``likelihood``, ``metrics``, ``predictor`` and
``BNN_functions``, with the reference's constructor signatures
(camelCase keywords, TensorFlow dtype objects accepted), backed by
:mod:`tensorbnn_tpu_torch`. A reference user's script runs on the CUDA
card with one change, its import prefix::

    from tensorbnn_tpu_torch.tensorBNN.layer import GaussianDenseLayer

The network, the predictor and the pretraining helpers take a ``device``
keyword (the card by default; ``device="cpu"`` runs on the CPU).
"""
