"""Shim for ``tensorBNN.network`` (and ``networkFinal``): the reference's
``network(dtype, inputDims, trainX, trainY, validateX, validateY)`` object
with camelCase ``setupMCMC``/``train`` keywords, backed by
:class:`tensorbnn_tpu_torch.network.Network` on ``device`` (the CUDA card
unless the caller names another)."""

from __future__ import annotations

from tensorbnn_tpu_torch.network import Network as _Network
from tensorbnn_tpu_torch.tensorBNN._compat import to_torch_dtype


class network(_Network):
    def __init__(self, dtype, inputDims, trainX, trainY, validateX,
                 validateY, seed: int = 0, device="cuda"):
        super().__init__(to_torch_dtype(dtype), inputDims, trainX, trainY,
                         validateX, validateY, seed=seed, device=device)

    def add(self, layer, parameters=None):
        """Accepts warm-start parameters attached by the shim layer ctors
        (the reference passes weights/biases to the layer constructor)."""
        if parameters is None:
            parameters = getattr(layer, "_ref_warm_start", None)
        return super().add(layer, parameters=parameters)


Network = network
