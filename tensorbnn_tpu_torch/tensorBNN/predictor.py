"""Shim for ``tensorBNN.predictor``.

The reference's ``predict(inputMatrix, n)`` returns a python list of
per-network predictions in the column-major ``(outputDims, batch)``
layout; this shim restores that shape over the port's vmapped
batch-major ensemble. Method names keep the reference spellings
(``autoCorrelationLength``, ``extractParameters``...).
"""

from __future__ import annotations

import numpy as np

from tensorbnn_tpu_torch.io.reference_format import ref_state_tensors
from tensorbnn_tpu_torch.likelihoods import GaussianLikelihood
from tensorbnn_tpu_torch.predictor import Predictor as _Predictor
from tensorbnn_tpu_torch.tensorBNN._compat import to_torch_dtype


class predictor(_Predictor):
    def __init__(self, directoryPath, dtype=None, customLayerDict=None,
                 likelihood=None, device="cuda"):
        if likelihood is None:
            likelihood = GaussianLikelihood(sd=0.1)
        custom = {}
        if customLayerDict:
            # reference dict maps name -> class; the port's name -> factory
            for k, v in customLayerDict.items():
                custom[k] = (lambda cls=v, **kw: cls(**kw))
        super().__init__(directoryPath.rstrip("/"),
                         dtype=to_torch_dtype(dtype),
                         custom_layer_dict=custom, likelihood=likelihood,
                         device=device)

    def predict(self, inputMatrix, n=1):
        """Reference layout: list of (outputDims, batch) arrays."""
        out = super().predict(np.asarray(inputMatrix), n=n)
        return [o.T for o in out]

    def autocorrelation(self, inputData, nMax):
        return super().autocorrelation(np.asarray(inputData), n_max=nMax)

    def autoCorrelationLength(self, inputData, nMax):
        return super().autocorrelation_length(np.asarray(inputData),
                                              n_max=nMax)

    def extractParameters(self):
        """Reference-layout stacked matrices (numNetworks, rows, cols)."""
        return [np.asarray(t) for t in
                ref_state_tensors(self.model, self.param_samples)]

    def extractHyperParameters(self):
        return self.extract_hyper_parameters()

    def parameterStatistics(self):
        mats = self.extractParameters()
        return ([m.mean(axis=0) for m in mats],
                [m.std(axis=0) for m in mats])

    def hyperStatistics(self):
        return self.hyper_statistics()

    def reweight(self, architecture, trainX=None, trainY=None, n=1,
                 likelihood=None):
        return super().reweight(architecture, train_x=trainX,
                                train_y=trainY, n=n, likelihood=likelihood)
