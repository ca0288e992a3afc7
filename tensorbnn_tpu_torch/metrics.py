"""Training/validation metrics evaluated during sampling.

Counterpart of ``tensorbnn_tpu/metrics.py`` on tensors: each metric
un-normalizes predictions and targets with ``(mean, sd)``, optionally
exp-rescales them, computes its score on the train and validation splits
and renders a display string. The driver calls these at display epochs on
chain 0's sample.
"""

from __future__ import annotations

import torch


class Metric:
    """Base metric."""

    def __init__(self, scale_exp: bool = False, mean=0.0, sd=1.0):
        self.scale_exp = scale_exp
        self.mean = mean
        self.sd = sd

    def _unscale(self, preds, real):
        preds = torch.as_tensor(preds) * self.sd + self.mean
        real = torch.as_tensor(real) * self.sd + self.mean
        if self.scale_exp:
            preds = torch.exp(preds)
            real = torch.exp(real)
        return preds, real.reshape(preds.shape)

    def calculate(self, preds_train, preds_validate, real_train,
                  real_validate):
        raise NotImplementedError

    def display(self) -> str:
        raise NotImplementedError


class SquaredError(Metric):
    """Mean squared error (the JAX package's fix kept: under
    ``scale_exp`` all four tensors are exp-rescaled)."""

    def calculate(self, preds_train, preds_validate, real_train,
                  real_validate):
        pt, rt = self._unscale(preds_train, real_train)
        pv, rv = self._unscale(preds_validate, real_validate)
        self.train = float(torch.mean((pt - rt) ** 2))
        self.validate = float(torch.mean((pv - rv) ** 2))

    def display(self):
        return (f"training squared error{self.train: 9.5f} "
                f"validation squared error{self.validate: 9.5f}")


class PercentError(Metric):
    """Mean absolute percent error.

    Kept quirk of the reference and the JAX package: the division by the
    (un-normalized) targets is unguarded, so a target equal to 0 makes the
    mean inf or NaN. Use :class:`SquaredError` for data whose targets
    cross zero.
    """

    def calculate(self, preds_train, preds_validate, real_train,
                  real_validate):
        pt, rt = self._unscale(preds_train, real_train)
        pv, rv = self._unscale(preds_validate, real_validate)
        self.train = float(torch.mean(torch.abs((pt - rt) / rt)) * 100.0)
        self.validate = float(torch.mean(torch.abs((pv - rv) / rv)) * 100.0)

    def display(self):
        return (f"training percent error{self.train: 7.3f} "
                f"validation percent error{self.validate: 7.3f}")


class Accuracy(Metric):
    """Binary accuracy by rounding the predicted probabilities."""

    def calculate(self, preds_train, preds_validate, real_train,
                  real_validate):
        pt, rt = self._unscale(preds_train, real_train)
        pv, rv = self._unscale(preds_validate, real_validate)
        self.train = float(1.0 - torch.mean(torch.abs(rt - torch.round(pt))))
        self.validate = float(1.0 - torch.mean(torch.abs(rv
                                                         - torch.round(pv))))

    def display(self):
        return (f"training accuracy{self.train: 9.5f} "
                f"validation accuracy{self.validate: 9.5f}")


class MulticlassAccuracy(Accuracy):
    """Argmax accuracy over probability rows (paired with
    ``CategoricalLikelihood``). Targets may be class ids or one-hot rows;
    the unscaling options do not apply. Shares Accuracy's display."""

    def calculate(self, preds_train, preds_validate, real_train,
                  real_validate):
        def acc(preds, real):
            preds = torch.as_tensor(preds)
            pred_cls = torch.argmax(preds, dim=-1)
            real = torch.as_tensor(real)
            # one-hot only when the trailing axis matches the class
            # count; an (N, 1) column of ids flattens to ids
            if real.ndim == preds.ndim and \
                    real.shape[-1] == preds.shape[-1]:
                real = torch.argmax(real, dim=-1)
            else:
                real = real.reshape(pred_cls.shape)
            return float(torch.mean((pred_cls == real.to(pred_cls.dtype))
                                    .to(torch.float32)))
        self.train = acc(preds_train, real_train)
        self.validate = acc(preds_validate, real_validate)
