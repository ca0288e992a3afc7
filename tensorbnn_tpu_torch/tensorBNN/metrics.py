"""Shim for ``tensorBNN.metrics``.

The reference Metric constructors take (scaleExp, mean, sd); the port's
use snake_case — both spellings are accepted.
"""

from tensorbnn_tpu_torch import metrics as _metrics


def _wrap(cls):
    class Shim(cls):
        def __init__(self, scaleExp=False, mean=0, sd=1, scale_exp=None,
                     *args, **kwargs):
            super().__init__(scale_exp=bool(scale_exp
                                            if scale_exp is not None
                                            else scaleExp),
                             mean=mean, sd=sd)

        def display(self):
            text = super().display()
            print(text)
            return text
    Shim.__name__ = cls.__name__
    return Shim


Metric = _metrics.Metric
SquaredError = _wrap(_metrics.SquaredError)
PercentError = _wrap(_metrics.PercentError)
Accuracy = _wrap(_metrics.Accuracy)
