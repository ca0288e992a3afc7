"""``predict_ms_p95`` (ms, host clock): the 95th percentile of every
``predict`` call of the window, each timed from the call to the numpy
result in hand."""

import numpy as np


def read(record):
    times = record.get("call_s")
    if not times:
        return None
    return float(np.percentile(np.asarray(times) * 1e3, 95))
