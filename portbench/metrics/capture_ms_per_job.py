"""``capture_ms_per_job`` (ms; layer: chunk runner): the graph runner's
capture seconds a job (``graphs.COUNTS.capture_seconds``, each capture's
warm-up epoch included), mean over the window's jobs."""

import numpy as np


def read(record):
    jobs = record.get("jobs")
    if not jobs:
        return None
    return 1e3 * float(np.mean([sum(j["capture_s"]) for j in jobs]))
