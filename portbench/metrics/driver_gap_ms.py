"""``driver_gap_ms`` (ms a chunk; layer: facade and driver): a traced
job's wall less its ``RunTracer`` chunk spans, over its chunks: the
driver's host work outside the chunk runner (plan, adapters, diagnostics,
the samples' transfer), mean over the window's jobs."""

import numpy as np


def read(record):
    gaps = [(j["wall_s"] - sum(c[2] for c in j["chunks"]))
            / len(j["chunks"]) for j in record.get("jobs", [])
            if j.get("chunks")]
    return 1e3 * float(np.mean(gaps)) if gaps else None
