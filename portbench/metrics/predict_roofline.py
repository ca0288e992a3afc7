"""``predict_roofline`` (%; layer: Predictor): the ensemble forward's
bound from its shapes (the frozen ``forward_bound``) over the device time
of a call's kernels (the forward graph's replay, without the copy of the
result to the host), in the profiled run of calls."""

import profiling
import yardstick


def read(record):
    if "profile_calls" not in record:
        return None
    events = [e for e in record["profile_events"]
              if not e[0].startswith(("Memcpy", "Memset"))]
    seconds = sum(e[4] - e[3] for e in profiling.device_events(events))
    if seconds <= 0:
        return None
    s = record["shape"]
    need = yardstick.forward_bound(record["config"]["layers"],
                                   s["networks"], s["D"], s["points"],
                                   s["d_in"], s["d_out"])[0]
    return 100.0 * need * record["profile_calls"] / seconds
