"""``k1_roofline`` (%; layer: kernel K1): the frozen ``k1_shape_bound`` of
every K1 launch of the profiled sub-window (one an epoch, at the chunk's
chains and per-chain L), over the device time of its
``trajectory_kernel``s."""

import profiling
import yardstick


def read(record):
    chunks, shape = record.get("profile_chunks"), record.get("shape")
    if not chunks:
        return None
    seconds, n = profiling.kernel_seconds(record["profile_events"],
                                      r"trajectory_kernel")
    if n == 0 or seconds <= 0:
        return None
    layers = record["config"]["layers"]
    c = shape["C"]
    need = sum(epochs * yardstick.k1_shape_bound(
        layers, c, shape["D"], shape["H"], shape["N"], shape["d_in"],
        c * (leap + 1.0))[0] for epochs, leap in chunks)
    # a capture's warm-up epoch launches K1 once more, outside the chunks
    need *= n / sum(epochs for epochs, _ in chunks)
    return 100.0 * need / seconds
