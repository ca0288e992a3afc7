"""``k3_roofline`` (%; layer: kernel K3): the frozen ``k3_shape_bound`` of
every K3 call of the profiled sub-window (L + 1 an epoch, one a row chunk
of ``data_chunk`` rows), over the device time of K3's kernels (its
products, tails, slope and slice sums)."""

import profiling
import yardstick

K3_KERNELS = (r"(gemm_kernel|gaussian_tail_kernel|bernoulli_tail_kernel|"
              r"categorical_tail_kernel|slope_grad_kernel|slice_sum_kernel)")


def read(record):
    chunks, shape = record.get("profile_chunks"), record.get("shape")
    if not chunks:
        return None
    seconds, n = profiling.kernel_seconds(record["profile_events"], K3_KERNELS)
    if n == 0 or seconds <= 0:
        return None
    rows = shape["rows_per_call"]
    calls = sum(epochs * (leap + 1.0) for epochs, leap in chunks) * (
        shape["N"] // rows)
    need = calls * yardstick.k3_shape_bound(
        record["config"]["layers"], shape["C"], shape["D"], rows,
        shape["d_in"])[0]
    return 100.0 * need / seconds
