"""``mfu.sample`` (%; layer: whole step): the main block's float32
operations of the window's jobs, counted from the shapes (every chain's L
+ 1 evaluations an epoch of the frozen ``product_flops`` over all rows),
over the window's wall and the cards' published float32 peak."""

import yardstick


def read(record):
    jobs, shape = record.get("jobs"), record.get("shape")
    if not jobs or not shape:
        return None
    per_eval = yardstick.product_flops(record["config"]["layers"],
                                       shape["N"])
    flops = sum(j["evaluations"] for j in jobs) * per_eval
    return 100.0 * flops / (record["window_s"] * yardstick.F32_FLOPS
                            * shape["cards"])
