"""One sampling job that fills the window: the program's driver over
``round(epochs_per_s * seconds)`` epochs (``epochs_per_s`` is the
traffic's constant, measured once on the card), the first
``burnin_share`` of them burn-in, from an initial network and generator
drawn from the seed.

``--trace 1``: the job passes the program a ``RunTracer``, and the
profiler covers the chunks ``trace.chunks`` (first, and one past the
last; 0-based) inside it.
"""

import time

import sampling
import profiling as tr


def setup(run):
    return sampling.setup(run)


def window(run, s):
    tf = run.traffic
    epochs = max(2, round(tf["epochs_per_s"] * run.seconds))
    burnin = max(1, round(tf["burnin_share"] * epochs))
    s.window, s.profiled = None, []
    on_start = on_end = None
    if run.trace:
        first, end = tf["trace"]["chunks"]
        s.window = tr.Window(run.devices)

        def on_start(i):
            if i == first:
                s.window.start()

        def on_end(i, chunk):
            if first <= i < end:
                s.profiled.append((chunk.epochs, chunk.leapfrog))
            if i == end - 1:
                s.window.stop()

    t0 = time.perf_counter()
    job = sampling.run_job(run, s, run.seed, 0, epochs, burnin, run.trace,
                           on_start=on_start, on_end=on_end)
    run.record["window_s"] = time.perf_counter() - t0
    if s.window is not None:
        # the profiler's start and stop are not the driver's work
        job["wall_s"] -= s.window.control_s
    s.jobs.append(job)
    run.record["jobs"] = [{k: v for k, v in job.items()
                           if k not in ("theta", "eta", "leapfrog")}]
    run.record["attempted"] = 1
    run.record["shape"] = sampling.shape(run, s)


def traced(run, s):
    if s.window is None or s.window.t1 is None:
        raise RuntimeError("the job ended before its profiled chunks")
    sampling.profile_record(run, s.window, s.profiled)


def check(run, s, control=False):
    c = run.traffic["check"]
    if not hasattr(s, "chosen"):
        s.chosen = sampling.picks(run, s.jobs, 1, c["runs"], c["steps"])
    return sampling.follow(run, s, s.chosen, control)
