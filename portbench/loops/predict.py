"""A closed loop with one client of posterior-ensemble predictions: the
program's ``Predictor`` over ``networks`` networks of the configuration
(an ensemble drawn from the seed around one initial network, written to
the program's npz store under ``TMPDIR``), each call ``predict`` at
``points`` inputs N(0, 1) drawn anew from the seed, timed on the host from
the call to the numpy result in hand.

``--trace 1``: ``trace.calls`` more calls after the window run under the
profiler.
"""

import shutil
import tempfile
import time

import numpy as np

import inputs
import sampling
import profiling as tr
from reference.mlp import Stack


class State:
    pass


def setup(run):
    import system
    run.mark("program_import")
    s = State()
    tf = run.traffic
    s.dev = run.devices[0]
    s.stack = Stack(run.config)
    s.thetas = inputs.ensemble(run.config, s.stack, tf["networks"],
                               tf["spread"], run.seed, s.dev)
    run.mark("ensemble")
    s.directory = tempfile.mkdtemp(prefix="portbench_store_")
    s.pred = system.predictor(run.config, s.stack, s.thetas, s.directory,
                              s.dev)
    run.mark("store_and_predictor")
    s.rng = np.random.default_rng(inputs.derived_seed(run.seed, 4))
    for _ in range(tf["warmup"]["calls"]):
        s.pred.predict(_points(s, tf))
    sampling.sync(run.devices)
    run.mark("warmup")
    return s


def _points(s, tf):
    return s.rng.standard_normal((tf["points"], 1), dtype=np.float32)


def window(run, s):
    tf, c = run.traffic, run.traffic["check"]
    # the calls the check keeps: drawn from the seed among the calls the
    # window is expected to make, and the last call
    expected = max(1, int(tf["calls_per_s"] * run.seconds))
    pick = np.random.default_rng(inputs.derived_seed(run.seed, 21))
    keep = set(pick.permutation(expected)[:c["calls"]].tolist())
    s.kept, times, last = [], [], None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        x = _points(s, tf)
        t = time.perf_counter()
        out = s.pred.predict(x)
        times.append(time.perf_counter() - t)
        if len(times) - 1 in keep:
            s.kept.append((x, out))
        last = (x, out)
    run.record["window_s"] = time.perf_counter() - t0
    s.kept.append(last)
    run.record["call_s"] = times
    run.record["attempted"] = len(times)
    run.record["shape"] = {"networks": tf["networks"], "D": s.stack.D,
                           "points": tf["points"], "d_in": 1, "d_out": 1,
                           "cards": len(run.devices)}


def traced(run, s):
    tf = run.traffic
    xs = [_points(s, tf) for _ in range(tf["trace"]["calls"])]
    window = tr.Window(run.devices)
    window.start()
    for x in xs:
        s.pred.predict(x)
    window.stop()
    sampling.profile_record(run, window, None)
    run.record["profile_calls"] = len(xs)


def check(run, s, control=False):
    import check as ck
    s.pred = None
    shutil.rmtree(s.directory, ignore_errors=True)
    gap = ck.predict_gap(run.config, s.thetas.double(), s.kept, control)
    return {"predict_gap": gap}
