"""A closed loop of whole sampling jobs, one after another: each job a
fresh run of the program's driver (``job``'s keywords, ``mcmc``'s sampler
settings) from its own initial network and generator.

Every seed gets the same work: the window runs ``round(jobs_per_s *
seconds)`` jobs (``jobs_per_s`` is the traffic's constant, measured once
on the card), job k from ``(jobs_seed, k)``, in an order drawn from
``--seed``. A job's start sets how long its adapters' trajectories run,
so jobs drawn from ``--seed`` would change the work from seed to seed.

``--trace 1``: every job of the window passes the program a ``RunTracer``,
and one more job after the window runs under the profiler.
"""

import time

import numpy as np

import inputs
import profiling as tr
import sampling


def setup(run):
    return sampling.setup(run)


def order(run):
    """The window's jobs, in the run's order."""
    n = max(1, round(run.traffic["jobs_per_s"] * run.seconds))
    rng = np.random.default_rng(inputs.derived_seed(run.seed, 5))
    return rng.permutation(n).tolist()


def window(run, s):
    job, root = run.traffic["job"], run.traffic["jobs_seed"]
    t0 = time.perf_counter()
    for k in order(run):
        s.jobs.append(sampling.run_job(run, s, root, k, job["epochs"],
                                       job["burnin"], run.trace))
    run.record["window_s"] = time.perf_counter() - t0
    run.record["jobs"] = [{k: v for k, v in j.items()
                           if k not in ("theta", "eta", "leapfrog")}
                          for j in s.jobs]
    run.record["attempted"] = len(s.jobs)
    run.record["shape"] = sampling.shape(run, s)


def traced(run, s):
    """The window's first job again, the profiled sub-window."""
    job = run.traffic["job"]
    window = tr.Window(run.devices)
    window.start()
    extra = sampling.run_job(run, s, run.traffic["jobs_seed"],
                             order(run)[0], job["epochs"], job["burnin"],
                             True)
    window.stop()
    sampling.profile_record(run, window, [(c[0], c[1])
                                          for c in extra["chunks"]])


def check(run, s, control=False):
    c = run.traffic["check"]
    if not hasattr(s, "chosen"):
        ess = [sampling.predictive_ess(s, j["theta"], c["ess_at"])
               for j in s.jobs]
        for rec, e in zip(run.record["jobs"], ess):
            rec["ess"] = e
        run.record["ess_total"] = float(np.sum(ess))
        s.chosen = sampling.picks(run, s.jobs, c["jobs"], c["runs"],
                                  c["steps"])
    return sampling.follow(run, s, s.chosen, control)
