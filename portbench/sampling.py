"""What the sampling loops share: set-up, one job through the program's
driver with its records, the picks of recorded epochs that the check
follows, the ESS of the predictive mean, and the profiled sub-window's
records.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

import check
import inputs
import profiling as tr
import yardstick
from reference.mlp import Stack


class State:
    pass


def sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def setup(run) -> State:
    """The data, the driver and a warm-up job of the cell's own shapes
    (``warmup``: its epochs and burn-in), outside the window."""
    import system
    run.mark("program_import")
    s = State()
    cfg, tf = run.config, run.traffic
    s.dev = run.devices[0]
    s.stack = Stack(cfg)
    s.x, s.y = inputs.make_data(cfg["data"], run.seed, s.dev)
    mesh = tf["job"].get("mesh")
    s.sampler = system.Sampler(cfg, tf, s.stack, mesh_shape=mesh,
                               devices=run.devices if mesh else None)
    run.mark("data_and_model")
    s.system = system
    w = tf["warmup"]
    for k in range(w["jobs"]):
        theta0, eta0 = inputs.initial_network(
            cfg, s.stack, inputs.derived_seed(run.seed, 9, k), s.dev)
        s.sampler.run(s.x, s.y, theta0, eta0,
                      inputs.derived_seed(run.seed, 10, k), w["epochs"],
                      w["burnin"])
    sync(run.devices)
    run.mark("warmup")
    s.jobs = []
    return s


def run_job(run, s: State, root: int, k: int, epochs: int, burnin: int,
            traced: bool, on_start=None, on_end=None) -> dict:
    """Job ``k`` of the seed ``root`` (its initial network and generator
    from ``(root, k)``): its wall, work and records. ``traced`` passes the
    program a ``RunTracer`` (whose chunk ends synchronise)."""
    theta0, eta0 = inputs.initial_network(
        run.config, s.stack, inputs.derived_seed(root, 1, k), s.dev)
    gen_seed = inputs.derived_seed(root, 101, k)
    counts = s.system.graph_counts()
    counts.reset()
    tracer = s.system.ChunkTracer(on_start, on_end) if traced else None
    sync(run.devices)
    t0 = time.perf_counter()
    res = s.sampler.run(s.x, s.y, theta0, eta0, gen_seed, epochs, burnin,
                        tracer=tracer)
    sync(run.devices)
    wall = time.perf_counter() - t0
    chains = res.theta_samples.shape[1]
    leap = np.asarray(res.leapfrog, np.float64)
    return {"wall_s": wall, "epochs": epochs, "chains": chains,
            "burnin": burnin, "gen_seed": gen_seed,
            # every chain counts at its own group's L: the per-epoch
            # record is the mean over the (equal) groups
            "steps": float(chains * leap.sum()),
            "evaluations": float(chains * (leap + 1.0).sum()),
            "capture_s": list(counts.capture_seconds),
            "chunks": ([(c.epochs, c.leapfrog, c.seconds)
                        for c in tracer.chunks] if tracer else None),
            "theta": res.theta_samples, "eta": res.eta_samples,
            # what the program reports of its steps: each epoch's L (the
            # mean over the groups) and the chains' mean hyper step
            "leapfrog": leap, "hyper_step": float(res.final_hyper_step),
            "main_path": res.main_path, "runner": res.chunk_runner}


def shape(run, s: State) -> dict:
    """The shapes the yardstick takes."""
    job = run.traffic["job"]
    return {"C": job["n_chains"], "D": s.stack.D, "H": s.stack.H,
            "N": int(s.x.shape[0]), "d_in": int(s.x.shape[1]),
            "rows_per_call": int(job.get("data_chunk") or s.x.shape[0]),
            "cards": len(run.devices)}


def predictive_ess(s: State, theta: np.ndarray, at: float) -> float:
    """Total ESS over chains of the predictive mean at ``x = at``
    (``quality_figures``' statistic, chip_smoke.py:1164-1200), by the
    frozen ESS arithmetic."""
    n, c, d = theta.shape
    xq = torch.tensor([[at]], dtype=torch.float64, device=s.dev)
    flat = torch.as_tensor(theta.reshape(n * c, d), device=s.dev)
    series = torch.cat([s.stack.forward(flat[i:i + 65536], xq)[:, 0, 0]
                        for i in range(0, n * c, 65536)])
    return yardstick.effective_sample_size_batch(
        series.reshape(n, c).T.cpu().numpy())


def picks(run, jobs: List[dict], n_jobs: int, runs: int, steps: int):
    """The recorded epochs the check follows: ``n_jobs`` jobs drawn from
    the seed, the window's last among them, and in each ``runs`` runs of
    ``steps`` consecutive transitions, drawn from the seed, the job's last
    among them."""
    rng = np.random.default_rng(inputs.derived_seed(run.seed, 20))
    last = len(jobs) - 1
    others = rng.permutation(last)[:max(0, n_jobs - 1)].tolist()
    out = []
    for j in sorted(set(others) | {last}):
        job = jobs[j]
        n = job["theta"].shape[0]
        if n < steps + 1:
            raise ValueError(f"a job recorded {n} epochs; the check follows "
                             f"{steps} consecutive transitions")
        starts = {n - steps - 1}
        while len(starts) < min(runs, n - steps):
            starts.add(int(rng.integers(0, n - steps)))
        for s0 in sorted(starts):
            first = job["burnin"] + 1 + s0
            out.append({"theta": np.array(job["theta"][s0:s0 + steps + 1]),
                        "eta": np.array(job["eta"][s0:s0 + steps + 1]),
                        "first_epoch": first, "gen_seed": job["gen_seed"],
                        "job": j, "hyper_step": job["hyper_step"],
                        # the L the program reports for each transition
                        # (epochs first + 1 ...; 1-based)
                        "leapfrog": np.array(
                            job["leapfrog"][first:first + steps])})
    return out


def follow(run, s: State, chosen: list, control: bool) -> dict:
    """Frees the program's state, then follows ``chosen``."""
    for job in s.jobs:
        job.pop("theta", None)
        job.pop("eta", None)
    s.sampler = None
    for d in run.devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    if not hasattr(s, "check_state"):
        s.check_state = {}
    readings, counts = check.follow_jobs(run.config, run.traffic, s.x, s.y,
                                         chosen, s.check_state, control)
    run.record["check_counts_control" if control else "check_counts"] = \
        counts
    return readings


def profile_record(run, window: tr.Window, chunks) -> None:
    """The profiled sub-window's records: its events, length, busy time a
    card and breakdown, and the chunks it covered ``[(epochs, L), ...]``."""
    events = window.events()
    busy = tr.busy_by_card(events)
    run.record["profile_events"] = events
    run.record["profile_s"] = window.seconds
    run.record["profile_chunks"] = chunks
    run.record["busy_s"] = (float(np.mean([busy.get(d.index or 0, 0.0)
                                           for d in run.devices]))
                            if busy else 0.0)
    run.record["breakdown"] = tr.breakdown(events)
