"""Where a steady sampler epoch spends its time on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_profile.py``. It needs one
CUDA card and ``nvcc``, and imports torch, ``tensorbnn_tpu_torch`` and
``chip_smoke`` (for its model constructors and ``chunk_runner``). For each
cell it runs the chunk runner with the kernels that ``sample_posterior``
picks:

- ``flagship``: 1-10-10-10-1 tanh, fixed sd, 64 chains, (eps, L) =
  (1e-3, 100), 100 hyper steps per epoch: K1 + K2;
- ``wide_deep``: 10x256 tanh over 128 rows, learned sd, 64 chains,
  (eps, L) = (1e-5, 20), 5 hyper steps per epoch (the JAX bench's shape,
  hyper step 1e-4): K3 + K2, on the stepped runner and (``wide_deep
  eager``) on the eager one;
- ``tutorial 64``: the tutorial-shaped classifier
  (``chip_smoke.tutorial_network``: 784-20-20-1 SquarePrelu, sigmoid,
  Bernoulli over 9,585 rows, the Network's init), 64 chains at (eps, L) =
  (1e-3, 50), 30 hyper steps from 1e-4: K3 and the plain hyper block, on
  the stepped runner and (``tutorial 64 eager``) on the eager one;
- ``tempered``: the flagship's tempered quality block, 512 chains x 4
  rungs at beta_min 0.5 (2,048 replicas), per-chain (eps, L) = (2e-3, 50)
  (``ess_run``'s start), 30 hyper steps from 1e-3: tempered K1 + K2, then
  each epoch's swap glue. For that glue (the data log-likelihood of every
  replica and the even/odd swap, plain torch) the cell also reports its
  own enqueue ms, device ms and launches per epoch, timed alone;
- ``uturn 512``: the flagship's U-turn quality block, 512 chains at the
  shared (eps, L) = (3e-3, 200) its sampling epochs run (L at the
  ``leapfrog_max`` it settles on), 30 hyper steps from 1e-3: K1's
  U-turn-recording program + K2.
- ``classification 128``: the JAX bench's ``classification`` cell
  (SquarePrelu + sigmoid + Bernoulli, 10-16-16-1 over 64 rows), 128
  chains at its (eps, L) = (5e-4, 50), 10 hyper steps from 1e-4: K1
  variant (d), and the plain hyper block (no stats layout for
  SquarePrelu);
- ``mesh 4x1``: the flagship cell over a 4x1 mesh whose entries are all
  the first card (16 chains a shard): K1 + K2 a shard, a captured graph a
  shard (parallel/graphs.py), the shards replayed one after another;
- ``mesh 4 cards``: the flagship at 4 x 64 chains over a 4x1 mesh of four
  distinct cards (64 chains a card, the flagship cell's on each), the
  graphs replayed on the four cards at once; on a machine with fewer
  cards it prints that it was skipped. Its busy ms are also given a card;
- ``mesh wide_deep 2x2``: the ``wide_deep`` cell over a 2x2 mesh of the
  first card (32 chains a chain shard, 64 rows a data peer): K3 on each
  peer and K2, each part of the stepped runner split at its sums over the
  data peers, and (``mesh wide_deep 2x2 eager``) the eager mesh runner;
- ``mesh surrogate 1x4``: the ``surrogate`` cell over a 1x4 mesh of the
  first card (250,000 rows a data peer, two 125,000-row chunks each), on
  the stepped runner and (``... eager``) the eager one; then ``mesh
  surrogate 4 cards``, the same over four distinct cards, each card's
  busy ms beside the busiest's (skipped on a machine with fewer cards);
- ``surrogate``: the JAX bench's 1M-point ``surrogate_quality_exact``
  (``chip_smoke.surrogate_network``: 8-64-64-1 tanh over 1M x 8 points,
  MAP warm start, learned sd) at 32 chains on the plain path that
  ``numerics="exact"`` and ``data_chunk=125,000`` take, at (eps, L) =
  (3.2e-5, 15) (where the JAX package's full-length run settled), 5
  hyper steps from 1e-6: the plain main and hyper blocks.

``python3 chip_profile.py <cell>`` profiles the cells above whose names
begin with ``<cell>`` (``flagship``, ``wide_deep``, ``mesh``, ...),
``python3 chip_profile.py surrogate``
the ``surrogate`` cell; with ``--full`` it then runs the bench's whole
schedule through ``Network.train`` (600 epochs, burn-in 200, every second
epoch recorded) from the JAX package's MAP warm start
(``chip_smoke.SURR_WARM_START``) and prints its quality line (post-burn-in
acceptance, the epochs run at each (eps, L) after burn-in, the adapter's
updates, ESS of the predictive mean at the first input row per second of
the run's wall, the learned sd, peak memory by phase) beside the TPU
capture's statistics; ``--full --seeds 11,12,13`` runs the same at each of
those Network seeds (the bench's is 3) without the cell
(``surrogate_full``), and ``--out DIR`` writes each run's per-epoch figures (and each seed's last
state) to ``DIR``.

``python3 chip_profile.py classification --full --seeds 11,12`` runs the
moons example's full MCMC (4,000 epochs, one chain) through
``Network.train`` at each of those Network seeds from the JAX package's
warm start (``moons_full``: a ``{"moons_seed": ...}`` line a seed; ``--out
DIR`` writes each seed's per-epoch figures and last state to ``DIR``), and
``python3 chip_profile.py classification --band DIR [DIR ...]`` (no card
needed) puts the seed files of those folders beside the JAX package's
seeds (``moons_band``).

Then ``pretrain`` (alone: ``python3 chip_profile.py pretrain``):
``chip_smoke.pretrain_runners`` at the JAX bench's surrogate pretraining
(1M x 8 points, 2 x 64 tanh, batch 8,192, 4 epochs) and at the
tutorial's first cycle (784-20-20-1 with trained slopes, batch 32, 10
epochs): the eager epochs and the graph of a step, bit-equal, each with
a steady epoch's seconds, device ms by kernel, host launches and idle
share, and the capture's seconds; then, at each shape, a graph of the
whole epoch against the graph of a step: the seconds of each capture
(the epoch's split into ``gc.collect``, recording and instantiation) and
of each one's replayed epochs.

Then ``K3 tutorial call``: one K3 call (value and gradient) at the
tutorial-shaped classifier (784-20-20-1 with SquarePrelu, sigmoid and
Bernoulli over 9,585 rows, 64 chains, 0.3 N(0, 1) weights), kernel by
kernel: device ms and launches per call of each kernel name, and the
call's total.

Last, ``predict`` (alone: ``python3 chip_profile.py predict``): one
``Predictor.predict`` call of the JAX bench's predict cell
(``chip_smoke.predict_cell``: 2,000 flagship networks x 4,096 points) on
each route, eager and graph (the forward a replay of its captured
graph), its host time split by the host clock into the input's copy to
the card, the forward's enqueue (on the graph route the copy into the
graph's input buffer and the replay), the wait for the forward and the
copy of the predictions to the host (through pinned memory), and under
``torch.profiler`` each kernel's and copy's device ms a call.

It reports, per epoch: the wall time over three unprofiled windows (host
clock after a synchronize), the enqueue time (until the runner returns),
and under ``torch.profiler`` the device's busy time (the union of kernel
and copy intervals), each kernel group's time and launches (K1, K2, K3,
and the torch ops around them), the kernels that take the most time, the
host's launches (kernel and graph launches, copies and fills), and the
idle share, 1 - busy / median wall. One JSON line per cell, with the
runner that ran it: the K1 cells (flagship, tempered, U-turn,
classification, the mesh cells) run on the graph runner
(parallel/graphs.py), the K3 and plain-path cells (``wide_deep``, the
tutorial, the surrogate) on the stepped runner, whose captures happen in
the warm-up, before any window; the cells named ``eager`` on the eager
runner.
"""

import gc
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from chip_smoke import busy_ms, device_events, host_launches, trace_events

#: kernel-name substrings of each hand-written kernel
GROUPS = (("K1", ("trajectory_kernel",)), ("K2", ("hyper_kernel",)),
          ("K3", ("gemm_kernel", "tail_kernel", "slope_grad_kernel",
                  "slice_sum_kernel")))
#: kernels listed by name, the most expensive first
TOP_KERNELS = 16


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "torch"


def timed(run, carry, eps, steps, epochs, gen):
    """(carry, enqueue ms, wall ms) per epoch over one window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = run(carry, eps, steps, epochs, gen)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return carry, 1e3 * (t1 - t0) / epochs, 1e3 * (t2 - t0) / epochs


def device_breakdown(run, carry, eps, steps, epochs, gen):
    """Busy ms (the busiest card's), per-group and top per-kernel ms and
    launches per epoch, the host's launches per epoch (kernel and graph
    launches, copies and fills) and each card's busy ms, from a chrome
    trace of ``epochs`` profiled epochs."""
    state = [carry]

    def chunk():
        state[0], _ = run(state[0], eps, steps, epochs, gen)

    everything = trace_events(chunk, 1)
    events = device_events(None, events=everything)
    carry = state[0]
    # each card's busy ms, and the busiest card's as the busy ms: on four
    # cards the union of all cards' intervals exceeded the wall (their
    # timestamps are not on one clock)
    cards = sorted({e.get("args", {}).get("device") for e in events},
                   key=str)
    per_card = {str(i): busy_ms([e for e in events
                                 if e.get("args", {}).get("device") == i])
                / epochs for i in cards}
    groups, kernels = {}, {}
    for e in events:
        name = e.get("name", "")
        g = group_of(name) if e["cat"] == "kernel" else "copy"
        for table, key in ((groups, g), (kernels, name[:100])):
            ms, n = table.get(key, (0.0, 0))
            table[key] = (ms + float(e["dur"]) / 1e3, n + 1)
    group_rows = {g: {"ms": ms / epochs, "launches": n / epochs}
                  for g, (ms, n) in sorted(groups.items())}
    top = [[name, ms / epochs, n / epochs] for name, (ms, n) in
           sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]]
    return (carry, max(per_card.values()), group_rows, top,
            host_launches(everything) / epochs, per_card)


def glue_breakdown(glue, reps=50):
    """Enqueue ms, wall ms, device ms and launches per call of ``glue``."""
    glue()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        glue()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    events = device_events(glue, reps)
    return {"enqueue_ms": 1e3 * (t1 - t0) / reps,
            "wall_ms": 1e3 * (t2 - t0) / reps,
            "device_ms": sum(float(e["dur"]) for e in events) / 1e3 / reps,
            "launches": len(events) / reps}


def cell(name, run, carry, eps, steps, warm, window, profiled, gen, card,
         glue=None):
    carry, _ = run(carry, eps, steps, warm, gen)
    # the graph runner captures each chunk length once: the timed and the
    # profiled lengths too, before they are timed
    for n in (window, profiled):
        carry, _ = run(carry, eps, steps, n, gen)
    enqueue, wall = [], []
    for _ in range(3):
        carry, e_ms, w_ms = timed(run, carry, eps, steps, window, gen)
        enqueue.append(e_ms)
        wall.append(w_ms)
    carry, busy, groups, top, launches, per_card = device_breakdown(
        run, carry, eps, steps, profiled, gen)
    if not torch.isfinite(carry.theta).all():
        raise AssertionError(f"{name}: the chains left the finite range")
    median = statistics.median(wall)
    out = {"cell": name, "card": card,
           "runner": getattr(run, "runner", "eager"),
           "wall_ms_per_epoch": wall,
           "enqueue_ms_per_epoch": enqueue, "device_busy_ms_per_epoch": busy,
           "idle_share": 1.0 - busy / median,
           "device_busy_ms_per_epoch_by_card": per_card,
           "host_launches_per_epoch": launches, "groups": groups,
           "top_kernels": top}
    if glue is not None:
        out["swap_glue_per_epoch"] = glue_breakdown(glue(carry))
    print(json.dumps(out), flush=True)
    return out


def mesh_surrogate_cells(dev, gen, card):
    """The ``mesh surrogate`` cells (see the module docstring): the
    surrogate cell's runner over a 1x4 mesh of the first card and, where
    the machine has four cards, of four distinct cards, each on the
    stepped and on the eager runner."""
    import chip_smoke as cs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.parallel.mesh import make_mesh
    from tensorbnn_tpu_torch.sampler.driver import exact_numerics_model
    from tensorbnn_tpu_torch.sampler.potential import flatten_state

    x, y = cs.surrogate_data()
    warm = cs.surrogate_pretrain(dev, x, y)
    net, lik = cs.surrogate_network(dev, x, y, warm, 200)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
    for label, devices in (("1x4", [dev] * 4), ("4 cards", [
            torch.device("cuda", i) for i in range(4)])):
        if len(set(devices)) > torch.cuda.device_count():
            print(json.dumps({"cell": f"mesh surrogate {label}",
                              "card": card, "skipped": "needs 4 cards"}),
                  flush=True)
            continue
        for eager in (False, True):
            run = cs.surrogate_runner(
                net, lik, flat, exact_numerics_model(net.model),
                cs.SURR_CHUNK, True, eager=eager, n_chains=cs.SURR_CHAINS,
                mesh=make_mesh(1, 4, devices=devices))
            carry = init_multichain_state(flat.theta, flat.eta,
                                          cs.SURR_MCMC["hyper_step_size"],
                                          cs.SURR_CHAINS, gen)
            cell(f"mesh surrogate {label}" + (" eager" if eager else ""),
                 run, carry, 3.2e-5, 15, 1, 2, 1, gen, card)
            del run, carry
            torch.cuda.empty_cache()


def surrogate_cell(dev, gen, card):
    """The ``surrogate`` cell (see the module docstring)."""
    import chip_smoke as cs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.sampler.driver import exact_numerics_model
    from tensorbnn_tpu_torch.sampler.potential import flatten_state

    x, y = cs.surrogate_data()
    warm = cs.surrogate_pretrain(dev, x, y)
    net, lik = cs.surrogate_network(dev, x, y, warm, 200)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
    run = cs.surrogate_runner(net, lik, flat, exact_numerics_model(
        net.model), cs.SURR_CHUNK, True)
    carry = init_multichain_state(flat.theta, flat.eta,
                                  cs.SURR_MCMC["hyper_step_size"],
                                  cs.SURR_CHAINS, gen)
    cell("surrogate 32 x 1M, exact, chunk 125,000", run, carry, 3.2e-5, 15,
         1, 2, 1, gen, card)
    del run, carry
    torch.cuda.empty_cache()


class MemoryTracer:
    """A ``sample_posterior`` tracer that reads the card's allocator around
    each chunk: the peak of ``torch.cuda.max_memory_allocated`` during the
    chunk (its runner and the rows it records) and the bytes still
    allocated after it (the carry and the recorded rows so far), both above
    ``held``, the bytes allocated before the run, and the peak of
    ``max_memory_reserved`` (a graph's pool stays reserved between its
    replays, which allocate nothing); the peak between chunks, and after
    the last one (the driver gathering the recorded rows) once ``finish``
    is called."""

    def __init__(self, held: int):
        self.held, self.chunks, self.between = held, [], 0
        torch.cuda.reset_peak_memory_stats()

    def _peak(self) -> int:
        return torch.cuda.max_memory_allocated() - self.held

    def start_chunk(self):
        self.between = max(self.between, self._peak())
        torch.cuda.reset_peak_memory_stats()

    def end_chunk(self, epochs, leapfrog, n_chains, max_leapfrog=None):
        self.chunks.append((self._peak(),
                            torch.cuda.memory_allocated() - self.held,
                            torch.cuda.max_memory_reserved()))
        torch.cuda.reset_peak_memory_stats()

    def finish(self) -> dict:
        peaks, held, reserved = (list(v) for v in zip(*self.chunks))
        return {"chunks_peak_bytes": max(peaks),
                "chunks_peak_at_chunk": int(np.argmax(peaks)),
                "chunk_peaks_bytes": peaks,
                "held_after_first_chunk_bytes": held[0],
                "held_after_last_chunk_bytes": held[-1],
                "chunks_reserved_peak_bytes": max(reserved),
                "first_chunk_reserved_peak_bytes": reserved[0],
                "last_chunk_reserved_peak_bytes": reserved[-1],
                "between_chunks_peak_bytes": self.between,
                "after_last_chunk_peak_bytes": self._peak()}


def record_adapters(driver, made: list, patch=setattr):
    """Patches ``driver.MCMCConfig.make_adapter`` (``driver``: the port's
    ``sampler.driver`` module or the JAX package's, whose adapters have the
    same fields) through ``patch(obj, name, value)`` so that each GP-UCB
    adapter it makes goes to ``made`` and records its run: in ``trail``,
    after every ``update``, its counter, strike count, step-size bounds,
    resets, the points in its GP window and its answer; in ``log``, for
    each GP/proposal cycle, the epoch whose adapter call ran it (1-based:
    its (eps, L) runs from the next epoch), its phase (``random`` or
    ``gp``), the gating probability p, the new (eps, L) and the strike
    count. Returns the function that undoes the patch."""
    real = driver.MCMCConfig.make_adapter

    def make_adapter(self, seed=None):
        a = real(self, seed)
        a.trail, a.log = [], []
        update, gp_update = a.update, a._gp_update

        def logged_update(sjd):
            out = update(sjd)
            a.trail.append((a.i, a.strikes, a.el, a.eu, a.n_resets,
                            len(a.all_data), float(out[0]), int(out[1])))
            return out

        def logged_gp_update():
            phase = "gp" if a.i // a.m >= a.random_steps else "random"
            gp_update()
            # update() runs at epoch e (1-based) with the counter at e - 3
            a.log.append({"epoch": int(a.i) + 3, "phase": phase,
                          "p": float(a.p), "eps": float(a.current_e),
                          "leapfrog": int(a.current_l),
                          "strikes": int(a.strikes)})
        a.update, a._gp_update = logged_update, logged_gp_update
        made.append(a)
        return a

    patch(driver.MCMCConfig, "make_adapter", make_adapter)
    return lambda: setattr(driver.MCMCConfig, "make_adapter", real)


def segments(log, start, accept, burnin) -> list:
    """The post-burn-in epochs run at each (eps, L), in order, from an
    adapter's ``log`` and its start ``(eps, L)``: each stretch's first and
    last epoch (1-based), (eps, L) and mean main acceptance (``accept``,
    per epoch)."""
    n = len(accept)
    plan = np.empty((n, 2))
    plan[:] = start
    for entry in log:
        plan[entry["epoch"]:] = (entry["eps"], entry["leapfrog"])
    out = []
    for e in range(burnin, n):
        if out and tuple(plan[e]) == (out[-1]["eps"], out[-1]["leapfrog"]):
            out[-1]["last"] = e + 1
        else:
            out.append({"first": e + 1, "last": e + 1, "eps": plan[e, 0],
                        "leapfrog": int(plan[e, 1])})
    for seg in out:
        seg["epochs"] = seg["last"] - seg["first"] + 1
        seg["main_accept"] = float(np.mean(
            accept[seg["first"] - 1:seg["last"]]))
    return out


def surrogate_train(dev, x, y, warm, seed, epochs, burnin):
    """The surrogate (``chip_smoke.surrogate_network`` from ``warm`` at
    Network seed ``seed``) through ``Network.train`` for ``epochs`` epochs
    of the bench's schedule (32 chains, ``numerics="exact"``,
    ``data_chunk=125,000``, every second epoch after ``burnin`` recorded)
    under a ``MemoryTracer`` and ``record_adapters``: ``(net, res, wall,
    memory, adapter)``."""
    import chip_smoke as cs
    from tensorbnn_tpu_torch.sampler import driver

    net, lik = cs.surrogate_network(dev, x, y, warm, burnin, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tracer = MemoryTracer(torch.cuda.memory_allocated())
    made = []
    undo = record_adapters(driver, made)
    t0 = time.perf_counter()
    try:
        res = net.train(epochs, 2, lik, n_chains=cs.SURR_CHAINS,
                        chain_jitter=0.0, data_chunk=cs.SURR_CHUNK,
                        numerics="exact", display_skip=50, tracer=tracer)
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not np.isfinite(res.theta_samples).all():
        raise AssertionError(f"surrogate seed {seed}: non-finite samples")
    return net, res, wall, tracer.finish(), made[0]


def surrogate_full(dev, card, seeds, epochs=600, burnin=200, out_dir=None):
    """The bench's whole ``surrogate_quality_exact`` schedule (600 epochs,
    burn-in 200, every second epoch recorded, 32 chains, ``numerics=
    "exact"``, ``data_chunk=125,000``) through ``Network.train`` at each
    Network seed of ``seeds``, every run from the JAX package's committed
    MAP warm start (``chip_smoke.SURR_WARM_START``). First the port's own
    pretraining at the bench's settings, for its peak memory and MSE. Then
    a ``{"surrogate_seed": ...}`` line a seed: post-burn-in main and hyper
    acceptance, the epochs run at each (eps, L) after burn-in with their
    acceptance, the adapter's updates (epoch, phase, gating probability,
    (eps, L), strikes), total and min-param ESS and their rates, the
    learned sd, and peak memory split into the sampling chunks (each
    chunk's), the recorded rows and the ESS diagnostics; with ``out_dir``,
    each seed's per-epoch acceptance, SJD and leapfrog and the last
    recorded state of chains 0-3 (theta and eta in one float32 row a
    chain) are written there."""
    import chip_smoke as cs

    x, y = cs.surrogate_data()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    port_warm = cs.surrogate_pretrain(dev, x, y)
    pretrain = {"peak_bytes": torch.cuda.max_memory_allocated() - held,
                "port_mse": cs.host_loss(port_warm, x, y, False, tanh=True)}
    del port_warm
    warm = cs.surrogate_jax_warm_start()
    pretrain["jax_warm_start_mse"] = cs.host_loss(warm, x, y, False,
                                                  tanh=True)
    print(json.dumps({"surrogate_pretraining": pretrain, "card": card}),
          flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    start = (cs.SURR_MCMC["step_size_start"], cs.SURR_MCMC["leapfrog_start"])
    for seed in seeds:
        net, res, wall, memory, adapter = surrogate_train(
            dev, x, y, warm, seed, epochs, burnin)
        memory["recorded_rows_bytes"] = int(
            res.theta_samples.nbytes + res.eta_samples.nbytes)
        torch.cuda.synchronize()
        ess_held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        figures = cs.quality_figures(f"surrogate {epochs} epochs", net, res,
                                     wall, burnin, xq=x[:1])
        torch.cuda.synchronize()
        memory["ess_diagnostics_peak_bytes"] = (
            torch.cuda.max_memory_allocated() - ess_held)
        memory["pretraining_peak_bytes"] = pretrain["peak_bytes"]
        line = dict(figures, seed=seed, card=card, burnin=burnin,
                    main_path=res.main_path,
                    chunk_runner=res.chunk_runner,
                    learned_sd=float(np.mean(res.eta_samples[:, :, -1]
                                             ** 2)),
                    post_burnin=segments(adapter.log, start,
                                         res.main_accept, burnin),
                    updates=adapter.log, strikes=int(adapter.strikes),
                    n_resets=int(adapter.n_resets), memory=memory,
                    tpu_capture=cs.TPU_SURROGATE_REF)
        print(json.dumps({"surrogate_seed": line}), flush=True)
        if out_dir:
            with open(os.path.join(out_dir, f"surrogate_seed{seed}.json"),
                      "w") as f:
                json.dump(dict(line, main_accept_per_epoch=res.main_accept
                               .tolist(), hyper_accept_per_epoch=res
                               .hyper_accept.tolist(), sjd_per_epoch=res
                               .sjd.tolist(), leapfrog_per_epoch=res
                               .leapfrog.tolist()), f)
            np.save(os.path.join(out_dir,
                                 f"surrogate_state_seed{seed}.npy"),
                    np.concatenate([res.theta_samples[-1, :4],
                                    res.eta_samples[-1, :4]], axis=1))
        del net, res
        torch.cuda.empty_cache()


def moons_full(dev, card, seeds, out_dir=None):
    """The moons example's full MCMC run (examples/classification.py:89-
    105: ``chip_smoke.MOONS_MCMC``, 4,000 epochs, one chain, every 10th
    epoch recorded into a folder of 50 networks a file, the accuracy
    metric) through ``Network.train`` at each Network seed of ``seeds``,
    every run from the JAX package's committed warm start
    (``chip_smoke.MOONS_WARM_START``). A
    ``{"moons_seed": ...}`` line a seed: the posterior ensemble's
    validation accuracy through ``Predictor`` over the run's folder,
    ``chip_smoke.quality_figures`` (post-burn-in main and hyper
    acceptance, the final (eps, L), ESS of the predictive probability at
    the first validation row and the worst parameter's pooled ESS, per
    second of the run's wall), the run's main path, chunk runner, kernel
    launches and ``graphs.COUNTS``; with ``out_dir``, each seed's
    per-epoch acceptance and leapfrog and its last recorded theta and eta
    (one float32 row) are written there."""
    import chip_smoke as cs
    from tensorbnn_tpu_torch import Predictor
    from tensorbnn_tpu_torch.metrics import Accuracy
    from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
    from tensorbnn_tpu_torch.parallel import graphs

    epochs, burnin = cs.MOONS_EPOCHS, cs.MOONS_MCMC["burnin"]
    warm = cs.moons_jax_warm_start()
    _, _, xv, yv = cs.moons_data()
    counted = {"K1": fused_mlp.fused_trajectory,
               "K2": fused_hyper.fused_hyper_trajectory,
               "K3": fused_mlp.fused_potential}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for seed in seeds:
        net, lik = cs.moons_network(dev, seed, warm)
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.LAUNCHES = 0
        graphs.COUNTS.reset()
        with tempfile.TemporaryDirectory() as tmp:
            folder = os.path.join(tmp, "run")
            t0 = time.perf_counter()
            res = net.train(epochs, cs.MOONS_STEP, lik,
                            metric_list=[Accuracy()], adjust_hypers=True,
                            folder_name=folder,
                            networks_per_file=cs.MOONS_PER_FILE,
                            display_skip=max(epochs // 10, 1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.LAUNCHES for k, fn in counted.items()}
            pred = Predictor(folder, likelihood=lik, device=dev)
            probs = pred.predict(xv, n=1).mean(axis=0)[:, 0]
            networks = pred.n_networks
        if not np.isfinite(res.theta_samples).all():
            raise AssertionError(f"moons seed {seed}: non-finite samples")
        figures = cs.quality_figures(f"moons {epochs} epochs", net, res,
                                     wall, burnin, xq=xv[:1])
        line = dict(figures, seed=seed, card=card, burnin=burnin,
                    samples=int(res.theta_samples.shape[0]),
                    networks=int(networks),
                    val_accuracy=float(np.mean((probs > 0.5)
                                               == (yv > 0.5))),
                    leapfrog_work=float(np.sum(res.leapfrog)),
                    main_path=res.main_path, fused_hyper=res.fused_hyper,
                    chunk_runner=res.chunk_runner, launches=launches,
                    graph_counts=graphs.COUNTS.as_dict())
        print(json.dumps({"moons_seed": line}), flush=True)
        if out_dir:
            with open(os.path.join(out_dir, f"moons_seed{seed}.json"),
                      "w") as f:
                json.dump(dict(line, main_accept_per_epoch=res.main_accept
                               .tolist(), hyper_accept_per_epoch=res
                               .hyper_accept.tolist(), leapfrog_per_epoch=res
                               .leapfrog.tolist()), f)
            np.save(os.path.join(out_dir, f"moons_state_seed{seed}.npy"),
                    np.concatenate([res.theta_samples[-1, 0],
                                    res.eta_samples[-1, 0]])[None])
        del net, res
        torch.cuda.empty_cache()


def moons_band(dirs) -> dict:
    """The card's full moons seeds (each ``moons_seed*.json`` that
    ``moons_full`` wrote to one of ``dirs``) against the JAX package's
    (``chip_smoke.MOONS_JAX_SEEDS``): ``chip_smoke.seed_band`` of
    ``MOONS_BAND`` and of the hyper acceptance, each side's final (eps, L)
    and walls, printed as a ``{"moons_band": ...}`` line; ``failed`` names
    each ``MOONS_BAND`` statistic whose z exceeds ``G4_BAND_Z``."""
    import glob

    import chip_smoke as cs

    lines = []
    for d in dirs:
        for path in glob.glob(os.path.join(d, "moons_seed*.json")):
            with open(path) as f:
                lines.append(json.load(f))
    lines.sort(key=lambda line: line["seed"])
    ref = cs.MOONS_JAX_SEEDS
    band = cs.seed_band(lines, ref, cs.MOONS_BAND + ("hyper_accept",))
    out = {"port_seeds": [line["seed"] for line in lines],
           "jax_seeds": [line["seed"] for line in ref],
           "cards": sorted({line["card"] for line in lines}),
           "z_limit": cs.G4_BAND_Z,
           "failed": [k for k in cs.MOONS_BAND
                      if not band[k]["z"] <= cs.G4_BAND_Z],
           **band,
           "port_final": cs.finals(lines, ("final_step_size",
                                           "final_leapfrog")),
           "jax_final": cs.finals(ref, ("final_step_size",
                                        "final_leapfrog")),
           "port_wall_seconds": [line["wall_seconds"] for line in lines],
           "port_main_path": sorted({line["main_path"] for line in lines})}
    print(json.dumps({"moons_band": out}), flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:2] == ["classification", "--band"] and len(argv) > 2:
        # the card's seeds against the JAX package's, on the host
        return 1 if moons_band(argv[2:])["failed"] else 0
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 2

    from chip_smoke import card_line, chunk_runner, \
        classification_network, flagship_network, tutorial_network, \
        wide_network
    from tensorbnn_tpu_torch.parallel.mesh import make_mesh
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
        make_potentials
    from tensorbnn_tpu_torch.sampler.tempering import make_ladder, \
        make_swap_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    if argv[:1] == ["surrogate"]:
        # surrogate [--full [--seeds a,b,...] [--out DIR]]
        full = argv[1:2] == ["--full"]
        opts = dict(zip(argv[2::2], argv[3::2]))
        if (argv[1:] and not full) or len(argv[2:]) % 2 or (
                set(opts) - {"--seeds", "--out"}):
            print(f"chip_profile: unknown surrogate arguments {argv[1:]}",
                  file=sys.stderr)
            return 2
        if "--seeds" not in opts:
            surrogate_cell(dev, gen, card)
        if full:
            surrogate_full(dev, card, [int(s) for s in opts.get(
                "--seeds", "3").split(",")], out_dir=opts.get("--out"))
        return 0
    if argv[:2] == ["classification", "--full"]:
        # classification --full [--seeds a,b,...] [--out DIR]
        opts = dict(zip(argv[2::2], argv[3::2]))
        if len(argv[2:]) % 2 or set(opts) - {"--seeds", "--out"}:
            print(f"chip_profile: unknown classification arguments "
                  f"{argv[1:]}", file=sys.stderr)
            return 2
        import chip_smoke as cs
        moons_full(dev, card, [int(s) for s in opts.get(
            "--seeds", ",".join(map(str, cs.MOONS_SEEDS))).split(",")],
            out_dir=opts.get("--out"))
        return 0
    if argv[:1] == ["pretrain"]:
        pretrain_cells(dev, card)
        return 0
    if argv[:1] == ["predict"]:
        predict_breakdown(dev, card)
        return 0

    n_rungs, n_cold = 4, 512
    ladder = make_ladder(n_rungs, 0.5)
    tempering_beta = (n_rungs, np.repeat(ladder, n_cold))
    fleet = n_rungs * n_cold
    only = argv[0] if argv else None
    four = [torch.device("cuda", i) for i in range(4)]
    for name, build, eps, steps, hyper_steps, hyper_eps, sizes, temper, \
            chains, uturn, devices in (
            ("flagship", flagship_network, 1e-3, 100, 100, 1e-3,
             (10, 50, 20), False, 64, False, None),
            ("mesh 4x1", flagship_network, 1e-3, 100, 100, 1e-3,
             (10, 50, 20), False, 64, False, [dev] * 4),
            ("mesh 4 cards", flagship_network, 1e-3, 100, 100, 1e-3,
             (10, 50, 20), False, 256, False, four),
            ("mesh wide_deep 2x2", wide_network, 1e-5, 20, 5, 1e-4,
             (1, 5, 3), False, 64, False, [dev] * 4),
            ("mesh wide_deep 2x2 eager", wide_network, 1e-5, 20, 5, 1e-4,
             (1, 5, 3), False, 64, False, [dev] * 4),
            ("wide_deep", wide_network, 1e-5, 20, 5, 1e-4, (1, 5, 3),
             False, 64, False, None),
            ("wide_deep eager", wide_network, 1e-5, 20, 5, 1e-4, (1, 5, 3),
             False, 64, False, None),
            ("tutorial 64", tutorial_network, 1e-3, 50, 30, 1e-4, (1, 3, 2),
             False, 64, False, None),
            ("tutorial 64 eager", tutorial_network, 1e-3, 50, 30, 1e-4,
             (1, 3, 2), False, 64, False, None),
            ("tempered 512 x 4", flagship_network,
             np.full(fleet, 2e-3, np.float32), np.full(fleet, 50), 30, 1e-3,
             (10, 50, 20), True, fleet, False, None),
            ("uturn 512", flagship_network, 3e-3, 200, 30, 1e-3,
             (10, 50, 20), False, 512, True, None),
            ("classification 128", classification_network, 5e-4, 50, 10,
             1e-4, (10, 50, 20), False, 128, False, None)):
        if only is not None and not name.startswith(only):
            continue
        cards = 1 if devices is None else len(set(devices))
        if cards > torch.cuda.device_count():
            print(json.dumps({"cell": name, "card": card, "skipped":
                              f"needs {cards} cards"}), flush=True)
            continue
        mesh = None if devices is None else make_mesh(
            *((2, 2) if "2x2" in name else (4, 1)), devices=devices)
        net, lik = build(dev)
        params, hypers = net.init_state()
        flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
        run = chunk_runner(net, lik, flat, hyper_steps, hyper_eps,
                           tempering_beta if temper else None,
                           record_uturn=uturn, mesh=mesh,
                           eager=name.endswith("eager"), n_chains=chains)
        carry = init_multichain_state(flat.theta, flat.eta, hyper_eps,
                                      chains, gen, jitter=0.01)
        glue = None
        if temper:
            pots = make_potentials(net.model, lik, net.train_x, net.train_y,
                                   flat.unravel_theta, flat.unravel_eta)
            swap = make_swap_fn(torch.tensor(ladder, device=dev), n_rungs)

            def glue(state):
                # one epoch's swap glue at the fleet's steady state, as the
                # epoch runs it (sampler/gibbs.py)
                def step():
                    ll = pots.loglik(state.theta, state.eta)
                    log_u = torch.log(torch.rand(fleet, generator=gen,
                                                 device=dev))
                    parity = state.epoch[0].to(torch.int64)
                    return swap(state.theta, state.eta, ll, parity, log_u)
                return step
        cell(name, run, carry, eps, steps, *sizes, gen, card, glue)
        del run, carry, net
        torch.cuda.empty_cache()
    if only is None or "mesh surrogate".startswith(only):
        mesh_surrogate_cells(dev, gen, card)
    if only is not None:
        return 0
    surrogate_cell(dev, gen, card)
    pretrain_cells(dev, card)
    k3_call_breakdown(dev, gen, card)
    predict_breakdown(dev, card)
    return 0


def pretrain_cells(dev, card):
    """The two pretraining shapes of ``chip_smoke.pretrain_shapes`` through
    both runners (``chip_smoke.pretrain_runners``), then the two graph
    designs (``capture_designs``), a JSON line each."""
    import chip_smoke as cs

    x, y = cs.surrogate_data()
    for label, run, epochs, n_batches in cs.pretrain_shapes(dev, x, y):
        row, _ = cs.pretrain_runners(label, run, epochs, n_batches, card)
        print(json.dumps({"cell": f"pretrain {label}", "card": card,
                          **row}), flush=True)
        print(json.dumps({"cell": f"pretrain capture {label}", "card": card,
                          **capture_designs(run)}), flush=True)


def capture_designs(run, reps=5) -> dict:
    """Why pretraining captures a step and not its epoch: in a 2-epoch
    call of ``run(epochs, eager, hook)``, at the one capture, a graph of
    the whole epoch (the body's gather, every step and the validation
    loss) in the steps of ``torch.cuda.graph`` (the ``gc.collect`` before
    it, the recording, ``capture_end``'s instantiation) against the graph
    of a step the trainer keeps, then ``reps`` epochs of each replayed
    (host clock to the validation loss's read). The call's weights go on
    training in these replays: its result is not used."""
    from tensorbnn_tpu_torch.parallel import graphs

    out = {}

    class Measured(graphs.CudaGraph):
        def __init__(self, fn, generator, device):
            body = fn.__self__
            whole = torch.cuda.CUDAGraph()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gc.collect()
            out["epoch_gc_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            with torch.cuda.device(device), \
                    torch.cuda.stream(graphs._side_stream(device)):
                whole.capture_begin(capture_error_mode="global")
                t0 = time.perf_counter()
                body.run(body.step)
                out["epoch_record_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                whole.capture_end()
                out["epoch_instantiate_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            super().__init__(fn, generator, device)
            torch.cuda.synchronize()
            out["step_capture_s"] = time.perf_counter() - t0
            for name, epoch in (("epoch", whole.replay),
                                ("step", lambda: body.run(self.replay))):
                walls = []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    epoch()
                    float(body.val)
                    walls.append(time.perf_counter() - t0)
                out[f"{name}_graph_epoch_s"] = walls

    run(2, False, None, graph_type=Measured)
    return out


def predict_breakdown(dev, card, reps=10):
    """Host ms of one ``Predictor.predict`` call of the predict cell on
    each route (eager, then graph), split into its steps by the host clock
    (each ending in a synchronize), the whole call's host ms (with each
    result dropped at once, and kept alive until the next call returns),
    and each device kernel's and copy's ms a call; one JSON line a
    route."""
    from chip_smoke import predict_cell
    from tensorbnn_tpu_torch.predictor import _to_host

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        pred, x, _ = predict_cell(dev, tmp)
    for route in ("eager", "graph"):
        pred._eager = route == "eager"
        pred.predict(x)
        steps = {"input": 0.0, "forward_enqueue": 0.0, "forward_wait": 0.0,
                 "copy_to_host": 0.0}
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_dev = pred._input(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y, _ = pred._forward(x_dev, 1)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            _to_host(y)
            t4 = time.perf_counter()
            for key, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                steps[key] += 1e3 * dt / reps
        # the whole call, its result dropped at once and, as a caller's
        # loop does (`got = pred.predict(x)`), kept alive until the next
        # returns
        call_ms = {}
        for label in ("dropped", "kept", "dropped again"):
            got = pred.predict(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                if label == "kept":
                    got = pred.predict(x)
                else:
                    pred.predict(x)
            call_ms[label] = 1e3 * (time.perf_counter() - t0) / reps
            del got
        rows = {}
        for e in device_events(lambda: pred.predict(x), reps):
            key = e["name"][:80] if e["cat"] == "kernel" else e["cat"]
            ms, n = rows.get(key, (0.0, 0))
            rows[key] = (ms + float(e["dur"]) / 1e3, n + 1)
        device = [[name, ms / reps, n / reps] for name, (ms, n) in
                  sorted(rows.items(), key=lambda kv: -kv[1][0])]
        print(json.dumps({"cell": "predict 2000 x 4096", "route": route,
                          "card": card, "call_host_ms": call_ms,
                          "steps_host_ms": steps,
                          "device_ms_per_call": sum(r[1] for r in device),
                          "device": device}), flush=True)
    pred._eager = False


def k3_call_breakdown(dev, gen, card, reps=5):
    """Device ms and launches per call of each kernel of one K3 call at
    the tutorial shape (summed by kernel name, so the forward, weight- and
    input-gradient products each come as one row), and the call's total;
    one JSON line."""
    from chip_smoke import TUTORIAL_ROWS, tutorial_network
    from tensorbnn_tpu_torch.ops import fused_mlp

    net, lik = tutorial_network(dev)
    ops, tail = fused_mlp._model_program(net.model, lik)
    _, _, d = fused_mlp._program_dims(ops)
    vg = fused_mlp.make_fused_potential_vg(ops, TUTORIAL_ROWS, tail)
    thetas = 0.3 * torch.randn((64, d), generator=gen, device=dev)
    x, y = net.train_x, net.train_y
    vg(thetas, 1.0, x, y)
    rows = {}
    for e in device_events(lambda: vg(thetas, 1.0, x, y), reps):
        if e["cat"] == "kernel":
            ms, n = rows.get(e["name"][:80], (0.0, 0))
            rows[e["name"][:80]] = (ms + float(e["dur"]) / 1e3, n + 1)
    kernels = [[name, ms / reps, n / reps] for name, (ms, n) in
               sorted(rows.items(), key=lambda kv: -kv[1][0])]
    print(json.dumps({"cell": "K3 tutorial call", "card": card,
                      "ms_per_call": sum(k[1] for k in kernels),
                      "kernels": kernels}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
