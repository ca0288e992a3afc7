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
  hyper step 1e-4): K3 + K2;
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
  SquarePrelu).

Last, ``K3 tutorial call``: one K3 call (value and gradient) at the
tutorial-shaped classifier (784-20-20-1 with SquarePrelu, sigmoid and
Bernoulli over 9,585 rows, 64 chains, 0.3 N(0, 1) weights), kernel by
kernel: device ms and launches per call of each kernel name, and the
call's total.

It reports, per epoch: the wall time over three unprofiled windows (host
clock after a synchronize), the enqueue time (until the runner returns),
and under ``torch.profiler`` the device's busy time (the union of kernel
and copy intervals), each kernel group's time and launches (K1, K2, K3,
and the torch ops around them), the kernels that take the most time, and
the idle share, 1 - busy / median wall. One JSON line per cell.
"""

import json
import os
import statistics
import sys
import tempfile
import time

import torch

#: kernel-name substrings of each hand-written kernel
GROUPS = (("K1", ("trajectory_kernel",)), ("K2", ("hyper_kernel",)),
          ("K3", ("gemm_kernel", "tail_kernel", "slope_grad_kernel")))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: kernels listed by name, the most expensive first
TOP_KERNELS = 8


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
    """Busy ms, per-group and top per-kernel ms and launches per epoch,
    from a chrome trace of ``epochs`` profiled epochs."""
    state = [carry]

    def chunk():
        state[0], _ = run(state[0], eps, steps, epochs, gen)

    events = profiled_events(chunk, 1)
    carry = state[0]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
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
    return carry, busy / 1e3 / epochs, group_rows, top


def profiled_events(fn, reps):
    """Device events (kernels and copies) of ``reps`` calls of ``fn``,
    from a chrome trace of ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    return events


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
    events = profiled_events(glue, reps)
    return {"enqueue_ms": 1e3 * (t1 - t0) / reps,
            "wall_ms": 1e3 * (t2 - t0) / reps,
            "device_ms": sum(float(e["dur"]) for e in events) / 1e3 / reps,
            "launches": len(events) / reps}


def cell(name, run, carry, eps, steps, warm, window, profiled, gen, card,
         glue=None):
    carry, _ = run(carry, eps, steps, warm, gen)
    enqueue, wall = [], []
    for _ in range(3):
        carry, e_ms, w_ms = timed(run, carry, eps, steps, window, gen)
        enqueue.append(e_ms)
        wall.append(w_ms)
    carry, busy, groups, top = device_breakdown(run, carry, eps, steps,
                                                profiled, gen)
    if not torch.isfinite(carry.theta).all():
        raise AssertionError(f"{name}: the chains left the finite range")
    median = statistics.median(wall)
    out = {"cell": name, "card": card, "wall_ms_per_epoch": wall,
           "enqueue_ms_per_epoch": enqueue, "device_busy_ms_per_epoch": busy,
           "idle_share": 1.0 - busy / median, "groups": groups,
           "top_kernels": top}
    if glue is not None:
        out["swap_glue_per_epoch"] = glue_breakdown(glue(carry))
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from chip_smoke import card_line, chunk_runner, \
        classification_network, flagship_network, wide_network
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

    n_rungs, n_cold = 4, 512
    ladder = make_ladder(n_rungs, 0.5)
    tempering_beta = (n_rungs, np.repeat(ladder, n_cold))
    fleet = n_rungs * n_cold
    for name, build, eps, steps, hyper_steps, hyper_eps, sizes, temper, \
            chains, uturn in (
            ("flagship", flagship_network, 1e-3, 100, 100, 1e-3,
             (10, 50, 20), False, 64, False),
            ("wide_deep", wide_network, 1e-5, 20, 5, 1e-4, (1, 5, 3),
             False, 64, False),
            ("tempered 512 x 4", flagship_network,
             np.full(fleet, 2e-3, np.float32), np.full(fleet, 50), 30, 1e-3,
             (10, 50, 20), True, fleet, False),
            ("uturn 512", flagship_network, 3e-3, 200, 30, 1e-3,
             (10, 50, 20), False, 512, True),
            ("classification 128", classification_network, 5e-4, 50, 10,
             1e-4, (10, 50, 20), False, 128, False)):
        net, lik = build(dev)
        params, hypers = net.init_state()
        flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
        run = chunk_runner(net, lik, flat, hyper_steps, hyper_eps,
                           tempering_beta if temper else None,
                           record_uturn=uturn)
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
    k3_call_breakdown(dev, gen, card)
    return 0


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
    for e in profiled_events(lambda: vg(thetas, 1.0, x, y), reps):
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
