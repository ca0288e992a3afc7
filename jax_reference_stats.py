"""The JAX package's sampler statistics for the ``classification`` and
``multiclass`` cells, which ``chip_smoke.py`` holds the port to.

Run from the root of a checkout, on the CPU: ``JAX_PLATFORMS=cpu python3
jax_reference_stats.py``. It imports the JAX package (not the port) and
runs each cell through ``benchmarks/run_benchmarks.py::_bench_sampler``
with ``use_fused=False`` (the XLA path) at the bench's settings: 128
chains, the cell's fixed (eps, L) and hyper steps, model init key 0, chain
jitter 0.01, hyper step 1e-4, one warm-up chunk of 10 epochs and five more
(60 epochs). ``_bench_sampler`` returns the main acceptance of its last
chunk (epochs 51-60); the hyper acceptance of the same chunk is read from
the traces its chunk runner returns. These are statistics of the sampler,
not of any chip. Prints one JSON line per cell.

``JAX_PLATFORMS=cpu python3 jax_reference_stats.py examples`` prints
instead the JAX examples' figures at ``--smoke`` that ``chip_smoke.py``'s
phase 9 holds the port's examples to: ``examples/extended_regression.py``'s
grid RMSE and ``examples/classification.py``'s posterior-ensemble
validation accuracy, each through its ``main`` at the example's own
seeds, then ``extended_regression``'s grid RMSE with its pretraining and
``Network`` seeds both moved to 1000 + k, k = 1..6 (the spread over
initial weights), then ``examples/surrogate_regression.py --cpu --smoke``'s
sample count, main acceptance and learned sd (100,000 points, one chain,
60 epochs under ``numerics="exact"``). One JSON line per run (~30 s
each; the surrogate a few minutes).

``JAX_PLATFORMS=cpu python3 jax_reference_stats.py quality`` prints the
JAX package's seed distribution of the 512-chain, G = 4 quality block
that ``chip_smoke.py``'s phase 6 (b) gates the port's seeds against:
``benchmarks/run_benchmarks.py::ess_run(n_chains=512, n_adapters=4,
epochs=1300)`` at ``Network`` seeds 11-15, one process a seed, all
started together. ``ess_run`` fixes ``seed=11``, so each process moves it
by patching ``tensorbnn_tpu.network.Network`` as ``example_figure`` does.
One JSON line a seed, in seed order: total ESS, min- and median-param
ESS, post-burn-in main and hyper acceptance, the fleet means of the final
(eps, L) and each adapter group's final (eps, L), under the keys of
``chip_smoke.py::quality``. ``--block tempered`` runs the tempered K = 4
block (512 cold chains, beta_min 0.5) and ``--block uturn`` the U-turn
block (``--probe always|alternate``); ``--seed N`` runs one seed in this
process.

``JAX_PLATFORMS=cpu python3 jax_reference_stats.py surrogate --warm-start``
trains the JAX package's MAP warm start of the 1M-point surrogate at the
bench's settings and writes ``tests/data/surrogate_jax_warm_start.npy``;
``... surrogate --ladder`` prints the figures of ``chip_smoke.py``'s phase
10 (g) (``LADDER_JAX``): the JAX package's ``sample_posterior`` over the
1M rows at 4 chains from the warm start and from
``tests/data/surrogate_equilibrium.npy``, at each fixed (eps, L) of
``chip_smoke.LADDER_STEPS`` for 10 epochs, one process a run, all at once
(``--state S --eps E`` runs one here); ``... surrogate --parity`` runs the
port on the CPU against the JAX package over the 1M rows from the
equilibrium state on the JAX package's draws and prints each side's MH
decisions.

``JAX_PLATFORMS=cpu python3 jax_reference_stats.py classification
--warm-start`` trains the JAX package's warm start of the moons example's
stack at its full pretraining and writes
``tests/data/moons_jax_warm_start.npy``; ``... classification`` prints the
figures of the example's full MCMC run (4,000 epochs, one chain) from that
start at ``chip_smoke.MOONS_SEEDS`` (``MOONS_JAX_SEEDS``), one process a
seed, all at once (``--seeds a,b,...`` some of them, ``--seed N`` one in
this process); ``... classification --ladder`` prints the figures of
``chip_smoke.py``'s moons ladder (``MOONS_LADDER_JAX``): 16 chains for 10
epochs at each fixed (eps, L) of ``chip_smoke.MOONS_LADDER_STEPS`` from the
warm start and from ``tests/data/moons_equilibrium.npy``, one process a
run (``--state S --eps E --leapfrog L`` runs one here).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# the JAX seeds of the quality blocks (Network seed; chip_smoke.py runs the
# port at 11-20)
QUALITY_SEEDS = range(11, 16)


def example_figure(name, pattern, seed=None) -> float:
    """The figure ``pattern`` ("<label>: <number>") that the JAX example
    ``name`` prints at ``--cpu --smoke``; with ``seed``, its pretraining
    and ``Network`` seeds are both ``seed``."""
    import contextlib
    import functools
    import importlib.util
    import io
    import re
    import tempfile

    import tensorbnn_tpu.network as net_mod
    import tensorbnn_tpu.training.pretrain as pre_mod

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", f"examples/{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = (net_mod.Network, pre_mod.train_basic_regression, sys.argv)
    if seed is not None:
        class Seeded(saved[0]):
            def __init__(self, *args, **kwargs):
                kwargs["seed"] = seed
                super().__init__(*args, **kwargs)
        net_mod.Network = Seeded
        pre_mod.train_basic_regression = functools.partial(saved[1],
                                                           seed=seed)
    out = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            sys.argv = [name, "--cpu", "--smoke", "--folder", f"{tmp}/run"]
            with contextlib.redirect_stdout(out):
                module.main()
    finally:
        net_mod.Network, pre_mod.train_basic_regression, sys.argv = saved
    return float(re.search(pattern + r": ([0-9.]+)", out.getvalue())[1])


def surrogate_figures() -> dict:
    """``examples/surrogate_regression.py --cpu --smoke``'s printed figures:
    the sample count, the mean main acceptance and the learned sd."""
    import contextlib
    import importlib.util
    import io
    import re

    spec = importlib.util.spec_from_file_location(
        "example_surrogate_regression", "examples/surrogate_regression.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved, out = sys.argv, io.StringIO()
    try:
        sys.argv = ["surrogate_regression", "--cpu", "--smoke"]
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = saved
    m = re.search(r"(\d+) samples, main accept ([0-9.]+), learned sd ~ "
                  r"([0-9.]+)", out.getvalue())
    return {"samples": int(m[1]), "main_accept": float(m[2]),
            "learned_sd": float(m[3])}


def examples() -> int:
    runs = [("extended_regression", "grid RMSE", None),
            ("classification", "posterior-ensemble validation accuracy",
             None)]
    runs += [("extended_regression", "grid RMSE", 1000 + k)
             for k in range(1, 7)]
    for name, pattern, seed in runs:
        t0 = time.perf_counter()
        value = example_figure(name, pattern, seed)
        print(json.dumps({"example": name, "flags": "--cpu --smoke",
                          "seed": seed or "the example's", pattern: value,
                          "cpu_seconds": time.perf_counter() - t0}),
              flush=True)
    t0 = time.perf_counter()
    figures = surrogate_figures()
    print(json.dumps({"example": "surrogate_regression",
                      "flags": "--cpu --smoke", **figures,
                      "cpu_seconds": time.perf_counter() - t0}), flush=True)
    return 0


def quality_figures(seed: int, block: str = "g4",
                    probe: str = "always") -> dict:
    """``ess_run``'s figures for one quality block at ``Network`` seed
    ``seed``, with each adapter group's final (eps, L): the driver keeps
    only their means, so each group's adapter is recorded where the driver
    makes it, and its last answer read as the driver reads it
    (driver.py:1306-1309)."""
    from benchmarks import run_benchmarks as rb
    import tensorbnn_tpu.network as net_mod
    from tensorbnn_tpu.sampler.driver import MCMCConfig

    made = []
    saved = (net_mod.Network, MCMCConfig.make_adapter)

    class Seeded(saved[0]):
        def __init__(self, *args, **kwargs):
            kwargs["seed"] = seed
            super().__init__(*args, **kwargs)

    def make_adapter(self, seed=None):
        made.append(saved[1](self, seed))
        return made[-1]

    net_mod.Network, MCMCConfig.make_adapter = Seeded, make_adapter
    kwargs = {"g4": dict(n_chains=512, n_adapters=4),
              "tempered": dict(n_chains=512, tempering=4,
                               tempering_beta_min=0.5),
              "uturn": dict(n_chains=512, trajectory="uturn",
                            uturn_probe=probe)}[block]
    t0 = time.perf_counter()
    try:
        r = rb.ess_run(epochs=1300, **kwargs)
    finally:
        net_mod.Network, MCMCConfig.make_adapter = saved
    out = {"block": block if block != "uturn" else f"uturn:{probe}",
           "seed": seed, "n_chains": r["n_chains"], "epochs": r["epochs"],
           "total_ess": r["total_ess"], "min_param_ess": r["min_param_ess"],
           "median_param_ess": r["median_param_ess"],
           "main_accept": r["accept_post_burnin"],
           "hyper_accept": r["hyper_accept_post_burnin"],
           "final_step_size": r["final_step_size"],
           "final_leapfrog": r["final_leapfrog"]}
    if block != "uturn":
        out["group_step_size"] = [float(np.clip(a.current_e, 1e-12, None))
                                  for a in made]
        out["group_leapfrog"] = [int(a.current_l) for a in made]
    if r["swap_accept_rung"] is not None:
        out["swap_accept_rung"] = r["swap_accept_rung"]
    out["cpu_seconds"] = time.perf_counter() - t0
    return out


def _in_processes(argvs) -> int:
    """Runs this script with each argument list of ``argvs``, all at once,
    and prints their standard output in order."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               *argv], stdout=subprocess.PIPE, text=True)
             for argv in argvs]
    rc = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        sys.stdout.flush()
        rc = rc or p.returncode
    return rc


def quality(args) -> int:
    """Runs ``quality_figures`` for each seed, one process a seed, all at
    once, and prints their lines in seed order."""
    opts = dict(zip(args[::2], args[1::2]))
    block = opts.get("--block", "g4")
    probe = opts.get("--probe", "always")
    if "--seed" in opts:
        print(json.dumps(quality_figures(int(opts["--seed"]), block, probe)),
              flush=True)
        return 0
    return _in_processes(["quality", "--block", block, "--probe", probe,
                          "--seed", str(s)] for s in QUALITY_SEEDS)


def surrogate_warm_start() -> dict:
    """Trains the JAX package's MAP warm start of the surrogate at the
    bench's settings (run_benchmarks.py:430-436) on the bench's 1M rows and
    writes it to ``chip_smoke.SURR_WARM_START``: its size and the MSE of
    its predictions over the rows."""
    import chip_smoke as cs
    from tensorbnn_tpu.training.pretrain import train_basic_regression

    x, y = cs.surrogate_data()
    t0 = time.perf_counter()
    w, b, _ = train_basic_regression(
        2, cs.SURROGATE_IN, 1, cs.SURROGATE_WIDTH, cycles=1,
        epochs=cs.SURROGATE_EPOCHS, alpha=0.1, train_in=x, train_out=y,
        val_in=x[:4096], val_out=y[:4096], batch_size=cs.SURROGATE_BATCH,
        callbacks=False, hidden_activation="tanh")
    flat = cs.flat_warm_start(w, b)
    path = cs.repo_file(cs.SURR_WARM_START)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, flat)
    return {"warm_start": cs.SURR_WARM_START, "numbers": int(flat.size),
            "mse": cs.host_loss(cs.surrogate_jax_warm_start(), x, y, False,
                                tanh=True),
            "cpu_seconds": time.perf_counter() - t0}


def surrogate_jax_network(x, y):
    """The bench's ``_surrogate_net`` (run_benchmarks.py:442-453) from the
    committed warm start instead of its cache: 8-64-64-1 tanh Gaussian
    dense layers, Network seed 3, the first 256 rows as validation."""
    import jax.numpy as jnp

    import chip_smoke as cs
    from tensorbnn_tpu import GaussianDenseLayer, Tanh
    from tensorbnn_tpu.network import Network
    from tensorbnn_tpu.training.pretrain import dense_warm_start

    w, b, _ = cs.surrogate_jax_warm_start()
    dims = cs.surrogate_dims()
    net = Network(jnp.float32, dims[0], x, y, x[:256], y[:256], seed=3)
    for i in range(3):
        net.add(GaussianDenseLayer(dims[i], dims[i + 1]),
                parameters=dense_warm_start(w, b, i))
        if i < 2:
            net.add(Tanh())
    return net


def fixed_rung_traces(net, epochs: int, sampling_step: int, fleet=None,
                      **train) -> list:
    """The chunk traces of ``net.train(epochs, sampling_step, ...)`` on
    the JAX package (``train``: its further keywords), every chain
    starting from the Network's state, or from ``fleet = (theta (C, D),
    eta (C, H))``."""
    import jax.numpy as jnp

    import tensorbnn_tpu.sampler.driver as j_driver

    traces = []
    saved = (j_driver.make_multichain_chunk_runner,
             j_driver.init_multichain_state)

    def recording(*args, **kwargs):
        run = saved[0](*args, **kwargs)

        def wrapped(*a, **k):
            carry, trace = run(*a, **k)
            traces.append(trace)
            return carry, trace
        return wrapped

    def init(*args, **kwargs):
        carry = saved[1](*args, **kwargs)
        if fleet is not None:
            carry = carry._replace(theta=jnp.asarray(fleet[0]),
                                   eta=jnp.asarray(fleet[1]))
        return carry

    j_driver.make_multichain_chunk_runner = recording
    j_driver.init_multichain_state = init
    try:
        net.train(epochs, sampling_step, verbose=False, **train)
    finally:
        (j_driver.make_multichain_chunk_runner,
         j_driver.init_multichain_state) = saved
    return traces


def ladder_run(state: str, eps: float, steps: int) -> dict:
    """One rung of ``chip_smoke.py``'s phase 10 (g) on the JAX package:
    ``sample_posterior`` over the surrogate's 1M rows at 4 chains,
    ``data_chunk=125,000``, ``numerics="exact"``, (eps, L) fixed
    (``chip_smoke.ladder_mcmc``), ``LADDER_EPOCHS`` epochs, from ``state``
    ("warm": every chain at the warm start; "equilibrium": the committed
    state's 4 chains); ``chip_smoke.ladder_figures`` of its per-chain
    traces."""
    import chip_smoke as cs
    from tensorbnn_tpu import GaussianLikelihood

    x, y = cs.surrogate_data()
    net = surrogate_jax_network(x, y)
    net.setup_mcmc(**cs.ladder_mcmc(eps, steps))
    t0 = time.perf_counter()
    traces = fixed_rung_traces(
        net, cs.LADDER_EPOCHS, 2, cs.surrogate_equilibrium()
        if state == "equilibrium" else None,
        likelihood=GaussianLikelihood(sd=0.1), n_chains=4,
        chain_jitter=0.0, data_chunk=cs.SURR_CHUNK, numerics="exact")
    accept = np.concatenate([np.asarray(t.main_accept) for t in traces])
    eta = np.concatenate([np.asarray(t.eta) for t in traces])
    hyper = np.concatenate([np.asarray(t.hyper_accept) for t in traces])
    return dict({"state": state, "eps": eps, "leapfrog": steps,
                 "n_chains": 4, "epochs": int(accept.shape[0])},
                **cs.ladder_figures(accept, eta),
                hyper_accept=float(hyper.mean()),
                cpu_seconds=time.perf_counter() - t0)


def ladder(args) -> int:
    """``surrogate --ladder``: ``ladder_run`` for each state (the warm
    start, and the equilibrium state once it is committed) and each (eps,
    L) of ``chip_smoke.LADDER_STEPS``, one process a run, all at once;
    ``--state S --eps E`` runs one in this process."""
    import chip_smoke as cs

    opts = dict(zip(args[::2], args[1::2]))
    if "--state" in opts:
        eps = float(opts["--eps"])
        steps = dict(cs.LADDER_STEPS)[eps]
        print(json.dumps(ladder_run(opts["--state"], eps, steps)),
              flush=True)
        return 0
    states = ["warm"] + (["equilibrium"] if os.path.exists(
        cs.repo_file(cs.SURR_EQUILIBRIUM)) else [])
    return _in_processes(["surrogate", "--ladder", "--state", st, "--eps",
                          repr(eps)] for st in states
                         for eps, _ in cs.LADDER_STEPS)


def parity(epochs: int = 3, n_chains: int = 2) -> int:
    """``surrogate --parity``: the port's ``sample_posterior`` on the CPU
    against the JAX package's over the surrogate's 1M rows from the
    equilibrium state (its first ``n_chains`` chains), at each (eps, L) of
    ``chip_smoke.LADDER_STEPS`` for ``epochs`` epochs under
    ``numerics="exact"``, the port on the JAX package's draws
    (tests/test_torch_driver_parity.py's ``run_drivers``): a line a rung
    with each block's MH decisions on both sides, whether they are equal,
    each side's log accept probabilities and the states' largest
    difference."""
    import torch

    import chip_smoke as cs
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_driver_parity import _stack, run_drivers
    from test_torch_surrogate_driver_parity import surrogate_models

    torch.set_num_threads(os.cpu_count() or 1)
    x, y = cs.surrogate_data()
    w, b, _ = cs.surrogate_jax_warm_start()
    theta, eta = cs.surrogate_equilibrium()
    for eps, steps in cs.LADDER_STEPS:
        t0 = time.perf_counter()
        r = run_drivers(n_chains, epochs=epochs, mcmc=cs.ladder_mcmc(
            eps, steps), problem=lambda: surrogate_models(x, y, w, b),
            chain_jitter=0.0, sampling_step=2,
            fleet=(theta[:n_chains], eta[:n_chains]),
            data_chunk=cs.SURR_CHUNK, numerics="exact")
        out = {"state": "equilibrium", "eps": eps, "leapfrog": steps,
               "n_chains": n_chains, "epochs": epochs,
               "main_path": r["t"].main_path}
        for block, log_u in (("main", "main_log_u"),
                             ("hyper", "hyper_log_u")):
            u = np.stack([getattr(d, log_u).numpy() for d in r["draws"]])
            acc = {k: _stack(r[k + "_calls"], block + "_accept")
                   for k in "jt"}
            with np.errstate(divide="ignore"):
                dec = {k: (u < np.log(a)).astype(int).tolist()
                       for k, a in acc.items()}
            out[block] = {"decisions_equal": dec["j"] == dec["t"],
                          "jax_decisions": dec["j"],
                          "port_decisions": dec["t"],
                          "jax_log_accept": np.log(acc["j"]).tolist(),
                          "port_log_accept": np.log(acc["t"]).tolist()}
        out["max_theta_difference"] = float(np.abs(
            _stack(r["j_calls"], "theta")
            - _stack(r["t_calls"], "theta")).max())
        out["cpu_seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


def surrogate(args) -> int:
    """``surrogate --warm-start``, ``--ladder`` or ``--parity``."""
    if args == ["--warm-start"]:
        print(json.dumps(surrogate_warm_start()), flush=True)
        return 0
    if args[:1] == ["--ladder"]:
        return ladder(args[1:])
    if args == ["--parity"]:
        return parity()
    print(f"jax_reference_stats: unknown surrogate arguments {args}",
          file=sys.stderr)
    return 2


def moons_jax_network(seed: int, parameters):
    """The moons example's Network (examples/classification.py:70-82) in
    the JAX package at Network seed ``seed``, each layer warm-started from
    ``parameters`` (``chip_smoke.moons_parameters``), with its Bernoulli
    likelihood."""
    import jax.numpy as jnp

    import chip_smoke as cs
    from tensorbnn_tpu import BernoulliLikelihood, GaussianDenseLayer, \
        Sigmoid, SquarePrelu
    from tensorbnn_tpu.network import Network

    x, y, xv, yv = cs.moons_data()
    net = Network(jnp.float32, 2, x, y, xv, yv, seed=seed)
    dims = [2, cs.MOONS_WIDTH, cs.MOONS_WIDTH, 1]
    for i in range(3):
        net.add(GaussianDenseLayer(dims[i], dims[i + 1]),
                parameters=parameters[2 * i])
        if i < 2:
            net.add(SquarePrelu(cs.MOONS_WIDTH, alpha=0.55),
                    parameters=parameters[2 * i + 1])
    net.add(Sigmoid())
    return net, BernoulliLikelihood()


def moons_warm_start() -> dict:
    """Trains the JAX package's warm start of the moons stack at the
    example's full pretraining (examples/classification.py:57-66: 2 cycles
    x 80 epochs, alpha 0.1, ``train_slopes=True``) and writes it to
    ``chip_smoke.MOONS_WARM_START``: its size and its training and
    validation accuracy."""
    import chip_smoke as cs
    from tensorbnn_tpu.training.pretrain import dense_warm_start, \
        squareprelu_warm_start, train_basic_classification

    x, y, xv, yv = cs.moons_data()
    t0 = time.perf_counter()
    w, b, a = train_basic_classification(
        2, 2, 1, cs.MOONS_WIDTH, 2, 80, alpha=0.1, train_in=x, train_out=y,
        val_in=xv, val_out=yv, train_slopes=True)
    flat = cs.flat_moons([dense_warm_start(w, b, 0),
                          squareprelu_warm_start(a, 0),
                          dense_warm_start(w, b, 1),
                          squareprelu_warm_start(a, 1),
                          dense_warm_start(w, b, 2), None])
    path = cs.repo_file(cs.MOONS_WARM_START)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, flat)
    warm = cs.moons_jax_warm_start()
    return {"warm_start": cs.MOONS_WARM_START, "numbers": int(flat.size),
            "train_accuracy": float(np.mean(
                (cs.moons_probs(warm, x) > 0.5) == (y > 0.5))),
            "val_accuracy": float(np.mean(
                (cs.moons_probs(warm, xv) > 0.5) == (yv > 0.5))),
            "cpu_seconds": time.perf_counter() - t0}


def moons_seed(seed: int) -> dict:
    """The moons example's full MCMC run (examples/classification.py:89-
    105: ``chip_smoke.MOONS_MCMC``, 4,000 epochs, one chain, every 10th
    epoch recorded into a folder of 50 networks a file, the accuracy
    metric) from the committed JAX warm start at Network seed ``seed``:
    the posterior ensemble's validation accuracy through ``Predictor``
    over the run's folder; post-burn-in main and hyper
    acceptance; the final (eps, L); ESS of the predictive probability at
    the first validation row and the worst parameter's pooled ESS (as
    ``chip_smoke.quality_figures`` takes them); the run's seconds. The
    example's progress lines go to standard error."""
    import contextlib
    import tempfile

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from tensorbnn_tpu.metrics import Accuracy
    from tensorbnn_tpu.predictor import Predictor
    from tensorbnn_tpu.sampler.potential import flatten_state
    from tensorbnn_tpu.utils.autocorr import effective_sample_size_batch

    net, lik = moons_jax_network(seed, cs.moons_jax_warm_start())
    net.setup_mcmc(**cs.MOONS_MCMC)
    _, _, xv, yv = cs.moons_data()
    epochs, burnin = cs.MOONS_EPOCHS, cs.MOONS_MCMC["burnin"]
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = net.train(epochs, cs.MOONS_STEP, lik,
                            metric_list=[Accuracy()], adjust_hypers=True,
                            folder_name=folder,
                            networks_per_file=cs.MOONS_PER_FILE,
                            display_skip=max(epochs // 10, 1))
        wall = time.perf_counter() - t0
        pred = Predictor(folder, likelihood=lik)
        probs = pred.predict(xv, n=1).mean(axis=0)[:, 0]
        networks = pred.n_networks
    params, hypers = net.init_state()
    unravel = flatten_state(params, hypers, {}).unravel_theta
    s, c, d = res.theta_samples.shape
    series = jax.jit(jax.vmap(lambda th: net.model.apply(
        unravel(th), jnp.asarray(xv[:1]))[0, 0]))(
            jnp.asarray(res.theta_samples.reshape(s * c, d)))
    total = effective_sample_size_batch(
        np.asarray(series).reshape(s, c).T)
    param_ess = res.multichain_ess(max_params=256)
    return {"seed": seed, "epochs": epochs, "n_chains": c,
            "samples": s, "networks": int(networks),
            "val_accuracy": float(np.mean((probs > 0.5) == (yv > 0.5))),
            "main_accept": float(res.main_accept[burnin:].mean()),
            "hyper_accept": float(res.hyper_accept[burnin:].mean()),
            "final_step_size": float(res.final_step_size),
            "final_leapfrog": int(res.final_leapfrog),
            "total_ess": float(total), "min_param_ess": float(param_ess),
            "median_param_ess": float(param_ess.median),
            "cpu_seconds": wall}


def moons_ladder_run(state: str, eps: float, steps: int) -> dict:
    """One rung of ``chip_smoke.py``'s moons ladder (phase 6 (e)) on the
    JAX package: ``sample_posterior`` (through ``Network.train``) over the
    moons stack at ``chip_smoke.MOONS_LADDER_CHAINS`` chains, (eps, L)
    fixed (``chip_smoke.moons_ladder_mcmc``), ``MOONS_LADDER_EPOCHS``
    epochs, from ``state`` ("warm": every chain at the committed warm
    start; "equilibrium": the committed state's 4 rows, each 4 times);
    ``chip_smoke.ladder_figures`` of its per-chain traces and the mean
    hyper acceptance."""
    import chip_smoke as cs

    net, lik = moons_jax_network(42, cs.moons_jax_warm_start())
    net.setup_mcmc(**cs.moons_ladder_mcmc(eps, steps))
    c = cs.MOONS_LADDER_CHAINS
    fleet = None
    if state == "equilibrium":
        fleet = tuple(np.tile(a, (c // a.shape[0], 1))
                      for a in cs.moons_equilibrium())
    t0 = time.perf_counter()
    traces = fixed_rung_traces(net, cs.MOONS_LADDER_EPOCHS, 1, fleet,
                               likelihood=lik, n_chains=c,
                               chain_jitter=0.0)
    accept = np.concatenate([np.asarray(t.main_accept) for t in traces])
    hyper = np.concatenate([np.asarray(t.hyper_accept) for t in traces])
    return dict({"state": state, "eps": eps, "leapfrog": steps,
                 "n_chains": c, "epochs": int(accept.shape[0])},
                **cs.ladder_figures(accept),
                hyper_accept=float(hyper.mean()),
                cpu_seconds=time.perf_counter() - t0)


def classification(args) -> int:
    """``classification --warm-start``; ``--ladder`` (every state and its
    rungs, one process each, all at once; ``--state S --eps E --leapfrog
    L`` runs one here); ``--seeds a,b,...`` (one process a seed, all at once;
    default ``chip_smoke.MOONS_SEEDS``) or ``--seed N`` (one here)."""
    import chip_smoke as cs

    if args == ["--warm-start"]:
        print(json.dumps(moons_warm_start()), flush=True)
        return 0
    if args[:1] == ["--ladder"]:
        opts = dict(zip(args[1::2], args[2::2]))
        if "--state" in opts:
            print(json.dumps(moons_ladder_run(
                opts["--state"], float(opts["--eps"]),
                int(opts["--leapfrog"]))), flush=True)
            return 0
        states = ["warm"] + (["equilibrium"] if os.path.exists(
            cs.repo_file(cs.MOONS_EQUILIBRIUM)) else [])
        return _in_processes(
            ["classification", "--ladder", "--state", st, "--eps",
             repr(eps), "--leapfrog", str(steps)]
            for st in states for eps, steps in cs.MOONS_LADDER_STEPS[st])
    opts = dict(zip(args[::2], args[1::2]))
    if set(opts) - {"--seed", "--seeds"} or len(args) % 2:
        print(f"jax_reference_stats: unknown classification arguments "
              f"{args}", file=sys.stderr)
        return 2
    if "--seed" in opts:
        print(json.dumps(moons_seed(int(opts["--seed"]))), flush=True)
        return 0
    seeds = opts.get("--seeds", ",".join(map(str, cs.MOONS_SEEDS)))
    return _in_processes(["classification", "--seed", s]
                         for s in seeds.split(","))


def main() -> int:
    if sys.argv[1:] == ["examples"]:
        return examples()
    if sys.argv[1:2] == ["surrogate"]:
        return surrogate(sys.argv[2:])
    if sys.argv[1:2] == ["quality"]:
        return quality(sys.argv[2:])
    if sys.argv[1:2] == ["classification"]:
        return classification(sys.argv[2:])
    from benchmarks import run_benchmarks as rb
    from tensorbnn_tpu import BernoulliLikelihood, CategoricalLikelihood, \
        GaussianDenseLayer, Sigmoid, Softmax, SquarePrelu, Tanh
    from tensorbnn_tpu.models.sequential import Sequential
    from tensorbnn_tpu.parallel import chains

    traces = []
    make_runner = chains.make_multichain_chunk_runner

    def recording_runner(*args, **kwargs):
        run = make_runner(*args, **kwargs)

        def wrapped(*a, **k):
            carry, trace = run(*a, **k)
            traces.append(trace)
            return carry, trace
        return wrapped

    chains.make_multichain_chunk_runner = recording_runner

    # benchmarks/run_benchmarks.py:251-264 and :305-313
    rng = np.random.default_rng(2)
    x_c = rng.normal(size=(64, 10)).astype(np.float32)
    y_c = (x_c.sum(axis=1) > 0).astype(np.float32)
    rng = np.random.default_rng(3)
    x_m = rng.normal(size=(16, 2)).astype(np.float32)
    y_m = rng.integers(0, 3, size=16).astype(np.float32)
    cells = {
        "classification": (
            Sequential([GaussianDenseLayer(10, 16), SquarePrelu(16),
                        GaussianDenseLayer(16, 16), SquarePrelu(16),
                        GaussianDenseLayer(16, 1), Sigmoid()]),
            BernoulliLikelihood(), x_c, y_c,
            dict(leapfrog=50, hyper_leapfrog=10, step_size=5e-4)),
        "multiclass": (
            Sequential([GaussianDenseLayer(2, 8), Tanh(),
                        GaussianDenseLayer(8, 3), Softmax()]),
            CategoricalLikelihood(), x_m, y_m,
            dict(leapfrog=20, hyper_leapfrog=5, step_size=1e-2)),
    }
    for name, (model, lik, x, y, kw) in cells.items():
        traces.clear()
        t0 = time.perf_counter()
        _, _, acc, n_params = rb._bench_sampler(
            model, x, y, n_chains=128, chunk=10, n_chunks=5,
            likelihood=lik, use_fused=False, **kw)
        last = traces[-1]
        print(json.dumps({
            "cell": name, "n_params": int(n_params), "epochs": 60,
            "window": "epochs 51-60 (the last chunk)",
            "main_accept": acc,
            "hyper_accept": float(np.asarray(last.hyper_accept).mean()),
            "cpu_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
