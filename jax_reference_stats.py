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
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "quality", "--block",
         block, "--probe", probe, "--seed", str(s)],
        stdout=subprocess.PIPE, text=True) for s in QUALITY_SEEDS]
    rc = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        sys.stdout.flush()
        rc = rc or p.returncode
    return rc


def main() -> int:
    if sys.argv[1:] == ["examples"]:
        return examples()
    if sys.argv[1:2] == ["quality"]:
        return quality(sys.argv[2:])
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
