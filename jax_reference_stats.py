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
"""

import json
import sys
import time

import numpy as np


def main() -> int:
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
