"""The benchmark's own tests: ``python3 -m pytest portbench/tests``.

The CPU tests drive the harness on a tiny copy of the benchmark
(``tiny_root``: the cells' traffic and configurations cut to a few chains,
epochs and rows) with the program on the CPU. Tests marked ``cuda`` need
an NVIDIA card and skip without one.
"""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def _edit(path, fn):
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make_tiny_root(dest: str) -> str:
    """A checkout-like directory: ``BENCHMARK.json``, a copy of the
    benchmark's folder with its traffic and configurations cut to CPU
    sizes, and the program linked in."""
    os.makedirs(dest, exist_ok=True)
    shutil.copytree(BENCH, os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    os.symlink(os.path.join(ROOT, "tensorbnn_tpu_torch"),
               os.path.join(dest, "tensorbnn_tpu_torch"))
    traffic = os.path.join(dest, "portbench", "traffic")
    configs = os.path.join(dest, "portbench", "configs")

    def g4(d):
        d["job"].update(epochs=24, burnin=12, n_chains=8, n_adapters=2)
        d["mcmc"].update(leapfrog_start=10, leapfrog_min=5, leapfrog_max=20,
                         step_size_min=5e-4, step_size_max=3e-3,
                         step_size_options=10, hyper_leapfrog=8,
                         averaging_steps=5, random_steps=1)
        d["warmup"].update(epochs=6, burnin=2)
        d["check"].update(jobs=1, runs=1, steps=3)
        d["jobs_per_s"] = 2.0

    def tutorial(d):
        d["job"].update(n_chains=4)
        d["epochs_per_s"] = 24.0
        d["mcmc"].update(step_size_start=1e-3, step_size_min=1e-3,
                         step_size_max=1e-3, leapfrog_start=12,
                         leapfrog_min=12, leapfrog_max=12, hyper_leapfrog=5)
        d["warmup"].update(epochs=3, burnin=1)
        d["trace"]["chunks"] = [1, 2]

    def surrogate(d):
        d["job"].update(data_chunk=2500, n_chains=4)
        d["epochs_per_s"] = 8.0
        d["warmup"].update(epochs=3, burnin=1)
        d["trace"]["chunks"] = [0, 1]

    def predict(d):
        d.update(networks=40, points=64, calls_per_s=50)
        d["warmup"]["calls"] = 2
        d["trace"]["calls"] = 3

    for name, fn in (("flagship.g4_jobs", g4),
                     ("tutorial.k3_sampling", tutorial),
                     ("surrogate.data4", surrogate),
                     ("flagship.predict", predict)):
        _edit(os.path.join(traffic, name + ".json"), fn)

    def rows(n, block):
        def fn(d):
            d["data"]["rows"] = d["rows"] = n
            d["reference_rows"] = block
        return fn

    _edit(os.path.join(configs, "tutorial.json"), rows(200, 200))
    _edit(os.path.join(configs, "surrogate.json"), rows(20000, 5000))
    _edit(os.path.join(dest, "BENCHMARK.json"), add_surrogate)
    return dest


def add_surrogate(bench):
    """The four-card surrogate cell, whose files the benchmark keeps and
    which ``BENCHMARK.json`` does not name yet, added by entries alone."""
    bench["configs"].append({
        "name": "surrogate", "source": "https://arxiv.org/abs/2009.14393",
        "file": "portbench/configs/surrogate.json", "reduced": [],
        "why": "a 1M-point surrogate over a data mesh"})
    bench["workloads"].append({
        "name": "surrogate.data4", "config": "surrogate",
        "traffic": "data4", "chips": 4,
        "why": "one job over a (1, 4) data mesh"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flagship.g4_jobs" in m.get("workloads", []):
            m["workloads"].append("surrogate.data4")
    bench["per_layer"].append({
        "name": "peer_sum_ms", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "mesh",
        "moves": "leapfrog_steps_per_s", "workloads": ["surrogate.data4"]})


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny") / "root"))


@pytest.fixture
def card():
    """The first CUDA card; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch sees no CUDA device here")
    return torch.device("cuda", 0)
