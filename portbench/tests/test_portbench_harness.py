"""CPU tests of the benchmark's harness, its yardstick and its check."""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import check
import run as bench_run
import spec
import yardstick
from conftest import BENCH, ROOT, _edit
from reference.mlp import Stack


def run_cell(root, cell, seconds=1.0, trace=0, control=False, chips=None):
    """The cell run in this process on the CPU (the chip's look skipped):
    the result object."""
    r = bench_run.Run(cell, 2 ** 31 + 7, seconds, trace, root=root)
    n = int(r.cell["chips"]) if chips is None else chips
    r.devices = [torch.device("cpu")] * n
    return bench_run.execute(r, control=control), r


# -- discovery -------------------------------------------------------------
def test_new_files_found_by_name(tiny_root, tmp_path):
    """A configuration, a cell and a metric added as files and entries,
    with no file of the harness edited."""
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root, symlinks=True)
    here = os.path.join(root, "portbench")
    shutil.copy(os.path.join(here, "configs", "flagship.json"),
                os.path.join(here, "configs", "flagship_b.json"))
    shutil.copy(os.path.join(here, "traffic", "flagship.g4_jobs.json"),
                os.path.join(here, "traffic", "flagship_b.jobs.json"))
    with open(os.path.join(here, "metrics", "jobs_done.py"), "w") as f:
        f.write("def read(record):\n    return len(record['jobs'])\n")

    def add(bench):
        bench["configs"].append(dict(bench["configs"][0], name="flagship_b",
                                     file="portbench/configs/flagship_b.json"))
        bench["workloads"].append({"name": "flagship_b.jobs",
                                   "config": "flagship_b", "traffic": "jobs",
                                   "chips": 1, "why": "a test cell"})
        bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs",
                                    "better": "higher", "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": ["flagship_b.jobs"]})
        for m in bench["end_to_end"]:
            if m["name"] == "leapfrog_steps_per_s":
                m["workloads"].append("flagship_b.jobs")

    _edit(os.path.join(root, "BENCHMARK.json"), add)
    out, _ = run_cell(root, "flagship_b.jobs")
    assert out["metrics"]["jobs_done"] == {"value": 2.0, "unit": "jobs"}
    assert set(out["metrics"]) == {"jobs_done", "leapfrog_steps_per_s",
                                   "setup_s"}
    assert out["correct"] is True, out["compared"]


def test_result_line_shape(tiny_root):
    out, _ = run_cell(tiny_root, "flagship.predict", trace=1)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "compared"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s",
                                   "window_s"}
    assert line["device"]["window_s"] > 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["compared"]["predict_gap"]) == {"value", "limit"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["attempted"] > 0 and line["failed"] == 0


def test_benchmark_file_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["name"] + ".json"))
    for c in bench["configs"]:
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        stack = Stack(cfg)
        assert (stack.D, stack.H) == (cfg["theta_dim"], cfg["hyper_dim"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", names)) <= set(names)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(names) // 4)


# -- the yardstick -----------------------------------------------------------
def test_flop_and_byte_counts_by_hand():
    tut = spec.load_json(os.path.join(BENCH, "configs", "tutorial.json"))
    n = 9585
    # forward: 784x20, 20x20, 20x1 products and bias adds; gradient: the
    # forward again for the weight gradients, and the input gradients of
    # the second and third layers
    fwd = 2 * n * (784 * 20 + 20 * 20 + 20 * 1) + n * (20 + 20 + 1)
    assert yardstick.product_flops(tut["layers"], n) == 2 * fwd + 2 * n * (
        20 * 20 + 20 * 1)
    assert yardstick.product_flops(tut["layers"], n) == 626_111_370
    c, d = 64, 16181
    secs, what = yardstick.k3_shape_bound(tut["layers"], c, d, n, 784)
    assert what == "operations"
    assert math.isclose(secs, c * 626_111_370 / 67e12)
    sur = spec.load_json(os.path.join(BENCH, "configs", "surrogate.json"))
    n = 1_000_000
    fwd = 2 * n * (8 * 64 + 64 * 64 + 64) + n * (64 + 64 + 1)
    assert yardstick.product_flops(sur["layers"], n) == 2 * fwd + 2 * n * (
        64 * 64 + 64)
    assert yardstick.product_flops(sur["layers"], n) == 27_266_000_000
    # the predict cell's forward bound: 2,000 networks x 4,096 points
    flag = spec.load_json(os.path.join(BENCH, "configs", "flagship.json"))
    secs, what = yardstick.forward_bound(flag["layers"], 2000, 251, 4096, 1, 1)
    assert what == "operations"
    assert math.isclose(secs * 1e3, 2000 * 4096 * (2 * 220 + 31) / 67e9)
    assert 0.0575 < secs * 1e3 < 0.0576
    # the bytes of a K1 launch: q, v, mom and theta, eta, the data, and
    # eps, L, lp0, lp1 a chain
    secs, what = yardstick.k1_shape_bound(flag["layers"], 512, 251, 16, 11,
                                          1, 512 * 51)
    assert what == "operations"
    assert yardstick.busy_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3.0


def test_ess_matches_the_program_copy():
    from tensorbnn_tpu_torch.utils.autocorr import \
        effective_sample_size_batch
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=(6, 400)), axis=1) * 0.1 + rng.normal(
        size=(6, 400))
    assert yardstick.effective_sample_size_batch(x) == \
        effective_sample_size_batch(x)


# -- the reference against the port -------------------------------------------
@pytest.mark.parametrize("name", ["flagship", "tutorial", "surrogate"])
def test_reference_potentials_match_the_port(name):
    """The reference's main and hyper potentials and gradients against the
    program's plain path, in float64, at each configuration's stack over a
    few rows."""
    import inputs
    import system
    from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
        make_potentials
    cfg = spec.load_json(os.path.join(BENCH, "configs", name + ".json"))
    stack = Stack(cfg)
    g = torch.Generator().manual_seed(3)
    c = 3
    theta = 0.3 * torch.randn((c, stack.D), generator=g, dtype=torch.float64)
    eta = inputs.start_hypers(cfg, stack).double()[None].repeat(c, 1)
    eta = eta + 0.05 * torch.randn(eta.shape, generator=g,
                                   dtype=torch.float64)
    x = torch.rand((17, cfg["input_dim"]), generator=g, dtype=torch.float64)
    y = (torch.rand(17, generator=g) > 0.5).double()
    model, lik = system.build_model(cfg)
    params, hypers = system.structured(stack, theta[0], eta[0])
    flat = flatten_state(params, hypers, lik.init_hypers(torch.float64))
    pots = make_potentials(model, lik, x, y, flat.unravel_theta,
                           flat.unravel_eta)
    want_v, want_g = pots.main_vg(theta, eta)
    got_v, got_g = stack.main_value_grad(theta, eta, x, y, rows=5)
    torch.testing.assert_close(got_v, want_v, rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(got_g, want_g, rtol=1e-10, atol=1e-9)
    want_v, want_g = pots.hyper_vg(eta, theta)
    rss, n = stack.residual_power(theta, x, y, rows=5)
    got_v, got_g = stack.hyper_value_grad(eta, stack.hyper_stats(theta),
                                          rss, n)
    torch.testing.assert_close(got_v, want_v, rtol=1e-10, atol=1e-9)
    torch.testing.assert_close(got_g, want_g, rtol=1e-10, atol=1e-9)


# -- the check's numbers: sound runs, the control, the faults ------------------
SAMPLING = ["flagship.g4_jobs", "tutorial.k3_sampling", "surrogate.data4"]


@pytest.mark.parametrize("cell", SAMPLING + ["flagship.predict"])
def test_sound_run_is_correct_and_the_control_is_not(tiny_root, cell):
    out, r = run_cell(tiny_root, cell, control=True)
    assert out["correct"] is True, out["compared"]
    limits = r.traffic["check"]["limits"]
    ok, rows = bench_run.compared(out["control"], limits)
    assert not ok, rows


def _state_unchanged(monkeypatch):
    """Every HMC step returns its start, whatever the Metropolis test says
    (the fused blocks' test and the plain path's end alike)."""
    from tensorbnn_tpu_torch.sampler import gibbs, hmc

    def unchanged(tr, leap):
        zero = torch.zeros_like(tr.lp0)
        return hmc.HMCResult(tr.positions, tr.lp0, zero,
                             torch.zeros_like(tr.lp0, dtype=torch.bool))

    def never(lp0, lp1, kinetic0, kinetic1, log_u):
        prob, accepted = hmc.metropolis(lp0, lp1, kinetic0, kinetic1, log_u)
        return prob, torch.zeros_like(accepted)

    monkeypatch.setattr(gibbs, "transition_end", unchanged)
    monkeypatch.setattr(gibbs, "metropolis", never)
    monkeypatch.setattr(hmc, "transition_end", unchanged)


def _half_batch(monkeypatch):
    """The driver is fed the first half of the rows twice in place of the
    rows: the likelihood is the mean over that half, times the rows."""
    import system
    real = system.sample_posterior

    def half(model, likelihood, x, y, *args, **kw):
        idx = torch.arange(x.shape[0], device=x.device) % (
            (x.shape[0] + 1) // 2)
        return real(model, likelihood, x[idx], y[idx], *args, **kw)

    monkeypatch.setattr(system, "sample_posterior", half)


def _exchange_left_out(monkeypatch):
    """Each data peer's sum keeps the home peer's part alone."""
    from tensorbnn_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "data_sum",
                        lambda parts, device: mesh.to_device(parts[0], device))


def _answer_altered(monkeypatch):
    """One recorded sample's weight moved by 0.5, about the weights' own
    scale, where the driver hands it out (the flagship's check resolves
    an endpoint to 0.2 of its move on calm rows)."""
    import system
    real = system.sample_posterior

    def altered(*args, **kw):
        res = real(*args, **kw)
        res.theta_samples[-1, 0, 0] += 0.5
        return res

    monkeypatch.setattr(system, "sample_posterior", altered)


def _trajectory_one_short(monkeypatch):
    """Every main trajectory runs one leapfrog step fewer than the L the
    driver chose and reports."""
    from tensorbnn_tpu_torch.sampler import driver
    real = driver.make_multichain_chunk_runner

    def short(*args, **kw):
        inner = real(*args, **kw)

        def run(carry, eps, leap, *rest, **kw2):
            return inner(carry, eps, np.asarray(leap) - 1 if np.ndim(leap)
                         else int(leap) - 1, *rest, **kw2)

        run.runner = inner.runner
        return run

    monkeypatch.setattr(driver, "make_multichain_chunk_runner", short)


def _hyper_step_scaled(monkeypatch):
    """The hyper block integrates with 0.9 times the step size the chains
    hold (and the driver reports)."""
    from tensorbnn_tpu_torch.sampler import driver, gibbs
    plain = gibbs.hmc_step_batched
    runner = driver.make_multichain_chunk_runner

    def scaled(gen, eta, vg, step, *args, **kw):
        return plain(gen, eta, vg, 0.9 * step, *args, **kw)

    def fused_scaled(*args, **kw):
        traj = kw.get("batched_hyper_traj")
        if traj is not None:
            kw["batched_hyper_traj"] = \
                lambda eta, stats, mom, step: traj(eta, stats, mom, 0.9 * step)
        return runner(*args, **kw)

    monkeypatch.setattr(gibbs, "hmc_step_batched", scaled)
    monkeypatch.setattr(driver, "make_multichain_chunk_runner", fused_scaled)


def _prediction_altered(monkeypatch):
    """One output of every ``predict`` call moved."""
    import importlib
    predictor = importlib.import_module("tensorbnn_tpu_torch.predictor")
    real = predictor.Predictor.predict

    def altered(self, *args, **kw):
        out = real(self, *args, **kw)
        out[0, 0, 0] += 1e-2
        return out

    monkeypatch.setattr(predictor.Predictor, "predict", altered)


@pytest.mark.parametrize("cell,fault", [
    ("flagship.g4_jobs", _state_unchanged),
    ("tutorial.k3_sampling", _state_unchanged),
    ("flagship.g4_jobs", _half_batch),
    ("tutorial.k3_sampling", _half_batch),
    ("surrogate.data4", _exchange_left_out),
    ("flagship.g4_jobs", _answer_altered),
    ("flagship.g4_jobs", _trajectory_one_short),
    ("tutorial.k3_sampling", _trajectory_one_short),
    ("flagship.g4_jobs", _hyper_step_scaled),
    ("tutorial.k3_sampling", _hyper_step_scaled),
    ("surrogate.data4", _answer_altered),
    ("flagship.predict", _prediction_altered),
], ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    out, _ = run_cell(tiny_root, cell)
    assert out["correct"] is False, out["compared"]


# -- what the harness loads, and where it runs ---------------------------------
def test_no_jax_in_the_harness(tiny_root):
    """Every module the harness imports, a run of each loop included: no
    top-level name ``jax``, ``jaxlib``, ``flax`` or ``tensorbnn_tpu``."""
    code = f"""
import sys, torch
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import run as R
for cell in ("flagship.predict", "tutorial.k3_sampling"):
    r = R.Run(cell, 11, 1.0, 1, root={tiny_root!r})
    r.devices = [torch.device("cpu")]
    R.execute(r)
print(sorted({{m.split(".")[0] for m in sys.modules}} & set(R.FORBIDDEN)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result():
    """``run.py`` on a machine without the cards fails and prints no
    result: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "flagship.predict", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only ``BENCHMARK.json`` and the benchmark's
    folder, a run fails before any result."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "flagship.predict", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship.g4_jobs", "tutorial.k3_sampling",
                                  "flagship.predict"])
def test_cell_on_the_card(card, cell):
    """A short run of each one-card cell at its own sizes is correct."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
