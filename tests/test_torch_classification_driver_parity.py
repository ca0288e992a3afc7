"""The port's ``sample_posterior`` against the JAX package's over whole runs
of the classification family, on the JAX package's own draws.

tests/test_torch_classification.py holds the classification family's
layers, likelihoods, kernels and three injected-draw epochs at a fixed
(eps, L); tests/test_torch_driver_parity.py holds the driver over whole
runs of the regression family. Here the driver meets the Bernoulli and
categorical likelihoods: the GP-UCB adapter's random phase and updates on
their acceptance, dual averaging of the hyper step, the chunk plan, two
adapter groups, burn-in and thinning. Both drivers start from the JAX
package's initial fleet of 8 chains in 2 groups; the port takes the JAX
package's per-chain draws through the patched ``draw_epoch``
(``run_drivers``). The settings are the moons example's ``--smoke`` MCMC
settings (examples/classification.py:81-87) cut to 28 epochs, with its
step grid raised to where the narrow stacks reject. Four cases:

- ``moons``: the moons stack narrowed to 2-6-6-1 (SquarePrelu at alpha
  0.55, then a sigmoid, Bernoulli) over 32 rows of ``two_moons``, dense
  layers and slopes warm-started by the JAX package's
  ``train_basic_classification(..., train_slopes=True)``. The port runs
  K1 (d)'s twin and the plain hyper block (no stats layout for a slope
  layer), the JAX package its XLA path;
- ``moons_plain``: the same run with ``use_fused=False`` on both sides,
  the JAX package's own route for the bench's ``classification`` cell;
- ``multiclass``: the bench's 2-8-3 stack, tanh then Softmax, categorical
  over class ids (benchmarks/run_benchmarks.py:295-340), on K1 (d)'s and
  K2's twins;
- ``tutorial_k3``: the tutorial's SquarePrelu + Bernoulli stack narrowed
  to 16-8-8-1 over 64 rows, on K3's twin (the port's K1 constructor,
  ``try_build_fused_trajectory``, patched to decline, as it declines the
  tutorial's 784 inputs) and the plain hyper block.

Held equal: every chunk's length and each chain's (eps, L), so each
group's GP-UCB choice (the run holds the random phase and at least two
GP-UCB updates a group); every main and hyper MH decision from each
side's accept probability against the shared coin; each group's final
(eps, L); each adapter's ``state_dict()`` at the end (its SJD window to
rtol 1e-4: each side's mean of its own float32 squared jumps). The
acceptance slices after burn-in agree to atol 1e-3 and the recorded
samples, slopes included, to rtol 1e-3 / atol 1e-4.

The runs stop at epoch 28, where each group has made four GP-UCB
updates. Run on (``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3
tests/test_torch_classification_driver_parity.py 300`` prints it, under
the test suite's XLA flags), no decision differs in 100 epochs in any
case. To 300 epochs, the first main decision to differ is at epoch 177 in
``moons`` and ``moons_plain`` (chain 0, (eps, L) = (0.03, 5)), whose states
left the samples' tolerance at epoch 174, and at epoch 279 in
``tutorial_k3`` (chain 4, (0.02, 8); states apart from epoch 90); none
differs in ``multiclass``, whose states stay within the tolerance. At
each, the port's plain leapfrog gives the same log-accept ratio in float32
and in float64 from each package's start (moons: 0.0414 from the JAX
start, -0.1280 from the port's, against a coin of -0.0837; tutorial:
-0.1529 and -0.3893 against -0.1538): float32 order amplified over a
long run, not a driver fault.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
import tensorbnn_tpu_torch.ops.fused_mlp as t_fused
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.training.pretrain import dense_warm_start, \
    squareprelu_warm_start, train_basic_classification
from tensorbnn_tpu_torch.examples.classification import two_moons
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from test_torch_driver_parity import _stack, check_mh_decisions, \
    check_slices_and_samples, first_flip, run_drivers

torch.set_num_threads(1)

EPOCHS, BURNIN, STEP, N_CHAINS, N_GROUPS = 28, 20, 2, 8, 2
# the moons example's --smoke MCMC settings (examples/classification.py:
# 81-87) cut to 28 epochs: adapter cycles of 5 epochs, a random phase (its
# last draw at epoch 8), GP-UCB updates at 13, 18, 23 and 28, a burn-in of
# 20. Its leapfrog counts are cut to 3-8 and its hyper steps to 10, and
# its step grid raised to where each stack rejects (STEPS): at the
# smoke's 10-200 steps and 30 hyper steps the two leapfrogs over these
# posteriors amplify the packages' float32 orders past the samples'
# tolerance within the first GP-UCB chunks (at L 40 and eps 0.012 the moons
# states are 5.5e-3 apart by epoch 13; the narrowed tutorial's hyper
# states leave the tolerance at epoch 11 at 30 hyper steps)
MCMC = dict(step_size_options=40, leapfrog_start=5, leapfrog_min=3,
            leapfrog_max=8, leapfrog_increment=1, hyper_step_size=0.001,
            hyper_leapfrog=10, burnin=BURNIN, averaging_steps=5,
            random_steps=2)
# each case's step grid (start, min, max)
STEPS = {"moons": (1e-2, 2e-3, 3e-2), "moons_plain": (1e-2, 2e-3, 3e-2),
         "multiclass": (2e-2, 5e-3, 6e-2),
         "tutorial_k3": (5e-3, 1e-3, 2e-2)}
# (the port's main path, whether its hyper block is K2) of each case
ROUTES = {"moons": ("K1", False), "moons_plain": ("plain", False),
          "multiclass": ("K1", True), "tutorial_k3": ("K3", False)}
CASES = tuple(ROUTES)
# the adapter's float state: each side's SJD is the mean of its own
# float32 squared jumps
ADAPTER_RTOL = 1e-4


def _models(specs):
    """The same stack in both packages: ``specs`` are (class name, args,
    kwargs) triples."""
    return tuple(seq([getattr(m, name)(*args, **kw)
                      for name, args, kw in specs])
                 for m, seq in ((J, JSequential), (T, TSequential)))


def _warm(params, starts):
    """The JAX package's ``params`` with each layer's entries replaced by
    ``starts`` (a dict a layer, or None)."""
    return tuple({**p, **{k: jnp.asarray(v, jnp.float32)
                          for k, v in s.items()}} if s else p
                 for p, s in zip(params, starts))


def moons_problem(width: int = 6, rows: int = 32):
    """The moons stack at ``width`` over ``rows`` rows of ``two_moons``
    (seed 0; validation two_moons(rows, seed=1)), warm-started by the JAX
    package's ``train_basic_classification`` (one cycle of 20 epochs,
    alpha 0.1, trained slopes) as the example does: both packages' model
    and likelihood, the data and the JAX package's initial ``(params,
    hypers)``."""
    sq = ("SquarePrelu", (width,), {"alpha": 0.55})
    j_model, t_model = _models([
        ("GaussianDenseLayer", (2, width), {}), sq,
        ("GaussianDenseLayer", (width, width), {}), sq,
        ("GaussianDenseLayer", (width, 1), {}), ("Sigmoid", (), {})])
    x, y = two_moons(rows, seed=0)
    xv, yv = two_moons(rows, seed=1)
    w, b, a = train_basic_classification(
        2, 2, 1, width, 1, 20, alpha=0.1, train_in=x, train_out=y,
        val_in=xv, val_out=yv, train_slopes=True)
    params, hypers = j_model.init(jax.random.key(0))
    params = _warm(params, [dense_warm_start(w, b, 0),
                            squareprelu_warm_start(a, 0),
                            dense_warm_start(w, b, 1),
                            squareprelu_warm_start(a, 1),
                            dense_warm_start(w, b, 2), None])
    return (j_model, J.BernoulliLikelihood(), t_model,
            T.BernoulliLikelihood(), x, y, params, hypers)


def multiclass_problem():
    """The bench's ``multiclass`` cell (run_benchmarks.py:295-340): 2-8-3,
    tanh, Softmax, categorical over 16 rows of N(0, 1) data
    (``default_rng(3)``) with class ids 0..2, from the JAX package's
    init (key 0)."""
    j_model, t_model = _models([("GaussianDenseLayer", (2, 8), {}),
                                ("Tanh", (), {}),
                                ("GaussianDenseLayer", (8, 3), {}),
                                ("Softmax", (), {})])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 2)).astype(np.float32)
    y = rng.integers(0, 3, size=16).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    return (j_model, J.CategoricalLikelihood(), t_model,
            T.CategoricalLikelihood(), x, y, params, hypers)


def tutorial_problem(d_in: int = 16, width: int = 8, rows: int = 64):
    """The tutorial's stack (chip_smoke.tutorial_network: SquarePrelu at
    alpha sqrt(0.1), then at its default, a sigmoid, Bernoulli) narrowed
    to ``d_in``-``width``-``width``-1 over ``rows`` uniform [0, 1) rows
    (``default_rng(5)``) labelled by a random plane through their mean,
    from the JAX package's init (key 0)."""
    j_model, t_model = _models([
        ("GaussianDenseLayer", (d_in, width), {}),
        ("SquarePrelu", (width,), {"alpha": math.sqrt(0.1)}),
        ("GaussianDenseLayer", (width, width), {}),
        ("SquarePrelu", (width,), {}),
        ("GaussianDenseLayer", (width, 1), {}), ("Sigmoid", (), {})])
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(rows, d_in)).astype(np.float32)
    y = ((x - 0.5) @ rng.normal(size=d_in) > 0).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    return (j_model, J.BernoulliLikelihood(), t_model,
            T.BernoulliLikelihood(), x, y, params, hypers)


_PROBLEMS = {}


def problem(case: str):
    """The case's problem, built once a process (the moons warm start is
    trained once for both moons cases)."""
    name = {"moons_plain": "moons"}.get(case, case)
    if name not in _PROBLEMS:
        _PROBLEMS[name] = {"moons": moons_problem,
                           "multiclass": multiclass_problem,
                           "tutorial_k3": tutorial_problem}[name]()
    return _PROBLEMS[name]


def run_case(case: str, epochs: int = EPOCHS) -> dict:
    """Both drivers over ``epochs`` epochs of ``case`` (8 chains in 2
    adapter groups, chain jitter 0.05), the port on the JAX package's
    draws; for ``tutorial_k3`` the port's ``try_build_fused_trajectory``
    declines."""
    start, lo, hi = STEPS[case]
    mcmc = dict(MCMC, step_size_start=start, step_size_min=lo,
                step_size_max=hi)
    extra = {"use_fused": False} if case == "moons_plain" else {}
    mp = pytest.MonkeyPatch()
    try:
        if case == "tutorial_k3":
            mp.setattr(t_fused, "try_build_fused_trajectory",
                       lambda *a, **k: None)
        r = run_drivers(N_CHAINS, N_GROUPS, epochs=epochs, mcmc=mcmc,
                        problem=lambda: problem(case), **extra)
    finally:
        mp.undo()
    return dict(r, case=case)


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    return run_case(request.param)


def test_port_ran_its_main_path(runs):
    """The port's route: K1 (d) and the plain hyper block for the moons
    stack, the plain path under ``use_fused=False``, K1 (d) and K2 for
    ``multiclass``, K3 for the narrowed tutorial; every epoch run."""
    t_res = runs["t"]
    assert (t_res.main_path, t_res.fused_hyper) == ROUTES[runs["case"]]
    assert t_res.n_epochs == runs["j"].n_epochs == EPOCHS
    assert len(t_res.group_step_size) == N_GROUPS


def test_each_group_chooses_the_same_step_and_leapfrog(runs):
    """Every chunk has the same length on both sides and every chain the
    same (eps, L), so every group's choice is the same; each group's
    final (eps, L) is the JAX group's; the run holds the random phase and
    at least two GP-UCB updates a group."""
    j_calls, t_calls = runs["j_calls"], runs["t_calls"]
    assert [c["n"] for c in t_calls] == [c["n"] for c in j_calls]
    for jc, tc in zip(j_calls, t_calls):
        np.testing.assert_array_equal(tc["eps"], jc["eps"])
        np.testing.assert_array_equal(tc["leap"], jc["leap"])
    assert list(zip(runs["t"].group_step_size,
                    runs["t"].group_leapfrog)) == runs["j_groups"]
    assert runs["t"].final_step_size == runs["j"].final_step_size
    assert runs["t"].final_leapfrog == runs["j"].final_leapfrog
    for j_a, t_a in zip(runs["j_adapters"], runs["t_adapters"]):
        assert t_a.log == j_a.log
        phases = [u["phase"] for u in j_a.log]
        assert phases[0] == "random", phases
        assert phases.count("gp") >= 2, phases


def test_the_adapters_end_in_the_same_state(runs):
    """Each group's adapter: the same trail after every call (counter,
    strikes, step-size bounds, resets, points in its GP window, answer)
    and at the end the same ``state_dict()``, every discrete entry and
    the generator equal, the SJD window and what derives from it to
    ``ADAPTER_RTOL``."""
    assert len(runs["j_adapters"]) == len(runs["t_adapters"]) == N_GROUPS
    for j_a, t_a in zip(runs["j_adapters"], runs["t_adapters"]):
        assert t_a.trail == j_a.trail
        j_sd, t_sd = j_a.state_dict(), t_a.state_dict()
        assert sorted(t_sd) == sorted(j_sd)
        for key in sorted(j_sd):
            if key in ("all_data", "all_sd", "current_data", "max_r"):
                np.testing.assert_allclose(t_sd[key], j_sd[key],
                                           rtol=ADAPTER_RTOL, err_msg=key)
            else:
                assert t_sd[key] == j_sd[key], key


def test_every_mh_decision_is_the_same(runs):
    check_mh_decisions(runs)


def test_acceptance_slices_and_samples_match(runs):
    """The acceptance slices after burn-in, the recorded samples (the
    slopes among them) and the final hyper step at
    tests/test_torch_driver_parity.py's tolerances."""
    check_slices_and_samples(runs)


def first_differences(r: dict) -> None:
    """``first_flip`` of the run ``r`` (from ``run_case``, run past the
    cut), then the first epoch whose hyper decision differs and the first
    whose states differ past the samples' tolerance."""
    first_flip(r)
    u = np.stack([d.hyper_log_u.numpy() for d in r["draws"]])
    with np.errstate(divide="ignore"):
        dec = [u < np.log(_stack(r[k], "hyper_accept"))
               for k in ("j_calls", "t_calls")]
    bad = np.argwhere(dec[0] != dec[1])
    print("  first hyper decision to differ: "
          + (f"epoch {bad[0][0] + 1}, chain {bad[0][1]}" if bad.size
             else "none"))
    j_th, t_th = (_stack(r[k], "theta") for k in ("j_calls", "t_calls"))
    over = (np.abs(t_th - j_th) > 1e-4 + 1e-3 * np.abs(j_th)).any(
        axis=(1, 2))
    print(f"  first epoch whose states differ past rtol 1e-3 / atol 1e-4: "
          f"{int(np.argmax(over)) + 1 if over.any() else 'none'}")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 \
    #     tests/test_torch_classification_driver_parity.py
    import sys

    import conftest  # noqa: F401  (the test suite's XLA flags)

    for name in CASES:
        first_differences(run_case(name, int(sys.argv[1]) if sys.argv[1:]
                                   else 100))


# ---------------------------------------------------------------------------
# the moons example's full configuration, as chip_smoke.py and
# chip_profile.py run it on the card
# ---------------------------------------------------------------------------

def test_the_moons_constants_are_the_example_s(monkeypatch, tmp_path):
    """``chip_smoke.MOONS_MCMC``, the epochs, sampling step and networks a
    file, the Network seed and the layers are what the JAX example's full
    configuration hands its Network (recorded as
    tests/test_torch_examples.py records the ``--smoke`` build), and
    ``chip_smoke.moons_network`` builds the same layers over the same
    rows."""
    import chip_smoke as cs
    from test_torch_examples import _record, _same_layer

    want = _record(monkeypatch, "classification",
                   ["--cpu", "--folder", str(tmp_path / "run")], "jax")
    net = want["net"]
    assert net["config"] == cs.MOONS_MCMC
    epochs, step, lik, kw = net["train"]
    assert (epochs, step) == (cs.MOONS_EPOCHS, cs.MOONS_STEP)
    assert lik[0] == "BernoulliLikelihood"
    assert dict(kw)["networks_per_file"] == cs.MOONS_PER_FILE
    assert want["pretrain"]["args"] == (2, 2, 1, cs.MOONS_WIDTH, 2, 80, 0.1)
    assert want["pretrain"]["kw"] == {"train_slopes": True}
    got, got_lik = cs.moons_network("cpu", seed=net["seed"])
    assert type(got_lik).__name__ == "BernoulliLikelihood"
    assert len(got.model.layers) == len(net["layers"])
    for g, (w, _) in zip(got.model.layers, net["layers"]):
        _same_layer(g, w)
    for g, w in zip((got.train_x, got.train_y, got.validate_x,
                     got.validate_y),
                    net["data"]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert cs.moons_ladder_mcmc(1e-2, 100) == dict(
        cs.MOONS_MCMC, step_size_start=1e-2, step_size_min=1e-2,
        step_size_max=1e-2, leapfrog_start=100, leapfrog_min=100,
        leapfrog_max=100)


def test_the_moons_parameters_round_trip():
    """``moons_parameters`` and ``flat_moons`` invert each other in the
    Network's theta order (the port's ``flatten_state`` of a Network
    warm-started from them), and ``moons_probs`` is the port's forward."""
    import chip_smoke as cs
    from tensorbnn_tpu_torch.sampler.potential import flatten_state

    flat = np.random.default_rng(0).normal(size=369).astype(np.float32)
    params = cs.moons_parameters(flat)
    assert params[-1] is None and len(params) == 6
    np.testing.assert_array_equal(cs.flat_moons(params), flat)
    net, lik = cs.moons_network("cpu", parameters=params)
    p, h = net.init_state()
    np.testing.assert_array_equal(
        flatten_state(p, h, lik.init_hypers()).theta.numpy(), flat)
    x = net.validate_x
    np.testing.assert_allclose(cs.moons_probs(params, x.numpy()),
                               net.model.apply(p, x)[:, 0].numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="369"):
        cs.moons_parameters(flat[:-1])


def test_the_committed_moons_warm_start_is_the_jax_package_s():
    """``chip_smoke.MOONS_WARM_START`` holds what ``jax_reference_stats.py
    classification --warm-start`` trains: the JAX package's
    ``train_basic_classification`` at the example's full pretraining (2
    cycles x 80 epochs, trained slopes) over its rows (float32 orders may
    differ between CPUs, hence the tolerance); it classifies the
    validation rows better than chance."""
    import chip_smoke as cs

    x, y, xv, yv = cs.moons_data()
    w, b, a = train_basic_classification(
        2, 2, 1, cs.MOONS_WIDTH, 2, 80, alpha=0.1, train_in=x, train_out=y,
        val_in=xv, val_out=yv, train_slopes=True)
    want = cs.flat_moons([dense_warm_start(w, b, 0),
                          squareprelu_warm_start(a, 0),
                          dense_warm_start(w, b, 1),
                          squareprelu_warm_start(a, 1),
                          dense_warm_start(w, b, 2), None])
    got = np.load(cs.repo_file(cs.MOONS_WARM_START))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    probs = cs.moons_probs(cs.moons_jax_warm_start(), xv)
    assert np.mean((probs > 0.5) == (yv > 0.5)) > 0.8


def test_the_moons_equilibrium_and_the_jax_ladder_lines():
    """The committed state at equilibrium (4 rows of the moons stack's
    theta and eta, finite, its slopes and scales where a posterior puts
    them) and the JAX package's ladder figures (``jax_reference_stats.py
    classification --ladder``): a line for each state and rung of
    the state's ``MOONS_LADDER_STEPS``, in that order, over
    ``MOONS_LADDER_CHAINS`` chains, at each state a rung where the JAX
    package's mean accept probability lies between 0.2 and 0.9."""
    import chip_smoke as cs

    theta, eta = cs.moons_equilibrium()
    assert theta.shape == (4, 369) and eta.shape == (4, 16)
    assert np.isfinite(theta).all() and np.isfinite(eta).all()
    for row in theta:
        assert np.mean((cs.moons_probs(cs.moons_parameters(row),
                                       cs.moons_data()[2]) > 0.5)
                       == (cs.moons_data()[3] > 0.5)) > 0.9
    assert [(r["state"], r["eps"], r["leapfrog"])
            for r in cs.MOONS_LADDER_JAX] == [
        (st, e, s) for st in ("warm", "equilibrium")
        for e, s in cs.MOONS_LADDER_STEPS[st]]
    assert cs.MOONS_LADDER_CHAINS % theta.shape[0] == 0
    for r in cs.MOONS_LADDER_JAX:
        assert 0 <= r["main_accept"] <= 1 and r["main_accept_se"] > 0
        assert len(r["main_accept_chain"]) == cs.MOONS_LADDER_CHAINS
        assert r["main_accept"] == pytest.approx(
            np.mean(r["main_accept_chain"]))
        assert 0 < r["hyper_accept"] < 1
    for st in ("warm", "equilibrium"):
        assert any(0.2 < r["main_accept"] < 0.9 for r in cs.MOONS_LADDER_JAX
                   if r["state"] == st), st


def test_the_moons_jax_seed_lines():
    """The JAX package's full moons runs (``jax_reference_stats.py
    classification``): seeds ``MOONS_SEEDS``, 300 recorded networks each
    (4,000 epochs, burn-in 1,000, every 10th), every statistic the band
    reads, a final (eps, L) on the example's grid."""
    import chip_smoke as cs

    assert [r["seed"] for r in cs.MOONS_JAX_SEEDS] == list(cs.MOONS_SEEDS)
    mcmc = cs.MOONS_MCMC
    for r in cs.MOONS_JAX_SEEDS:
        assert set(cs.MOONS_BAND) | {"hyper_accept"} <= set(r)
        assert r["samples"] == r["networks"] == (
            cs.MOONS_EPOCHS - mcmc["burnin"]) // cs.MOONS_STEP
        assert 0.5 < r["val_accuracy"] <= 1
        assert 0 < r["main_accept"] < 1 and 0 < r["hyper_accept"] < 1
        assert 0 < r["min_param_ess"] <= r["median_param_ess"]
        assert 0 < r["total_ess"] <= r["samples"]
        assert (mcmc["step_size_min"] <= r["final_step_size"]
                <= mcmc["step_size_max"])
        assert (mcmc["leapfrog_min"] <= r["final_leapfrog"]
                <= mcmc["leapfrog_max"])


def test_the_moons_band_reads_the_seed_files(tmp_path, capsys):
    """``chip_profile.moons_band`` over seed files in two folders: the
    seeds in order, ``chip_smoke.seed_band`` of ``MOONS_BAND`` and the
    hyper acceptance against ``MOONS_JAX_SEEDS``, each side's final (eps,
    L), and ``failed`` naming a statistic whose z exceeds the limit."""
    import json

    import chip_profile as cp
    import chip_smoke as cs

    keys = cs.MOONS_BAND + ("hyper_accept", "final_step_size",
                            "final_leapfrog")
    port = [dict({k: r[k] for k in keys}, seed=r["seed"], card="card",
                 wall_seconds=1.0, main_path="K1")
            for r in cs.MOONS_JAX_SEEDS]
    for line in port:
        line["min_param_ess"] = 100.0
    for i, line in enumerate(port):
        folder = tmp_path / ("a" if i < 2 else "b")
        folder.mkdir(exist_ok=True)
        (folder / f"moons_seed{line['seed']}.json").write_text(
            json.dumps(line))
    got = cp.moons_band([str(tmp_path / "b"), str(tmp_path / "a")])
    assert got["port_seeds"] == list(cs.MOONS_SEEDS)
    want = cs.seed_band(port, cs.MOONS_JAX_SEEDS,
                        cs.MOONS_BAND + ("hyper_accept",))
    for key, band in want.items():
        assert got[key] == band
    assert got["failed"] == ["min_param_ess"]
    assert want["val_accuracy"]["z"] == want["main_accept"]["z"] == 0.0
    assert got["port_final"] == got["jax_final"]
    assert json.loads(capsys.readouterr().out)["moons_band"] == got
