"""The port's ``sample_posterior`` against the JAX package's over whole runs
of the 1M-point surrogate's big-data path, on the JAX package's own draws.

tests/test_torch_driver_parity.py holds the driver over whole runs of the
narrow flagship (fixed sd, no ``data_chunk``); tests/test_torch_data_chunk.py
holds the big-data options over three epochs. Here the two meet: both
drivers run the surrogate at its real widths (8-64-64-1 tanh Gaussian dense
layers, D = 4,801, under the learned-sd ``GaussianLikelihood(sd=0.1)``)
over 4,096 of its rows in chunks of 1,024, from a MAP warm start of the JAX
package's ``train_basic_regression`` carried over with ``convert``, 4
chains without jitter (8 under ``precondition``, the JAX driver's floor),
the port fed the JAX package's per-chain draws through the patched
``draw_epoch`` (that file's ``run_drivers``). The bench's step grid is
scaled by sqrt(1,000,000 / 4,096), so its random phase spans high
acceptance (7.8e-6, L 10: every proposal accepted) and the stability edge
(the grid top, 7.8e-4, where acceptance falls to 0.2-0.9 and, later, to
nothing at some epochs on both sides, as the card's run at 1M rows did at
4.87e-5). Three cases: ``numerics="exact"`` (the Kahan leapfrog on the
plain path, chunked); the same with one ``estimate_step_scale`` window at
the first chunk boundary from epoch 9; and default numerics (K3's CPU twin
over row chunks, K2's twin). Each run holds the adapter's random phase
(draws at epochs 5 and 7), two GP-UCB updates before the burn-in of 12
(epochs 9, 11) and one after it at p = 0.71 (epoch 17).

Held equal: every chunk's length and (eps, L), and the step scale it
passes (to 1e-3: each side's cross-chain spread of its own float32 states,
6e-5 apart); after every adapter call the adapter's counter, strike count,
step-size bounds (a halving would move them), resets, points in its GP
window and answer (no strike fires: the SJD stays at 9e-6 or more, over the
1e-8 a strike needs); its final ``state_dict()`` (the SJD window to rtol
1e-4, each side's mean of its own float32 squared jumps; the rest, the
generator's state included, exactly); every main and hyper MH decision; the
acceptance slices after burn-in, the recorded samples and the learned sd's
samples at tests/test_torch_driver_parity.py's tolerances. The hyper step
is the bench's 1e-6 raised to 1e-4, so that the hyper block rejects too.

The runs stop at epoch 17 (~140 s for the file on one CPU). Run on to 100
epochs (``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3
tests/test_torch_surrogate_driver_parity.py`` prints it), no main or hyper
decision differs under exact or default numerics (the states 8.3e-7 and
3.1e-6 apart at epoch 100). Under ``precondition`` the first main decision
to differ is at epoch 91 (chain 5, (eps, L) = (7.8e-4, 15)), where the
states have parted by 1.33e-4 and the diagonal metric has pushed the
acceptance to 0-0.13; from each side's start the port's leapfrog gives the
same log-accept ratio in float32 and float64 (1.4268 / 1.4166 from the JAX
start, -29.8235 / -29.8274 from the port's, against a coin of -1.0090):
float32 order amplified past the stability edge, not a driver fault.
"""

import math

import jax
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
import tensorbnn_tpu_torch.sampler.driver as t_driver
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.training.pretrain import dense_warm_start, \
    train_basic_regression
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from test_torch_driver_parity import check_mh_decisions, \
    check_slices_and_samples, first_flip, run_drivers

torch.set_num_threads(1)

# the surrogate at its real widths over ROWS of its data, in chunks of CHUNK
ROWS, CHUNK, WIDTH, D_IN = 4096, 1024, 64, 8
# the bench's exact-numerics step grid (run_benchmarks.py:549-555) scaled by
# sqrt(1,000,000 / 4,096): the posterior's width goes as one over the
# square root of the rows. Adapter cycles of 2 epochs: the start's (eps, L)
# to epoch 5, random draws at epochs 5 and 7, GP-UCB updates at 9 and 11
# (before the burn-in of 12) and at 13, 15 (p = 1) and 17 (p = 0.71, and
# the adapter's draw fires it). The hyper step is the bench's 1e-6 raised
# to 1e-4, so that the hyper block rejects too (at 1e-6 it accepts every
# proposal on both sides)
GRID = math.sqrt(1_000_000 / ROWS)
EPOCHS, BURNIN, STEP = 17, 12, 2
MCMC = dict(step_size_start=5e-7 * GRID, step_size_min=1e-8 * GRID,
            step_size_max=5e-5 * GRID, step_size_options=40,
            leapfrog_start=10, leapfrog_min=5, leapfrog_max=15,
            leapfrog_increment=5, hyper_step_size=1e-4, hyper_leapfrog=5,
            burnin=BURNIN, averaging_steps=2, random_steps=3,
            adapter_seed=0)
# one window of the diagonal metric, estimated at the first chunk boundary
# from epoch PRECONDITION on (needs 8 chains, the JAX driver's floor)
PRECONDITION = 9
# (chains, sample_posterior keywords) of each case: the plain path under
# numerics="exact" (Kahan, "highest"); the same with one metric window; and
# default numerics, on K3's twin over row chunks and K2's twin
CASES = {"exact": (4, dict(numerics="exact")),
         "precondition": (8, dict(numerics="exact",
                                  precondition=PRECONDITION)),
         "default": (4, {})}
# the step scale's tolerance: each side's cross-chain spread of its own
# float32 states (the two differ by up to 6e-5 relative)
SCALE_RTOL = 1e-3
# the adapter's float state (the SJD window's means and sds and what derives
# from them): each side's SJD is the mean of its own float32 squared
# jumps, ~1e-5 relative apart
ADAPTER_RTOL = 1e-4


def surrogate_models(x, y, weights, biases):
    """Both packages' 8-64-64-1 tanh stack under the learned-sd
    ``GaussianLikelihood(sd=0.1)``, the data, and the JAX package's
    initial ``(params, hypers)`` with the dense layers warm-started from
    ``(weights, biases)`` (``train_basic_regression``'s layout)."""
    dims = [D_IN, WIDTH, WIDTH, 1]
    j_layers, t_layers = [], []
    for i in range(3):
        j_layers.append(J.GaussianDenseLayer(dims[i], dims[i + 1]))
        t_layers.append(T.GaussianDenseLayer(dims[i], dims[i + 1]))
        if i < 2:
            j_layers.append(J.Tanh())
            t_layers.append(T.Tanh())
    j_model = JSequential(j_layers)
    params, hypers = j_model.init(jax.random.key(0))
    params = tuple(
        {**p, **{k: jax.numpy.asarray(v, jax.numpy.float32) for k, v in
                 dense_warm_start(weights, biases, i // 2).items()}}
        if i % 2 == 0 else p for i, p in enumerate(params))
    return (j_model, J.GaussianLikelihood(sd=0.1), TSequential(t_layers),
            T.GaussianLikelihood(sd=0.1), x, y, params, hypers)


def surrogate_problem(rows: int = ROWS, batch: int = 32, epochs: int = 16):
    """``surrogate_models`` over the surrogate's data as the bench makes it
    (run_benchmarks.py:406-410) at ``rows`` rows, from a MAP warm start by
    the JAX package's ``train_basic_regression`` (one cycle of ``epochs``
    epochs at ``batch`` rows a batch: at 4,096 rows an MSE of 0.0203 over
    them, as the bench's 0.0189 over its 1M; the bench's 4 epochs at 8,192
    rows a batch would be 4 steps here, an MSE of 0.568)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(rows, D_IN)).astype(np.float32)
    y = (np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=rows)).astype(
        np.float32)
    w, b, _ = train_basic_regression(
        2, D_IN, 1, WIDTH, cycles=1, epochs=epochs, alpha=0.1, train_in=x,
        train_out=y, val_in=x[:256], val_out=y[:256], batch_size=batch,
        callbacks=False, hidden_activation="tanh")
    return surrogate_models(x, y, w, b)


_PROBLEM = []


def _problem():
    """``surrogate_problem()``, built once a process."""
    if not _PROBLEM:
        _PROBLEM.append(surrogate_problem())
    return _PROBLEM[0]


def run_case(case: str, epochs: int = EPOCHS) -> dict:
    """Both drivers over ``epochs`` epochs of ``CASES[case]`` from the MAP
    warm start, no jitter, ``data_chunk=CHUNK``, the port on the JAX
    package's draws (``run_drivers``)."""
    n_chains, kw = CASES[case]
    return dict(run_drivers(n_chains, epochs=epochs, mcmc=MCMC,
                            problem=_problem, chain_jitter=0.0,
                            sampling_step=STEP, data_chunk=CHUNK, **kw),
                case=case)


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    return run_case(request.param)


def test_port_ran_the_big_data_path(runs):
    """Both drivers ran every epoch; the exact cases on the plain path,
    default numerics on K3's twin over row chunks and K2's twin."""
    t = runs["t"]
    assert t.n_epochs == runs["j"].n_epochs == EPOCHS
    if runs["case"] == "default":
        assert t.main_path == "K3" and t.fused_hyper
    else:
        assert t.main_path == "plain" and not t.fused_hyper


def test_each_chunk_has_the_same_step_and_leapfrog(runs):
    """Every chunk has the same length, (eps, L) and step scale on both
    sides, and the run holds the random phase, two GP-UCB updates before
    the burn-in and one after it at p < 1."""
    j_calls, t_calls = runs["j_calls"], runs["t_calls"]
    assert [c["n"] for c in t_calls] == [c["n"] for c in j_calls]
    for jc, tc in zip(j_calls, t_calls):
        np.testing.assert_array_equal(tc["eps"], jc["eps"])
        np.testing.assert_array_equal(tc["leap"], jc["leap"])
        assert (tc["scale"] is None) == (jc["scale"] is None)
        if jc["scale"] is not None:
            np.testing.assert_allclose(tc["scale"], jc["scale"],
                                       rtol=SCALE_RTOL)
    assert list(zip(runs["t"].group_step_size,
                    runs["t"].group_leapfrog)) == runs["j_groups"]
    assert runs["t"].final_step_size == runs["j"].final_step_size
    assert runs["t"].final_leapfrog == runs["j"].final_leapfrog
    ups = runs["j_adapters"][0].log
    assert [u["phase"] for u in ups if u["epoch"] <= 7] == ["random",
                                                              "random"]
    assert len([u for u in ups if u["phase"] == "gp"
                and u["epoch"] <= BURNIN]) >= 2
    assert any(u["epoch"] > BURNIN and u["p"] < 1 for u in ups), ups


def test_the_step_scale_is_estimated_once_and_the_same(runs):
    """Under ``precondition`` one metric window fires on each side, from
    the same chunk on, its scale to ``SCALE_RTOL``; the other cases never
    estimate one."""
    j_s, t_s = runs["j_scales"], runs["t_scales"]
    if runs["case"] != "precondition":
        assert j_s == t_s == []
        return
    assert len(j_s) == len(t_s) == 1
    np.testing.assert_allclose(t_s[0], j_s[0], rtol=SCALE_RTOL)
    assert j_s[0].min() < 1 < j_s[0].max()
    # the chunks before the estimate pass ones, the rest the estimate
    metric = [[bool(np.any(c["scale"] != 1)) for c in runs[k]]
              for k in ("j_calls", "t_calls")]
    assert metric[0] == metric[1] and 0 < sum(metric[0]) < len(metric[0])


def test_the_adapters_take_the_same_trail(runs):
    """After every adapter call: the same counter, strike count, step-size
    bounds (a halving would move them), resets, points in the GP window
    and answer; and the same GP/proposal cycles (epoch, phase, gating
    probability, answer, strikes)."""
    (j_a,), (t_a,) = runs["j_adapters"], runs["t_adapters"]
    assert len(j_a.trail) == len(t_a.trail) == EPOCHS
    assert t_a.trail == j_a.trail
    assert t_a.log == j_a.log


def test_the_adapters_end_in_the_same_state(runs):
    """The final ``state_dict()``: every discrete entry and the generator
    equal, the SJD window and what derives from it to
    ``ADAPTER_RTOL``."""
    (j_a,), (t_a,) = runs["j_adapters"], runs["t_adapters"]
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
    """tests/test_torch_driver_parity.py's tolerances for the acceptance
    slices and the samples, and the learned sd's samples at the samples'
    tolerance."""
    check_slices_and_samples(runs)
    sd = [r.eta_samples[..., -1] ** 2 for r in (runs["t"], runs["j"])]
    np.testing.assert_allclose(sd[0], sd[1], rtol=1e-3, atol=1e-4)
    assert (sd[1] > 0.1).all()


def test_the_committed_warm_start_is_the_jax_package_s():
    """``chip_smoke.SURR_WARM_START`` holds what ``jax_reference_stats.py
    surrogate --warm-start`` trains: the JAX package's MAP warm start at the
    bench's pretraining settings over the bench's 1M rows, in the layout
    ``surrogate_jax_warm_start`` reads back (float32 orders may differ
    between CPUs, hence the tolerance)."""
    import chip_smoke as cs

    x, y = cs.surrogate_data()
    w, b, _ = train_basic_regression(
        2, D_IN, 1, WIDTH, cycles=1, epochs=cs.SURROGATE_EPOCHS, alpha=0.1,
        train_in=x, train_out=y, val_in=x[:4096], val_out=y[:4096],
        batch_size=cs.SURROGATE_BATCH, callbacks=False,
        hidden_activation="tanh")
    got = cs.surrogate_jax_warm_start()
    assert got[2] == []
    for want, have in zip(list(w) + list(b), got[0] + got[1]):
        assert have.dtype == np.float32
        np.testing.assert_allclose(have, np.asarray(want).reshape(
            have.shape), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(cs.flat_warm_start(got[0], got[1]),
                                  np.load(cs.repo_file(cs.SURR_WARM_START)))


def test_the_equilibrium_state_and_the_jax_ladder_lines():
    """The committed state at equilibrium (4 chains of the surrogate's
    theta and eta, a learned sd near the warm start's residual) and the JAX
    package's ladder figures (``jax_reference_stats.py surrogate
    --ladder``): a line for each state and rung of ``LADDER_STEPS``, in
    that order, with the figures phase 10 (g) gates on (from the
    equilibrium state at (4.87e-5, 15) every accept probability is 0)."""
    import chip_smoke as cs

    theta, eta = cs.surrogate_equilibrium()
    assert theta.shape == (4, 4801) and eta.shape == (4, 13)
    assert np.isfinite(theta).all() and np.isfinite(eta).all()
    assert (0.1 < eta[:, -1] ** 2).all() and (eta[:, -1] ** 2 < 0.2).all()
    assert [(r["state"], r["eps"], r["leapfrog"]) for r in cs.LADDER_JAX] \
        == [(st, e, s) for st in ("warm", "equilibrium")
            for e, s in cs.LADDER_STEPS]
    assert cs.LADDER_CHAINS % theta.shape[0] == 0
    for r in cs.LADDER_JAX:
        assert 0 <= r["main_accept"] <= 1 and r["main_accept_se"] >= 0
        assert len(r["main_accept_chain"]) == 4
        assert r["main_accept"] == pytest.approx(
            np.mean(r["main_accept_chain"]))
        assert 0.1 < r["learned_sd"] < 0.2 and 0 < r["hyper_accept"] <= 1


def test_ladder_figures():
    """``chip_smoke.ladder_figures`` against the hand-computed figures."""
    import chip_smoke as cs

    accept = np.array([[1.0, 0.5], [0.5, 0.0]])
    eta = np.zeros((2, 2, 3))
    eta[..., -1] = [[1.0, 2.0], [3.0, 4.0]]
    got = cs.ladder_figures(accept, eta)
    assert got["main_accept_chain"] == [0.75, 0.25]
    assert got["main_accept"] == 0.5
    assert got["main_accept_se"] == pytest.approx(math.sqrt(0.125 / 2))
    assert got["learned_sd"] == pytest.approx(7.5)


def test_the_full_run_reads_its_adapter():
    """``chip_profile.record_adapters`` and ``segments`` on a short CPU
    run: each adapter call leaves a ``trail`` entry, and each logged
    update's (eps, L) runs from the epoch after it, so the post-burn-in
    stretches they give cover every epoch after the burn-in once, in
    order, each at the leapfrog count the run reports for its epochs, and
    the log holds the random phase's draws and then GP-UCB updates."""
    import chip_profile as cp

    x = np.linspace(-1, 1, 16)
    net = T.Network(np.float32, 1, x, np.sin(3 * x), x, np.sin(3 * x),
                    seed=0, device="cpu")
    net.add(T.GaussianDenseLayer(1, 4)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(4, 1))
    net.setup_mcmc(step_size_start=1e-3, step_size_min=1e-3,
                   step_size_max=2e-2, step_size_options=8,
                   leapfrog_start=3, leapfrog_min=2, leapfrog_max=12,
                   leapfrog_increment=1, hyper_leapfrog=2, burnin=10,
                   averaging_steps=2, random_steps=2)
    real = t_driver.MCMCConfig.make_adapter
    made = []
    undo = cp.record_adapters(t_driver, made)
    try:
        res = net.train(20, 2, T.FixedGaussianLikelihood(sd=0.1),
                        n_chains=2, verbose=False)
    finally:
        undo()
    assert t_driver.MCMCConfig.make_adapter is real
    (adapter,) = made
    assert len(adapter.trail) == 20
    assert [u["phase"] for u in adapter.log[:2]] == ["random", "gp"]
    assert [u["epoch"] for u in adapter.log[:2]] == [5, 7]
    segs = cp.segments(adapter.log, (1e-3, 3), res.main_accept, 10)
    assert [e for s in segs for e in range(s["first"], s["last"] + 1)] \
        == list(range(11, 21))
    for seg in segs:
        assert (res.leapfrog[seg["first"] - 1:seg["last"]]
                == seg["leapfrog"]).all()
    assert (segs[-1]["eps"], segs[-1]["leapfrog"]) == (
        res.final_step_size, res.final_leapfrog)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python3 \
    #     tests/test_torch_surrogate_driver_parity.py
    for name in sorted(CASES):
        first_flip(run_case(name, 100))
