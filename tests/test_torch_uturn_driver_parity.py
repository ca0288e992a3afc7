"""The port's ``sample_posterior(trajectory="uturn")`` against the JAX
package's, over whole runs, on the JAX package's own draws.

tests/test_torch_uturn.py holds the U-turn epoch and the ``UTurnAdapter``
copy; tests/test_torch_driver_parity.py holds the GP-UCB driver over whole
runs. Here the U-turn driver is held over a whole run: its burn-in chunks
of ``averaging_steps`` epochs, each planned by ``UTurnAdapter.plan_chunk``
(a probe past the current length under "always", probe and exploit chunks
in turn under "alternate") and fed back through ``observe`` (one
Robbins-Monro step-size update a chunk on the fleet's mean acceptance, the
recorded first-U-turn steps into the reservoir, the executed length for a
censored trajectory), the freeze at the end of burn-in, and the sampling
chunk whose lengths are drawn from the reservoir by the adapter's numpy
generator.

Both drivers run the narrow flagship of test_torch_driver_parity.py from
one initial fleet of 16 chains: the JAX package on its XLA path, the port
on K1's U-turn-recording twin and K2's twin, fed the JAX package's
per-chain draws through the patched ``draw_epoch``. Held equal, under both
probes: every chunk's plan (its first epoch, its length, each epoch's L)
and its eps; every recorded first-U-turn step (0 = censored), in the
traces and as ``observe`` reads them; every main and hyper MH decision;
the adapter's state at the end (``state_dict()``, its generator's state
included: both adapters seed it from ``adapter_seed``). The step size is a
Robbins-Monro iterate of the fleet's mean acceptance, which each side
forms from its own float32 energy errors, so eps agrees to rtol 1e-4, not
bit for bit: it differs by 6.35e-6 (relative) after the first update and
by ~5e-6 at the freeze, ``log_eps_bar`` by ~9e-7. Everything discrete is
equal. The acceptance slices after burn-in agree to atol 1e-3 and the
samples to rtol 1e-3 / atol 1e-4, as in the GP-UCB driver's test.

The settings give a chunk where some chains turned within their L and
some were censored (3 of the first chunk's 80 chain-epochs turned, at
epoch 2), the freeze at epoch 10 and an 8-epoch sampling chunk whose
lengths are drawn from the reservoir. The runs stop at epoch 18. Run on
to 100 epochs (``JAX_PLATFORMS=cpu PYTHONPATH=. python3
tests/test_torch_uturn_driver_parity.py`` prints it), no recorded U-turn
step differs; the states first differ past the samples' tolerance at
epoch 24 under "always" and 30 under "alternate"; the first main decision
to differ is at epoch 76 under "always" (chain 3, (eps, L) = (0.003024,
30)), from starts 4.55e-3 apart, where float64 agrees with each side's
float32 (-0.0217 / -0.0217 from the JAX start, -0.0194 / -0.0193 from the
port's, against a coin of -0.0205): float32 order amplified by the
leapfrog, not a driver fault. Under "alternate" no decision differs in
100 epochs.
"""

import numpy as np
import pytest

import tensorbnn_tpu.sampler.uturn as j_uturn
import tensorbnn_tpu_torch.sampler.driver as t_driver
from test_torch_driver_parity import MCMC, _stack, check_mh_decisions, \
    check_slices_and_samples, first_flip, run_drivers

# ess_run's U-turn block cut to the narrow flagship: a step size capped
# below where the leapfrog amplifies float32 order fast (the Robbins-Monro
# target of 0.8 acceptance lies past it), lengths probed from 30 (1.5 x
# 20), a burn-in of two chunks and an 8-epoch sampling chunk sampled every
# second epoch
EPOCHS, BURNIN, N_CHAINS = 18, 10, 16
UT_MCMC = dict(MCMC, step_size_start=2e-3, step_size_max=4e-3,
               leapfrog_start=20, leapfrog_min=10, leapfrog_max=60,
               burnin=BURNIN, averaging_steps=5)
PROBES = ("always", "alternate")


def _planner(cls, plans, made):
    """``cls`` (a ``UTurnAdapter``) recording itself, each ``plan_chunk``
    answer ``(iter_, chunk, eps, L)`` and each ``observe`` call's U-turn
    steps and executed lengths."""
    class Planner(cls):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.observed = []
            made.append(self)

        def plan_chunk(self, iter_, chunk):
            eps, leaps = super().plan_chunk(iter_, chunk)
            plans.append((iter_, chunk, eps, np.array(leaps)))
            return eps, leaps

        def observe(self, iter_before, accept_means, uturns, executed):
            self.observed.append((iter_before, np.array(accept_means),
                                  np.array(uturns), np.array(executed)))
            return super().observe(iter_before, accept_means, uturns,
                                   executed)
    return Planner


def run_uturn(probe: str, epochs: int = EPOCHS) -> dict:
    """``run_drivers`` in U-turn mode under ``probe``, with each side's
    plans and adapter."""
    plans = {"j": [], "t": []}
    made = {"j": [], "t": []}
    mp = pytest.MonkeyPatch()
    try:
        # the JAX driver imports the class from its module at each call
        mp.setattr(j_uturn, "UTurnAdapter",
                   _planner(j_uturn.UTurnAdapter, plans["j"], made["j"]))
        mp.setattr(t_driver, "UTurnAdapter",
                   _planner(t_driver.UTurnAdapter, plans["t"], made["t"]))
        r = run_drivers(N_CHAINS, epochs=epochs, mcmc=UT_MCMC,
                        trajectory="uturn", uturn_probe=probe)
    finally:
        mp.undo()
    assert len(made["j"]) == len(made["t"]) == 1
    return dict(r, case=f"uturn:{probe}", plans=plans,
                adapters={k: v[0] for k, v in made.items()})


@pytest.fixture(scope="module", params=PROBES)
def runs(request):
    return run_uturn(request.param)


def test_port_ran_its_main_path(runs):
    t_res = runs["t"]
    assert t_res.main_path == "K1" and t_res.fused_hyper
    assert t_res.n_epochs == runs["j"].n_epochs == EPOCHS
    assert runs["adapters"]["t"].probe == runs["case"].split(":")[1]


def test_every_chunk_plan_is_the_same(runs):
    """Each ``plan_chunk`` answer: the same chunk, each epoch's L equal,
    eps to rtol 1e-4; the runners got the same; the burn-in chunks end on
    the burn-in and the sampling chunk draws from the reservoir."""
    j_plans, t_plans = runs["plans"]["j"], runs["plans"]["t"]
    assert [p[:2] for p in t_plans] == [p[:2] for p in j_plans] == \
        [(0, 5), (5, 5), (10, 8)]
    for (it, _, j_eps, j_l), (_, _, t_eps, t_l) in zip(j_plans, t_plans):
        np.testing.assert_array_equal(t_l, j_l, err_msg=f"epoch {it}")
        np.testing.assert_allclose(t_eps, j_eps, rtol=1e-4)
    for jc, tc in zip(runs["j_calls"], runs["t_calls"]):
        assert tc["n"] == jc["n"]
        np.testing.assert_array_equal(tc["leap"], jc["leap"])
        np.testing.assert_allclose(tc["eps"], jc["eps"], rtol=1e-4)
    # the probe's growth in burn-in (1.5 x 20, then 1.5 x the median
    # under "always"), then lengths drawn from what burn-in recorded
    ad = runs["adapters"]["t"]
    assert t_plans[0][3].tolist() == [30] * 5
    assert set(t_plans[-1][3]) <= set(ad.reservoir)
    np.testing.assert_array_equal(runs["t"].leapfrog,
                                  np.concatenate([p[3] for p in t_plans]))


def test_every_uturn_step_is_the_same(runs):
    """The recorded first-U-turn steps, in the chunk traces and as each
    side's ``observe`` reads them (the port's ride its diagnostics
    transfer as float32), with chunks where some chains turned within
    their L and some were censored."""
    j_ut, t_ut = (_stack(runs[k], "uturn") for k in ("j_calls", "t_calls"))
    np.testing.assert_array_equal(t_ut, j_ut)
    assert t_ut.shape == (EPOCHS, N_CHAINS)
    obs = {k: ad.observed for k, ad in runs["adapters"].items()}
    assert len(obs["t"]) == len(obs["j"]) == 3
    for (j_it, j_acc, j_u, j_x), (t_it, t_acc, t_u, t_x) in zip(
            obs["j"], obs["t"]):
        assert t_it == j_it
        np.testing.assert_array_equal(t_u, j_u)
        np.testing.assert_array_equal(t_x, j_x)
        np.testing.assert_allclose(t_acc, j_acc, rtol=0, atol=1e-3)
    turned = (t_ut[:BURNIN] > 0).sum()
    assert 0 < turned < BURNIN * N_CHAINS
    np.testing.assert_array_equal(runs["t"].uturn_turned,
                                  (j_ut > 0).sum(axis=1))


def test_every_mh_decision_is_the_same(runs):
    check_mh_decisions(runs)


def test_final_adapter_state_is_the_same(runs):
    """``state_dict()`` at the end, frozen, with the same reservoir,
    counters and generator state; eps and ``log_eps_bar`` to rtol 1e-4;
    the drivers' final (eps, L) are the adapter's."""
    j_st, t_st = (runs["adapters"][k].state_dict() for k in "jt")
    assert t_st.keys() == j_st.keys()
    for key in t_st:
        if key in ("eps", "log_eps_bar"):
            np.testing.assert_allclose(t_st[key], j_st[key], rtol=1e-4)
        else:
            assert t_st[key] == j_st[key], key
    assert t_st["frozen"] and t_st["t"] == 2
    j_res, t_res = runs["j"], runs["t"]
    assert t_res.final_leapfrog == j_res.final_leapfrog == t_st["l_hat"]
    assert t_res.final_step_size == t_st["eps"]
    np.testing.assert_allclose(t_res.final_step_size,
                               j_res.final_step_size, rtol=1e-4)


def test_acceptance_slices_and_samples_match(runs):
    check_slices_and_samples(runs)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python3
    # tests/test_torch_uturn_driver_parity.py
    for name in PROBES:
        r = run_uturn(name, 100)
        first_flip(r)
        bad = np.argwhere(_stack(r["j_calls"], "uturn")
                          != _stack(r["t_calls"], "uturn"))
        print(f"  first recorded U-turn step to differ: "
              + (f"epoch {bad[0][0] + 1}, chain {bad[0][1]}" if bad.size
                 else "none"))
        # each epoch's states against the samples' tolerance
        j_th, t_th = (_stack(r[k], "theta") for k in ("j_calls", "t_calls"))
        over = (np.abs(t_th - j_th) > 1e-4 + 1e-3 * np.abs(j_th)).any(
            axis=(1, 2))
        print(f"  first epoch whose states differ past rtol 1e-3 / atol "
              f"1e-4: {int(np.argmax(over)) + 1 if over.any() else 'none'}")
