"""The port's ``sample_posterior`` against the JAX package's, over whole
runs, on the JAX package's own draws.

The epoch parity tests (tests/test_torch_sampler.py) stop at the epoch.
Above it sits the driver: the chunk plan, the split of the chains into
adapter groups, each group's GP-UCB update from its mean SJD, the dual
averaging in the carry, burn-in and thinning. Here both drivers run the
same narrow flagship from the same initial fleet: the JAX package's
``sample_posterior`` on its XLA path, and the port's on the CPU twins of
K1 and K2. The port takes, epoch by epoch, the draws the JAX package makes
from its per-chain keys (gibbs.py:163-166 splits each key in three, or
four under tempering; the main and hyper blocks split theirs into
momentum and coin, hmc.py:312-316; the swap draws one uniform a replica,
tempering.py:101). They reach the port through ``draw_epoch``, patched
where the eager chunk runner calls it (parallel/chains.py), and the JAX
package's initial fleet through the port's ``init_multichain_state``.

Each run spans the adapters' random phase and at least two GP-UCB updates
a group. Held equal: every chunk's length and each chain's (eps, L), so
each group's choice; every epoch's MH decisions (main and hyper from each
side's accept probability against the shared coin, swaps as recorded);
each group's final (eps, L), and ``final_step_size`` and
``final_leapfrog``, their means. The per-epoch acceptance slices after
burn-in agree to atol 1e-3 and the recorded samples to rtol 1e-3 / atol
1e-4, the tolerances of the three-epoch test.

The runs stop at epoch 28. Run on to 48 epochs (``JAX_PLATFORMS=cpu
PYTHONPATH=. python3 tests/test_torch_driver_parity.py`` prints it), the
first MH decision to differ is at epoch 32 in the G = 4 run (chain 7,
(eps, L) = (0.0135, 30)) and at epoch 30 in the tempered one (hot chain
6, (0.0155, 30)). That is the leapfrog near its stability edge, not a
fault of either driver: by then the two packages' float32 roundings
have grown to 4.08e-3 (0.781 in the hot chain) between the chain's
starts, and from each start the port's plain
leapfrog gives the same log-accept ratio in float32 and in float64
(0.8477 / 0.8478 from the JAX start, -0.4858 / -0.4857 from the port's,
against a coin of -0.3998).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu.sampler.driver as j_driver
import tensorbnn_tpu_torch as T
import tensorbnn_tpu_torch.parallel.chains as t_chains
import tensorbnn_tpu_torch.sampler.driver as t_driver
import tensorbnn_tpu_torch.sampler.gibbs as t_gibbs
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws

torch.set_num_threads(1)

# the flagship's three tanh layers at a narrow width; ess_run's step-size
# grid, its leapfrog counts, burn-in and adapter cycles cut so that 28
# epochs hold the random phase (the cycle that ends at epoch 8), four
# GP-UCB updates a group (epochs 13, 18, 23 and 28) and a post-burn-in
# stretch sampled every second epoch
WIDTH = 5
EPOCHS, BURNIN, STEP = 28, 20, 2
MCMC = dict(step_size_start=2e-3, step_size_min=5e-4, step_size_max=2e-2,
            step_size_options=40, leapfrog_start=10, leapfrog_min=5,
            leapfrog_max=30, leapfrog_increment=5, hyper_step_size=1e-3,
            hyper_leapfrog=10, burnin=BURNIN, averaging_steps=5,
            random_steps=2)
# (n_chains cold, n_adapters, tempering): G = 4 with 2 chains a group, and
# two rungs of 4 chains with one adapter a rung
CASES = {"g4": (8, 4, 1), "tempered": (4, 1, 2)}


def _narrow_flagship():
    j_layers, t_layers = [], []
    widths = [(1, WIDTH), (WIDTH, WIDTH), (WIDTH, WIDTH), (WIDTH, 1)]
    for i, (a, b) in enumerate(widths):
        j_layers.append(J.GaussianDenseLayer(a, b))
        t_layers.append(T.GaussianDenseLayer(a, b))
        if i < len(widths) - 1:
            j_layers.append(J.Tanh())
            t_layers.append(T.Tanh())
    x = np.linspace(-2, 2, 11).astype(np.float32)[:, None]
    y = (np.sin(x[:, 0] * math.pi * 2) * x[:, 0]
         - np.cos(x[:, 0] * math.pi)).astype(np.float32)
    return (JSequential(j_layers), J.FixedGaussianLikelihood(sd=0.1),
            TSequential(t_layers), T.FixedGaussianLikelihood(sd=0.1), x, y)


def _jax_epoch_draws(keys, d, h, tempered):
    """One JAX epoch's draws from its per-chain keys, and the keys the
    next epoch starts from."""
    n = 4 if tempered else 3
    ks = jax.vmap(lambda k: jax.random.split(k, n))(keys)

    def block(k, dim):
        k2 = jax.vmap(jax.random.split)(k)
        mom = jax.vmap(lambda kk: jax.random.normal(kk, (dim,),
                                                    jnp.float32))(k2[:, 0])
        return mom, jnp.log(jax.vmap(lambda kk: jax.random.uniform(
            kk, (), jnp.float32))(k2[:, 1]))

    mm, ml = block(ks[:, 1], d)
    hm, hl = block(ks[:, 2], h)
    swap = (jnp.log(jax.vmap(lambda kk: jax.random.uniform(kk, ()))(
        ks[:, 3])) if tempered else None)
    draws = EpochDraws(*(None if a is None else torch.tensor(np.asarray(a))
                         for a in (mm, ml, hm, hl, swap)))
    return draws, ks[:, 0]


def _recording(make_runner, calls, jax_side):
    """``make_runner`` whose runners record each chunk's (eps, L, length)
    and per-chain trace as numpy."""
    def make(*args, **kwargs):
        run = make_runner(*args, **kwargs)

        def wrapped(*a, **k):
            if jax_side:    # (carry, x, y, eps, leap, n)
                eps, leap, n = a[3], a[4], a[-1]
            else:           # (carry, eps, leap, n, generator)
                eps, leap, n = a[1], a[2], a[3]
            carry, trace = run(*a, **k)
            calls.append(dict(
                eps=np.asarray(eps, np.float32), leap=np.asarray(leap),
                n=int(n), **{f: np.asarray(getattr(trace, f))
                             for f in ("theta", "eta", "main_accept",
                                       "hyper_accept", "swap_accept")
                             if getattr(trace, f) is not None}))
            return carry, trace
        wrapped.runner = getattr(run, "runner", None)
        return wrapped
    return make


def _stack(calls, field):
    return np.concatenate([c[field] for c in calls])


def run_pair(case: str, epochs: int = EPOCHS) -> dict:
    """Both drivers over ``epochs`` epochs of ``CASES[case]``, the port on
    the JAX package's draws: each side's ``RunResult`` and recorded chunks,
    the draws, and each JAX group's final (eps, L)."""
    n_chains, n_adapters, tempering = CASES[case]
    j_model, j_lik, t_model, t_lik, x, y = _narrow_flagship()
    params, hypers = j_model.init(jax.random.key(0))
    kw = dict(epochs=epochs, sampling_step=STEP, n_chains=n_chains,
              n_adapters=n_adapters, chain_jitter=0.05, tempering=tempering,
              tempering_beta_min=0.5, verbose=False)
    mp = pytest.MonkeyPatch()
    try:
        j_calls, j_init, j_adapters = [], [], []
        real_init = j_driver.init_multichain_state
        real_adapter = j_driver.MCMCConfig.make_adapter
        mp.setattr(j_driver.MCMCConfig, "make_adapter",
                   lambda self, seed=None: j_adapters.append(
                       real_adapter(self, seed)) or j_adapters[-1])
        mp.setattr(j_driver, "init_multichain_state",
                   lambda *a, **k: j_init.append(real_init(*a, **k))
                   or j_init[-1])
        mp.setattr(j_driver, "make_multichain_chunk_runner", _recording(
            j_driver.make_multichain_chunk_runner, j_calls, True))
        j_res = j_driver.sample_posterior(
            j_model, j_lik, x, y, config=j_driver.MCMCConfig(**MCMC),
            params=params, hypers=hypers, key=jax.random.key(1),
            keep_samples=True, **kw)

        carry0 = j_init[0]
        c, d = carry0.theta.shape
        h = carry0.eta.shape[1]
        draws, keys = [], carry0.key
        for _ in range(epochs):
            got, keys = _jax_epoch_draws(keys, d, h, tempering > 1)
            draws.append(got)
        feed = iter(draws)

        def jax_draws(generator, c_, d_, h_, dtype, device, tempered):
            assert (c_, d_, h_, tempered) == (c, d, h, tempering > 1)
            return next(feed)

        mp.setattr(t_chains, "draw_epoch", jax_draws)
        mp.setattr(t_gibbs, "draw_epoch", jax_draws)
        mp.setattr(t_driver, "init_multichain_state",
                   lambda *a, **k: ChainState(*(
                       torch.tensor(np.asarray(getattr(carry0, f)))
                       for f in ChainState._fields)))
        t_calls = []
        mp.setattr(t_driver, "make_multichain_chunk_runner", _recording(
            t_driver.make_multichain_chunk_runner, t_calls, False))
        t_params, t_hypers, _ = convert.from_jax(params, hypers, {})
        t_res = t_driver.sample_posterior(
            t_model, t_lik, torch.tensor(x), torch.tensor(y),
            config=t_driver.MCMCConfig(**MCMC), params=t_params,
            hypers=t_hypers, generator=torch.Generator().manual_seed(0),
            **kw)
        assert next(feed, None) is None, "the port drew fewer epochs"
    finally:
        mp.undo()
    # each JAX group's final answer, as its driver reads it (driver.py:
    # 1306-1309)
    j_groups = [(float(np.clip(a.current_e, 1e-12, None)), int(a.current_l))
                for a in j_adapters]
    return dict(case=case, j=j_res, t=t_res, j_calls=j_calls,
                t_calls=t_calls, draws=draws, j_groups=j_groups,
                n_adapters=max(n_adapters, tempering), model=t_model,
                lik=t_lik, x=x, y=y, params=params, hypers=hypers)


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    return run_pair(request.param)


def test_port_ran_its_main_path(runs):
    assert runs["t"].main_path == "K1" and runs["t"].fused_hyper
    assert runs["t"].n_epochs == runs["j"].n_epochs == EPOCHS


def test_each_group_chooses_the_same_step_and_leapfrog(runs):
    """Every chunk has the same length on both sides, and every chain the
    same (eps, L), so every group's GP-UCB choice is the same; the run
    holds the random phase and at least two GP-UCB updates a group."""
    j_calls, t_calls = runs["j_calls"], runs["t_calls"]
    assert [c["n"] for c in t_calls] == [c["n"] for c in j_calls]
    n_grp = runs["n_adapters"]
    choices = []
    for jc, tc in zip(j_calls, t_calls):
        # per-chain vectors on both sides: each group's (eps, L) repeated
        # over its chains, groups in chain order
        np.testing.assert_array_equal(tc["eps"], jc["eps"])
        np.testing.assert_array_equal(tc["leap"], jc["leap"])
        choices.append(np.stack([jc["eps"], jc["leap"]]).reshape(
            2, n_grp, -1)[:, :, 0])
    assert len(runs["j_groups"]) == n_grp
    assert list(zip(runs["t"].group_step_size,
                    runs["t"].group_leapfrog)) == runs["j_groups"]
    assert runs["t"].final_step_size == runs["j"].final_step_size
    assert runs["t"].final_leapfrog == runs["j"].final_leapfrog
    # the chunks after the first random cycle: each group's (eps, L)
    # changed at least twice more, by its GP-UCB update
    changes = (np.diff(np.stack(choices), axis=0) != 0).any(axis=1)
    assert len(t_calls) >= 4
    assert (changes[1:].sum(axis=0) >= 2).all(), changes


def test_every_mh_decision_is_the_same(runs):
    """Main and hyper decisions from each side's accept probability
    against the shared coin, swap decisions as recorded."""
    draws = runs["draws"]
    for block, log_u in (("main_accept", "main_log_u"),
                         ("hyper_accept", "hyper_log_u")):
        u = np.stack([getattr(dr, log_u).numpy() for dr in draws])
        with np.errstate(divide="ignore"):
            j_dec = u < np.log(_stack(runs["j_calls"], block))
            t_dec = u < np.log(_stack(runs["t_calls"], block))
        bad = np.argwhere(j_dec != t_dec)
        assert not bad.size, f"{block}: (epoch, chain) {bad[:5].tolist()}"
        assert 0 < t_dec.mean() < 1, block
    if runs["case"] == "tempered":
        j_sw = _stack(runs["j_calls"], "swap_accept")
        np.testing.assert_array_equal(_stack(runs["t_calls"],
                                             "swap_accept"), j_sw)
        assert j_sw.any()


def test_acceptance_slices_and_samples_match(runs):
    j_res, t_res = runs["j"], runs["t"]
    for field in ("main_accept", "hyper_accept"):
        got, want = (getattr(r, field)[BURNIN:] for r in (t_res, j_res))
        assert got.shape == want.shape == (EPOCHS - BURNIN,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                   err_msg=field)
    if runs["case"] == "tempered":
        np.testing.assert_array_equal(t_res.swap_accept_rung,
                                      j_res.swap_accept_rung)
    assert t_res.theta_samples.shape == j_res.theta_samples.shape
    assert t_res.theta_samples.shape[0] == (EPOCHS - BURNIN) // STEP
    np.testing.assert_allclose(t_res.theta_samples, j_res.theta_samples,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(t_res.eta_samples, j_res.eta_samples,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(t_res.final_hyper_step,
                               j_res.final_hyper_step, rtol=1e-4)


def test_seed_band_and_the_jax_seed_lines():
    """``chip_smoke.seed_band`` against the hand-computed band, and the
    JAX package's seed lines (``jax_reference_stats.py quality``): seeds
    11-15, every statistic the band reads, each group's final (eps, L)
    whose means are the fleet's ``final_step_size`` / ``final_leapfrog``
    as the JAX driver reports them."""
    import chip_smoke as cs

    port = [{k: v for k in cs.G4_BAND} for v in (1.0, 2.0, 3.0)]
    ref = [{k: v for k in cs.G4_BAND} for v in (4.0, 6.0)]
    for got in cs.seed_band(port, ref).values():
        np.testing.assert_allclose(
            [got["port_mean"], got["port_sd"], got["jax_mean"],
             got["jax_sd"], got["z"]],
            [2.0, 1.0, 5.0, math.sqrt(2.0), 3.0 / math.sqrt(4.0 / 3.0)],
            rtol=1e-12)
    assert set(cs.G4_GATED) <= set(cs.G4_BAND)
    assert [line["seed"] for line in cs.G4_JAX_SEEDS] == list(range(11, 16))
    assert cs.G4_SEEDS == tuple(range(11, 21))
    for line in cs.G4_JAX_SEEDS:
        assert set(cs.G4_BAND) <= set(line)
        eps, steps = line["group_step_size"], line["group_leapfrog"]
        assert len(eps) == len(steps) == 4
        assert line["final_step_size"] == pytest.approx(np.mean(eps))
        assert line["final_leapfrog"] == round(np.mean(steps))


def first_flip(case: str, epochs: int = 48) -> None:
    """Runs ``case`` past the cut and prints the first MH decision that
    differs: its epoch, chain, (eps, L), coin and each side's log-accept
    ratio, and that ratio recomputed by the port's plain leapfrog in
    float32 and float64 from each package's start of that epoch (the
    reason for the cut at ``EPOCHS``)."""
    from tensorbnn_tpu_torch.sampler.hmc import leapfrog_batched
    from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
        make_potentials

    r = run_pair(case, epochs)
    u = np.stack([dr.main_log_u.numpy() for dr in r["draws"]])
    with np.errstate(divide="ignore"):
        lar = {k: np.log(_stack(r[k + "_calls"], "main_accept"))
               for k in "jt"}
    flips = np.argwhere((u < lar["j"]) != (u < lar["t"]))
    if not flips.size:
        print(f"{case}: no main decision differs in {epochs} epochs")
        return
    e, ch = flips[0]
    eps, steps = (np.concatenate([np.tile(c[f], (c["n"], 1))
                                  for c in r["j_calls"]])[e, ch]
                  for f in ("eps", "leap"))
    print(f"{case}: first main decision to differ at epoch {e + 1}, chain "
          f"{ch}, (eps, L) = ({eps:.4g}, {int(steps)}): coin {u[e, ch]:.4f},"
          f" log-accept ratio JAX {lar['j'][e, ch]:.4f}, port "
          f"{lar['t'][e, ch]:.4f}")
    mom = r["draws"][e].main_momenta[ch:ch + 1]
    for k in "jt":
        th = _stack(r[k + "_calls"], "theta")[e - 1, ch:ch + 1]
        et = _stack(r[k + "_calls"], "eta")[e - 1, ch:ch + 1]
        diff = np.abs(th - _stack(r["t_calls" if k == "j" else "j_calls"],
                                  "theta")[e - 1, ch:ch + 1]).max()
        got = []
        for dtype in (torch.float32, torch.float64):
            flat = flatten_state(*convert.from_jax(r["params"], r["hypers"],
                                                   {}, dtype=dtype))
            pot = make_potentials(r["model"], r["lik"],
                                  torch.tensor(r["x"], dtype=dtype),
                                  torch.tensor(r["y"], dtype=dtype),
                                  flat.unravel_theta, flat.unravel_eta)
            et_d = torch.tensor(et, dtype=dtype)
            # the chain's rung of the ladder (cold first, beta_min 0.5)
            n_cold, _, n_rungs = CASES[case]
            beta = torch.tensor([0.5 ** ((ch // n_cold) / max(n_rungs - 1,
                                                              1))],
                                dtype=dtype)
            vg = lambda q: pot.main_vg_t(q, et_d, beta)  # noqa: E731
            q0, m = torch.tensor(th, dtype=dtype), mom.to(dtype)
            lp0, _ = vg(q0)
            _, v, lp1, _ = leapfrog_batched(vg, q0, m, float(eps),
                                            int(steps))
            got.append(float((lp1 - lp0) + 0.5 * (m * m).sum()
                             - 0.5 * (v * v).sum()))
        print(f"  from the {'JAX' if k == 'j' else 'port'} start (max "
              f"|theta difference| {diff:.3g}): log-accept ratio "
              f"{got[0]:.4f} in float32, {got[1]:.4f} in float64")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/test_torch_driver_parity.py
    for name in sorted(CASES):
        first_flip(name)
