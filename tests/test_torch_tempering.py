"""Parallel tempering and the ESS diagnostics of the torch port against the
JAX package: the ladder, the replica swap, the tempered potentials, two
injected-draw tempered epochs, the driver's tempered runs, and the copied
``autocorr`` / ``diagnostics`` modules.

torch's generators cannot reproduce JAX's threefry streams, so the swap and
epoch tests compute the JAX package's own draws from its chain keys (a
tempered epoch splits each key in four, gibbs.py:163-166; the swap draws
one uniform per replica, tempering.py:101) and hand them to the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.parallel.chains import init_multichain_state as j_init
from tensorbnn_tpu.sampler import tempering as j_tempering
from tensorbnn_tpu.sampler.gibbs import make_epoch_fn as j_epoch
from tensorbnn_tpu.sampler.hyper_stats import make_stats_hyper as j_stats
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu.utils import autocorr as j_autocorr
from tensorbnn_tpu.utils import diagnostics as j_diag
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops.fused_hyper import \
    try_build_fused_hyper_trajectory
from tensorbnn_tpu_torch.ops.fused_mlp import try_build_fused_trajectory
from tensorbnn_tpu_torch.sampler import tempering as t_tempering
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws, \
    make_epoch_fn as t_epoch
from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper as \
    t_stats
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials
from tensorbnn_tpu_torch.utils import autocorr as t_autocorr
from tensorbnn_tpu_torch.utils import diagnostics as t_diag

torch.set_num_threads(1)


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def _pair(widths, lik=("FixedGaussianLikelihood", 0.1)):
    j_layers, t_layers = [], []
    for i, (a, b) in enumerate(widths):
        j_layers.append(J.GaussianDenseLayer(a, b))
        t_layers.append(T.GaussianDenseLayer(a, b))
        if i < len(widths) - 1:
            j_layers.append(J.Tanh())
            t_layers.append(T.Tanh())
    name, sd = lik
    return (JSequential(j_layers), getattr(J, name)(sd=sd),
            TSequential(t_layers), getattr(T, name)(sd=sd))


FLAGSHIP = [(1, 10), (10, 10), (10, 10), (10, 1)]


# ---------------------------------------------------------------------------
# ladder and swap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rungs,beta_min", [(2, 0.5), (4, 0.5), (4, 0.1),
                                              (6, 0.01)])
def test_ladder_matches_jax(n_rungs, beta_min):
    got = t_tempering.make_ladder(n_rungs, beta_min)
    want = j_tempering.make_ladder(n_rungs, beta_min)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rungs,beta_min,match", [
    (1, 0.1, "n_rungs"), (4, 1.0, "beta_min"), (4, 0.0, "beta_min")])
def test_ladder_validation_matches_jax(n_rungs, beta_min, match):
    for make in (t_tempering.make_ladder, j_tempering.make_ladder):
        with pytest.raises(ValueError, match=match):
            make(n_rungs, beta_min)


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_matches_jax(parity):
    """K = 4 rungs of C = 3 chains: the port's swap, fed the uniforms that
    JAX's make_swap_fn draws from its keys, exchanges exactly the same
    states. The log-likelihoods are spread so that some pairs swap and
    some do not."""
    k, c, d, h = 4, 3, 5, 2
    rng = np.random.default_rng(parity)
    theta = rng.normal(size=(k * c, d)).astype(np.float32)
    eta = rng.normal(size=(k * c, h)).astype(np.float32)
    ll = (10.0 * rng.normal(size=(k * c,))).astype(np.float32)
    ladder = j_tempering.make_ladder(k, 0.3)
    keys = jax.vmap(jax.random.key)(jnp.arange(10, 10 + k * c))
    j_th, j_et, j_acc = j_tempering.make_swap_fn(jnp.asarray(ladder), k)(
        keys, jnp.asarray(theta), jnp.asarray(eta), jnp.asarray(ll), parity)
    log_u = np.log(np.asarray(jax.vmap(
        lambda kk: jax.random.uniform(kk, ()))(keys)))
    swap = t_tempering.make_swap_fn(torch.tensor(ladder), k)
    for p in (parity, torch.tensor(parity)):     # host int or device tensor
        t_th, t_et, t_acc = swap(torch.tensor(theta), torch.tensor(eta),
                                 torch.tensor(ll), p, torch.tensor(log_u))
        np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
        np.testing.assert_array_equal(t_th.numpy(), np.asarray(j_th))
        np.testing.assert_array_equal(t_et.numpy(), np.asarray(j_et))
    acc = t_acc.numpy().reshape(k, c)
    assert 0 < acc.sum() < acc.size - (2 * c if parity else 0)
    if parity:      # rungs 0 and K - 1 have no partner at odd parity
        assert not acc[0].any() and not acc[-1].any()


# ---------------------------------------------------------------------------
# tempered potentials
# ---------------------------------------------------------------------------

def _states(j_model, j_lik, c=4, seed=0):
    params, hypers = j_model.init(jax.random.key(seed))
    lik_h = j_lik.init_hypers()
    flat = j_flatten(params, hypers, lik_h)
    rng = np.random.default_rng(seed + 1)
    thetas = (np.asarray(flat.theta)[None]
              + 0.3 * rng.normal(size=(c, flat.theta.size))).astype(
                  np.float32)
    etas = (np.asarray(flat.eta)[None]
            + 0.05 * rng.normal(size=(c, flat.eta.size))).astype(np.float32)
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    return flat, t_flat, thetas, etas


@pytest.mark.parametrize("lik", [("FixedGaussianLikelihood", 0.1),
                                 ("GaussianLikelihood", 0.1)])
def test_tempered_potentials_match_jax(lik):
    """``main_vg_t``, ``hyper_vg_t`` and ``loglik`` at the flagship and the
    learned-sd flagship, betas from 1 down to 0.05. Values to rtol 1e-5 /
    atol 1e-4; gradients the same plus one float32 ulp of the largest
    element (~2e3 here), the rounding a near-zero element keeps from the
    large products summed into it in another order."""
    j_model, j_lik, t_model, t_lik = _pair(FLAGSHIP, lik)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(11, 1)).astype(np.float32)
    y = rng.normal(size=(11,)).astype(np.float32)
    flat, t_flat, thetas, etas = _states(j_model, j_lik)
    betas = np.asarray([1.0, 0.5, 0.2, 0.05], np.float32)
    jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      flat.unravel_theta, flat.unravel_eta)
    tp = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta)
    th, et, bt = torch.tensor(thetas), torch.tensor(etas), torch.tensor(betas)
    for name, j_args, t_args in (
            ("main_vg_t", (thetas, etas, betas), (th, et, bt)),
            ("hyper_vg_t", (etas, thetas, betas), (et, th, bt))):
        jv, jg = jax.jit(jax.vmap(getattr(jp, name)))(*j_args)
        tv, tg = getattr(tp, name)(*t_args)
        _close(tv, jv, 1e-5, 1e-4, name)
        ulp = float(np.spacing(np.float32(np.abs(np.asarray(jg)).max())))
        _close(tg, jg, 1e-5, 1e-4 + ulp, name)
    _close(tp.loglik(th, et), jax.jit(jax.vmap(jp.loglik))(thetas, etas),
           1e-5, 1e-4)
    # beta = 1 is the untempered posterior
    _close(tp.main_vg_t(th, et, torch.ones(4))[0], tp.main_vg(th, et)[0],
           1e-6, 1e-4)


def test_tempered_stats_hyper_matches_jax():
    """The coupled (learned-sd) stats potential's tempered variant: beta
    scales only the (R, K) likelihood term."""
    j_model, j_lik, t_model, t_lik = _pair(FLAGSHIP,
                                           ("GaussianLikelihood", 0.2))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(11, 1)).astype(np.float32)
    y = rng.normal(size=(11,)).astype(np.float32)
    flat, t_flat, thetas, etas = _states(j_model, j_lik, seed=3)
    betas = np.asarray([1.0, 0.3, 0.06, 0.01], np.float32)
    j_stats_fn, _, j_vg_t = j_stats(j_model, j_lik, jnp.asarray(x),
                                    jnp.asarray(y), flat.unravel_eta,
                                    flat.eta.size)
    t_stats_fn, t_vg, t_vg_t = t_stats(t_model, t_lik, torch.tensor(x),
                                       torch.tensor(y), t_flat.unravel_theta,
                                       t_flat.unravel_eta, t_flat.eta.numel())
    js = j_stats_fn(jax.vmap(flat.unravel_theta)(thetas))
    ts = t_stats_fn(torch.tensor(thetas))
    jv, jg = j_vg_t(etas, js, betas)
    tv, tg = t_vg_t(torch.tensor(etas), ts, torch.tensor(betas))
    _close(tv, jv, 1e-5, 1e-2)
    _close(tg, jg, 1e-4, 1e-2)
    # and equal to the generic tempered hyper potential of the port
    tp = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta)
    gv, gg = tp.hyper_vg_t(torch.tensor(etas), torch.tensor(thetas),
                           torch.tensor(betas))
    _close(tv, gv, 1e-5, 1e-2)
    _close(tg, gg, 1e-4, 1e-2)
    # beta = 1 is the untempered stats potential
    uv, _ = t_vg(torch.tensor(etas), ts)
    _close(t_vg_t(torch.tensor(etas), ts, torch.ones(4))[0], uv, 0.0, 0.0)


# ---------------------------------------------------------------------------
# two tempered epochs with the JAX package's draws
# ---------------------------------------------------------------------------

def _jax_tempered_draws(keys, d, h):
    """The draws one tempered JAX epoch takes from its per-chain keys:
    each key splits in four (carry, main, hyper, swap); the blocks split
    theirs into (momentum, MH coin); the swap draws one uniform."""
    keys4 = jax.vmap(lambda k: jax.random.split(k, 4))(keys)

    def block(k, dim):
        k2 = jax.vmap(lambda kk: jax.random.split(kk))(k)
        mom = jax.vmap(lambda kk: jax.random.normal(
            kk, (dim,), jnp.float32))(k2[:, 0])
        log_u = jnp.log(jax.vmap(lambda kk: jax.random.uniform(
            kk, (), jnp.float32))(k2[:, 1]))
        return torch.tensor(np.asarray(mom)), torch.tensor(np.asarray(log_u))

    mm, ml = block(keys4[:, 1], d)
    hm, hl = block(keys4[:, 2], h)
    sl = np.log(np.asarray(jax.vmap(
        lambda kk: jax.random.uniform(kk, ()))(keys4[:, 3])))
    return EpochDraws(mm, ml, hm, hl, torch.tensor(sl))


@pytest.mark.parametrize("path", ["plain", "K1"])
def test_two_tempered_epochs_match_jax_with_injected_draws(path):
    """Two tempered epochs (K = 3 rungs of C = 2 chains, a 1-6-1 tanh net,
    per-rung (eps, L)) of the port, on its plain path or on the K1 and K2
    twins, against two of the JAX package's ``make_epoch_fn
    (tempering_beta=...)`` (its XLA path), from one state and with JAX's
    own draws, the swap's included. Epoch 1 swaps at parity 0, epoch 2 at
    parity 1. Tolerances as in test_torch_sampler.py's three-epoch test;
    the swap decisions are equal."""
    k, c = 3, 2
    j_model, j_lik, t_model, t_lik = _pair([(1, 6), (6, 1)])
    x = np.linspace(-1, 1, 9).astype(np.float32)[:, None]
    y = np.sin(np.pi * x[:, 0]).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    d, h = flat.theta.size, flat.eta.size
    ladder = j_tempering.make_ladder(k, 0.3)
    tempering_beta = (k, np.repeat(ladder, c))
    kw = dict(adjust_hypers=True, hyper_leapfrog=6, burnin=100.0,
              mu=math.log(100 * 1e-3), eta_dim=h,
              tempering_beta=tempering_beta)
    j_fn = jax.jit(j_epoch(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                           flat.unravel_theta, flat.unravel_eta, **kw))
    t_flat = t_flatten(*convert.from_jax(params, hypers, {}))
    xt, yt = torch.tensor(x), torch.tensor(y)
    fused = {}
    if path == "K1":
        fused = dict(
            batched_main_traj=try_build_fused_trajectory(
                t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt,
                yt, h, tempered=True),
            batched_hyper_traj=try_build_fused_hyper_trajectory(
                t_model, t_lik, t_flat.unravel_eta, h, 6))
        assert None not in fused.values()
    t_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                   t_flat.unravel_eta, **fused, **kw)

    j_carry = j_init(flat.theta, flat.eta, jax.random.key(1), 1e-3, k * c,
                     jitter=0.3)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))
    eps = np.repeat(np.asarray([5e-3, 1e-2, 2e-2], np.float32), c)
    steps = np.repeat([9, 6, 4], c)
    swaps = []
    for _ in range(2):
        draws = _jax_tempered_draws(j_carry.key, d, h)
        j_carry, j_tr = j_fn(j_carry, jnp.asarray(eps),
                             jnp.asarray(steps, jnp.int32))
        t_carry, t_tr = t_fn(t_carry, torch.tensor(eps), steps, None,
                             draws=draws)
        for field, rtol, atol in (("theta", 1e-3, 1e-4),
                                  ("eta", 1e-3, 1e-4),
                                  ("hyper_step", 1e-4, 0.0)):
            _close(getattr(t_carry, field), getattr(j_carry, field), rtol,
                   atol, field)
        for field in ("main_accept", "hyper_accept", "sjd"):
            _close(getattr(t_tr, field), getattr(j_tr, field), 1e-3, 1e-3,
                   field)
        np.testing.assert_array_equal(t_tr.swap_accept.numpy(),
                                      np.asarray(j_tr.swap_accept))
        swaps.append(t_tr.swap_accept.numpy())
    # the draws make both parities exchange something
    assert swaps[0].any() and swaps[1].any(), swaps


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _trig_net(seed=0):
    """tests/test_tempering.py's 1-1-1 tanh net and sampler settings."""
    x = np.linspace(-1, 1, 8).astype(np.float32)
    y = (2.0 * np.tanh(3.0 * x)).astype(np.float32)
    net = T.Network(np.float32, 1, x, y, x, y, seed=seed, device="cpu")
    net.add(T.GaussianDenseLayer(1, 1)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(1, 1))
    net.setup_mcmc(step_size_start=5e-3, step_size_min=1e-3,
                   step_size_max=5e-2, step_size_options=10,
                   leapfrog_start=5, leapfrog_min=2, leapfrog_max=10,
                   leapfrog_increment=1, hyper_step_size=1e-2,
                   hyper_leapfrog=5, burnin=20, averaging_steps=5,
                   random_steps=2)
    return net


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_chains=4, tempering=2, n_adapters=2), "n_adapters"),
    (dict(n_chains=4, tempering=2, trajectory="uturn"), "uturn"),
    (dict(n_chains=8, tempering=2, precondition=5), "precondition"),
    (dict(n_chains=4, tempering=2, state_layout="tree"), "flat state"),
    (dict(n_chains=4, tempering=0), ">= 1"),
])
def test_tempering_validation_matches_jax(kwargs, match):
    """The JAX driver's tempering errors (driver.py:495-531,
    tests/test_tempering.py:169-186), raised by the port even for options
    it does not carry otherwise."""
    lik = T.FixedGaussianLikelihood(sd=0.1)
    with pytest.raises(ValueError, match=match):
        _trig_net().train(10, 2, lik, verbose=False, **kwargs)


def test_tempered_run_records_cold_chains_and_swap_rates(monkeypatch):
    """A tempered run on the K1 twin: cold-chain samples, per-epoch swap
    rates (fleet and per rung), the diagnostics; K3 is never built."""
    from tensorbnn_tpu_torch.ops import fused_mlp

    def no_k3(*args, **kwargs):
        raise AssertionError("K3 built for a tempered run")
    monkeypatch.setattr(fused_mlp, "try_build_fused_main_vg", no_k3)
    res = _trig_net().train(40, 2, T.FixedGaussianLikelihood(sd=0.1),
                            n_chains=4, tempering=3, chain_jitter=0.1,
                            verbose=False)
    assert res.main_path == "K1" and res.fused_hyper
    assert res.theta_samples.shape == (10, 4, 4)
    assert res.swap_accept.shape == (40,) and res.swap_accept.sum() > 0
    assert res.swap_accept_rung.shape == (40, 3)
    np.testing.assert_allclose(res.swap_accept_rung.mean(axis=1),
                               res.swap_accept, rtol=0, atol=1e-12)
    assert res.sjd.shape == res.main_accept.shape == (40,)
    assert res.split_rhat().shape == (4,)
    assert float(res.multichain_ess()) > 0
    assert res.summary().param_index.size == 4


def test_tempered_learned_sd_takes_the_plain_blocks():
    """A tempered learned-sd run: the main block takes tempered K1 (variant
    (d) reads the learned sd), and K2 does not take a tempered coupled
    likelihood, so the hyper block runs plain, as in the JAX package."""
    x = np.linspace(-1, 1, 9).astype(np.float32)
    y = np.sin(x * np.pi).astype(np.float32)
    net = T.Network(np.float32, 1, x, y, x, y, seed=21, device="cpu")
    net.add(T.GaussianDenseLayer(1, 6)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(6, 1))
    net.setup_mcmc(step_size_start=1e-3, leapfrog_start=8, leapfrog_min=4,
                   leapfrog_max=16, burnin=10, averaging_steps=5,
                   hyper_leapfrog=6, random_steps=1)
    res = net.train(12, 4, T.GaussianLikelihood(sd=0.1), n_chains=2,
                    tempering=3, tempering_beta_min=0.05, verbose=False)
    assert res.main_path == "K1" and not res.fused_hyper
    assert np.isfinite(res.theta_samples).all()
    assert res.swap_accept_rung.shape == (12, 3)


def test_tempered_posterior_matches_plain_on_unimodal_target():
    """tests/test_tempering.py:189 on the port: on a unimodal posterior
    (a linear model) the cold rung of a tempered run reproduces the plain
    sampler's posterior mean and spread."""
    x = np.linspace(-1, 1, 12).astype(np.float32)
    y = (0.8 * x + 0.1).astype(np.float32)

    def build(seed):
        net = T.Network(np.float32, 1, x, y, x, y, seed=seed, device="cpu")
        net.add(T.GaussianDenseLayer(1, 1))
        net.setup_mcmc(step_size_start=1e-2, step_size_min=2e-3,
                       step_size_max=8e-2, step_size_options=10,
                       leapfrog_start=5, leapfrog_min=2, leapfrog_max=10,
                       leapfrog_increment=1, hyper_step_size=1e-2,
                       hyper_leapfrog=5, burnin=60, averaging_steps=10,
                       random_steps=3)
        return net

    lik = T.FixedGaussianLikelihood(sd=0.1)
    res_plain = build(1).train(400, 2, lik, n_chains=8, chain_jitter=0.1,
                               verbose=False)
    res_temp = build(2).train(400, 2, lik, n_chains=8, tempering=3,
                              chain_jitter=0.1, verbose=False)
    assert res_temp.main_path == "K1"
    th_p = res_plain.theta_samples.reshape(-1, 2)
    th_t = res_temp.theta_samples.reshape(-1, 2)
    np.testing.assert_allclose(th_t.mean(axis=0), th_p.mean(axis=0),
                               atol=0.08)
    np.testing.assert_allclose(th_t.std(axis=0), th_p.std(axis=0),
                               atol=0.08)


# ---------------------------------------------------------------------------
# autocorr and diagnostics: copies of the JAX package's modules
# ---------------------------------------------------------------------------

def _ar1(n, c, k, phi=0.8, seed=0):
    """(n, c, k) AR(1) series with coefficient ``phi``."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, c, k))
    out = np.empty_like(z)
    out[0] = z[0]
    for t in range(1, n):
        out[t] = phi * out[t - 1] + z[t]
    return out


@pytest.mark.parametrize("name", ["integrated_time", "effective_sample_size",
                                  "integrated_time_batch",
                                  "effective_sample_size_batch"])
def test_autocorr_matches_jax(name):
    series = _ar1(400, 6, 1, seed=1)[:, :, 0].T             # (chains, n)
    series[2] = 1.5                                          # constant: NaN
    if name.endswith("_batch"):
        got, want = (getattr(m, name)(series) for m in (t_autocorr,
                                                        j_autocorr))
    else:
        # quiet: these chains are shorter than tol x tau
        kw = {"quiet": True} if name == "integrated_time" else {}
        got = [getattr(t_autocorr, name)(s, **kw) for s in series]
        want = [getattr(j_autocorr, name)(s, **kw) for s in series]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(RuntimeError, match="too short"):
        t_autocorr.integrated_time(series[0][:20])


@pytest.mark.parametrize("max_params", [256, 5])
def test_diagnostics_match_jax(max_params):
    samples = _ar1(300, 4, 12, phi=0.6, seed=2)
    samples[:, :, 3] = 0.25                                  # a frozen coordinate
    got, want = (m.split_rhat(samples) for m in (t_diag, j_diag))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    got, want = (m.multichain_ess(samples, max_params=max_params)
                 for m in (t_diag, j_diag))
    np.testing.assert_allclose(got.per_param, want.per_param, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(got.param_index, want.param_index)
    assert (float(got), got.median, got.argmin) == (float(want), want.median,
                                                    want.argmin)
    assert repr(got) == repr(want)
    got, want = (m.summary(samples, max_params=max_params)
                 for m in (t_diag, j_diag))
    for field in ("mean", "sd", "ess", "rhat"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-12, atol=1e-12)
    assert str(got) == str(want)
    assert (got.min_ess, got.max_rhat) == (want.min_ess, want.max_rhat)
