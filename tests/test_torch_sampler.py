"""The torch port's sampler against the JAX package: adapter, leapfrog,
three injected-draw epochs on K1 and on K3, and the Network facade and
driver on the CPU.

torch's generators cannot reproduce JAX's threefry streams, so the epoch
parity test computes the JAX package's own draws from its chain keys (as
gibbs.py:163-166, :175-199 and :241-255 derive them) and hands them to the
port's epoch.
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
from tensorbnn_tpu.ops.fused_mlp import try_build_fused_main_vg as \
    j_main_vg_build
from tensorbnn_tpu.parallel.chains import init_multichain_state as j_init
from tensorbnn_tpu.sampler.adapter import ParamAdapter as JAdapter
from tensorbnn_tpu.sampler.gibbs import make_epoch_fn as j_epoch
from tensorbnn_tpu.sampler.hmc import leapfrog_batched as j_leapfrog
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops.fused_hyper import \
    try_build_fused_hyper_trajectory
from tensorbnn_tpu_torch.ops.fused_mlp import try_build_fused_main_vg, \
    try_build_fused_trajectory
from tensorbnn_tpu_torch.sampler.adapter import ParamAdapter as TAdapter
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws, \
    make_epoch_fn as t_epoch
from tensorbnn_tpu_torch.sampler.hmc import hmc_step_batched, \
    leapfrog_batched as t_leapfrog
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials

torch.set_num_threads(1)


def _flagship():
    j_layers, t_layers = [], []
    widths = [(1, 10), (10, 10), (10, 10), (10, 1)]
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


def test_adapter_copy_matches_jax_package():
    kw = dict(e1=1e-3, L1=50, el=1e-4, eu=1e-2, e_number=40, Ll=20, Lu=200,
              l_step=5, m=5, k=6.0, random_steps=2, max_strikes=3, seed=4)
    ja, ta = JAdapter(**kw), TAdapter(**kw)
    rng = np.random.default_rng(0)
    sjds = np.abs(rng.normal(size=120)) * 1e-3
    sjds[60:70] = 0.0   # a run of dead epochs trips the strike reset
    for i, s in enumerate(sjds):
        arg = None if i == 0 else float(s)
        assert ja.epochs_until_next_change() == ta.epochs_until_next_change()
        assert ja.update(arg) == ta.update(arg)
    assert ja.n_resets == ta.n_resets


@pytest.mark.parametrize("per_chain", [False, True])
def test_plain_leapfrog_matches_jax(per_chain):
    j_model, j_lik, t_model, t_lik, x, y = _flagship()
    params, hypers = j_model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    t_flat = t_flatten(*convert.from_jax(params, hypers, {}))
    c = 4
    rng = np.random.default_rng(1)
    thetas = (0.3 * rng.normal(size=(c, flat.theta.size))).astype(np.float32)
    etas = np.tile(np.asarray(flat.eta), (c, 1))
    mom = rng.normal(size=thetas.shape).astype(np.float32)
    jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      flat.unravel_theta, flat.unravel_eta)
    tp = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta)
    if per_chain:
        eps = np.asarray([1e-2, 5e-3, 2e-3, 1e-2], np.float32)
        steps = np.asarray([9, 4, 1, 6])
        j_eps, t_eps = jnp.asarray(eps)[:, None], torch.tensor(eps)[:, None]
        j_l, t_l = jnp.asarray(steps, jnp.int32), steps
    else:
        j_eps = t_eps = 1e-2
        j_l, t_l = jnp.asarray(9, jnp.int32), 9
    jvg = jax.vmap(jp.main_vg)
    jq, jv, jlp, _ = j_leapfrog(lambda th: jvg(th, etas), thetas, mom,
                                j_eps, j_l)
    et = torch.tensor(etas)
    tq, tv, tlp, _ = t_leapfrog(lambda th: tp.main_vg(th, et),
                                torch.tensor(thetas), torch.tensor(mom),
                                t_eps, t_l)
    # tolerances of tests/test_fused_trajectory.py:72-79
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=1e-2)


def _jax_draws(keys, d, h):
    """The draws one JAX epoch takes from its per-chain keys
    (gibbs.py:163-166 splits each key in three; hmc_step_batched and the
    fused paths split the block keys into (momentum, MH coin))."""
    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(keys)

    def block(k, dim):
        k2 = jax.vmap(lambda kk: jax.random.split(kk))(k)
        mom = jax.vmap(lambda kk: jax.random.normal(
            kk, (dim,), jnp.float32))(k2[:, 0])
        log_u = jnp.log(jax.vmap(lambda kk: jax.random.uniform(
            kk, (), jnp.float32))(k2[:, 1]))
        return torch.tensor(np.asarray(mom)), torch.tensor(np.asarray(log_u))

    mm, ml = block(keys3[:, 1], d)
    hm, hl = block(keys3[:, 2], h)
    return EpochDraws(mm, ml, hm, hl)


@pytest.mark.parametrize("per_chain", [False, True])
def test_three_epochs_match_jax_with_injected_draws(per_chain):
    """Three epochs of the port (K1 and K2 through their CPU twins) against
    three of the JAX package (its XLA path), both from one state and with
    JAX's own draws. Tolerances: states to rtol 1e-3 / atol 1e-4 (the
    trajectory tolerances of tests/test_fused_trajectory.py), accept
    probabilities to atol 1e-3 (exp of a log-accept ratio whose float32
    rounding is ~1e-3 nats at |log p| ~ 1e3), hyper step sizes to rtol
    1e-4."""
    j_model, j_lik, t_model, t_lik, x, y = _flagship()
    params, hypers = j_model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    c, d, h = 4, flat.theta.size, flat.eta.size
    kw = dict(adjust_hypers=True, hyper_leapfrog=10, burnin=100.0,
              mu=math.log(100 * 1e-3), eta_dim=h)
    j_fn = jax.jit(j_epoch(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                           flat.unravel_theta, flat.unravel_eta, **kw))
    t_flat = t_flatten(*convert.from_jax(params, hypers, {}))
    xt, yt = torch.tensor(x), torch.tensor(y)
    main_traj = try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt, h)
    hyper_traj = try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, h, 10)
    assert main_traj is not None and hyper_traj is not None
    t_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                   t_flat.unravel_eta, batched_main_traj=main_traj,
                   batched_hyper_traj=hyper_traj, **kw)

    j_carry = j_init(flat.theta, flat.eta, jax.random.key(1), 1e-3, c,
                     jitter=0.05)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))
    if per_chain:
        eps = np.asarray([2e-3, 2e-3, 4e-3, 4e-3], np.float32)
        steps = np.asarray([8, 8, 5, 5])
        j_args = (jnp.asarray(eps), jnp.asarray(steps, jnp.int32))
        t_args = (torch.tensor(eps), steps)
    else:
        j_args = (jnp.asarray(3e-3, jnp.float32), jnp.asarray(8, jnp.int32))
        t_args = (3e-3, 8)
    for _ in range(3):
        draws = _jax_draws(j_carry.key, d, h)
        j_carry, j_tr = j_fn(j_carry, *j_args)
        t_carry, t_tr = t_fn(t_carry, *t_args, None, draws=draws)
        for field, rtol, atol in (("theta", 1e-3, 1e-4),
                                  ("eta", 1e-3, 1e-4),
                                  ("hyper_step", 1e-4, 0.0),
                                  ("log_eps_bar", 1e-4, 1e-5),
                                  ("h", 1e-4, 1e-5)):
            np.testing.assert_allclose(
                getattr(t_carry, field).numpy(),
                np.asarray(getattr(j_carry, field)), rtol=rtol, atol=atol,
                err_msg=field)
        for field in ("main_accept", "hyper_accept", "sjd"):
            np.testing.assert_allclose(
                getattr(t_tr, field).numpy(),
                np.asarray(getattr(j_tr, field)), rtol=1e-3, atol=1e-3,
                err_msg=field)


def _small_network(seed=0):
    x = np.linspace(-2, 2, 11).astype(np.float32)
    y = (np.sin(x * math.pi * 2) * x - np.cos(x * math.pi)).astype(
        np.float32)
    net = T.Network(np.float32, 1, x, y, x, y, seed=seed, device="cpu")
    net.add(T.GaussianDenseLayer(1, 6)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(6, 1))
    net.setupMCMC(burnin=20, leapfrogStart=10, leapfogMin=5, leapFrogMax=20,
                  leapfrogIncrement=5, averagingSteps=5, randomSteps=2,
                  hyperLeapfrog=10, stepSizeStart=2e-3, stepSizeMin=5e-4,
                  stepSizeMax=5e-3)
    return net


@pytest.mark.parametrize("n_chains,n_adapters", [(4, 1), (4, 2)])
def test_network_train_runs_on_cpu(n_chains, n_adapters):
    net = _small_network()
    res = net.train(40, 2, T.FixedGaussianLikelihood(sd=0.1),
                    n_chains=n_chains, n_adapters=n_adapters,
                    chain_jitter=0.05, verbose=False)
    assert res.fused_main and res.fused_hyper and res.main_path == "K1"
    assert res.theta_samples.shape == (10, n_chains, 6 + 6 + 1 + 6)
    assert np.isfinite(res.theta_samples).all()
    assert np.isfinite(res.eta_samples).all()
    acc = res.main_accept.mean()
    assert 0.0 < acc <= 1.0 and 0.0 < res.hyper_accept.mean() <= 1.0
    assert res.param_samples[0]["w"].shape == (10 * n_chains, 1, 6)
    assert len(res.leapfrog) == 40


def test_network_train_rejects_what_the_port_does_not_carry():
    net = _small_network()
    lik = T.FixedGaussianLikelihood(sd=0.1)
    # a mesh is carried (tests/test_torch_mesh.py)
    for option in (dict(max_dispatch_seconds=25.0),
                   dict(state_layout="tree"), dict(donate=True)):
        with pytest.raises(NotImplementedError, match=next(iter(option))):
            net.train(2, 1, lik, verbose=False, **option)
    with pytest.raises(TypeError, match="no_such_option"):
        net.train(2, 1, lik, verbose=False, no_such_option=1)
    with pytest.raises(RuntimeError, match="setup_mcmc"):
        T.Network(None, 1, [0.0], [0.0], [0.0], [0.0],
                  device="cpu").train(2, 1, lik)


def test_hyper_step_collapse_matches_jax():
    """``wide_deep``'s hyper schedule (hyper step 1e-4, 5 hyper leapfrog
    steps, burn-in 3) over 6 epochs of the learned-sd flagship, the port
    (K3 and K2 through their CPU twins) against the JAX package (its XLA
    path) with JAX's own draws: an all-accepting first epoch lets dual
    averaging lift the step ~100x (mu = log(100 x 1e-4)), the lifted step
    rejects every proposal, and the step freezes from epoch 3 (80% of
    burn-in). Both packages do this epoch for epoch. (A 4-16-16-1 model at
    sd 0.3 keeps accepting at the lifted step: the collapse needs a hyper
    potential as stiff as a learned sd of 0.1 makes it.) Tolerances as in
    test_three_epochs_match_jax_with_injected_draws."""
    j_model, _, t_model, _, x, y = _flagship()
    j_lik, t_lik = J.GaussianLikelihood(sd=0.1), T.GaussianLikelihood(sd=0.1)
    params, hypers = j_model.init(jax.random.key(0))
    lik_h = j_lik.init_hypers()
    flat = j_flatten(params, hypers, lik_h)
    c, d, h = 4, flat.theta.size, flat.eta.size
    kw = dict(adjust_hypers=True, hyper_leapfrog=5, burnin=3.0,
              mu=math.log(100 * 1e-4), eta_dim=h)
    j_fn = jax.jit(j_epoch(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                           flat.unravel_theta, flat.unravel_eta, **kw))
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    xt, yt = torch.tensor(x), torch.tensor(y)
    t_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                   t_flat.unravel_eta,
                   batched_main_vg=try_build_fused_main_vg(
                       t_model, t_lik, t_flat.unravel_theta,
                       t_flat.unravel_eta, xt, yt, h),
                   batched_hyper_traj=try_build_fused_hyper_trajectory(
                       t_model, t_lik, t_flat.unravel_eta, h, 5), **kw)
    j_carry = j_init(flat.theta, flat.eta, jax.random.key(1), 1e-4, c,
                     jitter=0.05)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))
    j_accepts, steps = [], []
    for _ in range(6):
        draws = _jax_draws(j_carry.key, d, h)
        j_carry, j_tr = j_fn(j_carry, jnp.asarray(1e-3, jnp.float32),
                             jnp.asarray(4, jnp.int32))
        t_carry, t_tr = t_fn(t_carry, 1e-3, 4, None, draws=draws)
        for field, rtol, atol in (("theta", 1e-3, 1e-4),
                                  ("eta", 1e-3, 1e-4),
                                  ("hyper_step", 1e-4, 0.0),
                                  ("log_eps_bar", 1e-4, 1e-5),
                                  ("h", 1e-4, 1e-5)):
            np.testing.assert_allclose(
                getattr(t_carry, field).numpy(),
                np.asarray(getattr(j_carry, field)), rtol=rtol, atol=atol,
                err_msg=field)
        for field in ("main_accept", "hyper_accept"):
            np.testing.assert_allclose(
                getattr(t_tr, field).numpy(),
                np.asarray(getattr(j_tr, field)), rtol=1e-3, atol=1e-3,
                err_msg=field)
        j_accepts.append(float(np.mean(np.asarray(j_tr.hyper_accept))))
        steps.append(float(np.mean(np.asarray(j_carry.hyper_step))))
    assert j_accepts[0] > 0.99 and max(j_accepts[1:]) < 0.01, j_accepts
    assert steps[0] > 50 * 1e-4 and steps[2:] == [steps[1]] * 4, steps


def test_three_epochs_on_k3_match_jax_with_injected_draws(monkeypatch):
    """Three epochs of a learned-sd model over 600 rows, past K1's shared
    memory, with the main block on K3 (its CPU twin) against three of the
    JAX package with its own K3 (``make_epoch_fn(batched_main_vg=...)``,
    interpret mode), from one state and with JAX's own draws. The Pallas
    K3's 12 MB VMEM budget is the TPU's (600 rows need ~109 MB at its
    128-lane padding); interpret mode has no VMEM, so the budget is lifted
    here. Tolerances as in test_three_epochs_match_jax_with_injected_draws.
    """
    from tensorbnn_tpu.ops import fused_mlp as j_fused
    monkeypatch.setattr(j_fused, "VMEM_LIMIT_BYTES", 1 << 40)
    widths = [(4, 16), (16, 16), (16, 1)]
    j_layers, t_layers = [], []
    for i, (a, b) in enumerate(widths):
        j_layers.append(J.GaussianDenseLayer(a, b))
        t_layers.append(T.GaussianDenseLayer(a, b))
        if i < len(widths) - 1:
            j_layers.append(J.Tanh())
            t_layers.append(T.Tanh())
    j_model, t_model = JSequential(j_layers), TSequential(t_layers)
    j_lik, t_lik = J.GaussianLikelihood(sd=0.3), T.GaussianLikelihood(sd=0.3)
    # 600 rows: K1's planes need 4 (3 D + 101 N) bytes, over the budget
    # from 555 rows
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 4)).astype(np.float32)
    y = rng.normal(size=(600,)).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    lik_h = j_lik.init_hypers()
    flat = j_flatten(params, hypers, lik_h)
    c, d, h = 4, flat.theta.size, flat.eta.size
    kw = dict(adjust_hypers=True, hyper_leapfrog=10, burnin=100.0,
              mu=math.log(100 * 1e-3), eta_dim=h)
    j_main = j_main_vg_build(j_model, j_lik, flat.unravel_theta,
                             flat.unravel_eta, x, y, eta_dim=h, block_c=c,
                             interpret=True)
    j_fn = jax.jit(j_epoch(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                           flat.unravel_theta, flat.unravel_eta,
                           batched_main_vg=j_main, **kw))
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    xt, yt = torch.tensor(x), torch.tensor(y)
    assert try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
        h) is None
    main_vg = try_build_fused_main_vg(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt, h)
    hyper_traj = try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, h, 10)
    assert j_main is not None and main_vg is not None
    assert hyper_traj is not None
    t_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                   t_flat.unravel_eta, batched_main_vg=main_vg,
                   batched_hyper_traj=hyper_traj, **kw)

    j_carry = j_init(flat.theta, flat.eta, jax.random.key(1), 1e-3, c,
                     jitter=0.05)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))
    for _ in range(3):
        draws = _jax_draws(j_carry.key, d, h)
        j_carry, j_tr = j_fn(j_carry, jnp.asarray(3e-3, jnp.float32),
                             jnp.asarray(6, jnp.int32))
        t_carry, t_tr = t_fn(t_carry, 3e-3, 6, None, draws=draws)
        for field, rtol, atol in (("theta", 1e-3, 1e-4),
                                  ("eta", 1e-3, 1e-4),
                                  ("hyper_step", 1e-4, 0.0),
                                  ("log_eps_bar", 1e-4, 1e-5),
                                  ("h", 1e-4, 1e-5)):
            np.testing.assert_allclose(
                getattr(t_carry, field).numpy(),
                np.asarray(getattr(j_carry, field)), rtol=rtol, atol=atol,
                err_msg=field)
        for field in ("main_accept", "hyper_accept", "sjd"):
            np.testing.assert_allclose(
                getattr(t_tr, field).numpy(),
                np.asarray(getattr(j_tr, field)), rtol=1e-3, atol=1e-3,
                err_msg=field)


@pytest.mark.parametrize("per_chain", [False, True])
def test_hmc_step_evaluates_the_start_once(per_chain):
    """One HMC step makes L + 1 value-and-grad evaluations: the start's
    serves both the MH test and the first half kick."""
    calls = []

    def vg(q):
        calls.append(q)
        return -0.5 * (q * q).sum(-1), -q

    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((3, 5), generator=gen)
    steps = np.asarray([7, 3, 5]) if per_chain else 7
    res = hmc_step_batched(gen, q0, vg, 0.1, steps)
    assert len(calls) == 8
    assert torch.isfinite(res.position).all()


def _learned_sd_flagship(seed=0):
    """The learned-sd flagship over 704 points of the trig curve: K1 takes
    the learned sd (variant (d)), but its planes need 4 (3 D + 82 N)
    bytes, over one block's shared memory from 688 rows, so the driver
    takes K3."""
    x = np.linspace(-2, 2, 704).astype(np.float32)
    y = (np.sin(x * math.pi * 2) * x - np.cos(x * math.pi)).astype(
        np.float32)
    net = T.Network(np.float32, 1, x, y, x, y, seed=seed, device="cpu")
    net.add(T.GaussianDenseLayer(1, 10)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(10, 10)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(10, 10)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(10, 1))
    return net, T.GaussianLikelihood(sd=0.1)


def _wide_network(seed=0):
    """A narrowed wide stack (3 x 64 over 128 rows): past one block's
    shared memory, so K1 declines it as it declines wide_deep."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(128, 64)).astype(np.float32)
    y = rng.normal(size=(128, 1)).astype(np.float32)
    net = T.Network(np.float32, 64, x, y, x, y, seed=seed, device="cpu")
    net.add(T.GaussianDenseLayer(64, 64)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(64, 64)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(64, 1))
    return net, T.FixedGaussianLikelihood(sd=0.1)


@pytest.mark.parametrize("build", [_learned_sd_flagship, _wide_network])
def test_driver_takes_k3_where_k1_declines(build):
    net, lik = build()
    net.setup_mcmc(burnin=0, leapfrog_start=3, leapfrog_min=3,
                   leapfrog_max=3, step_size_start=1e-4, step_size_min=1e-5,
                   step_size_max=1e-3, hyper_leapfrog=3, averaging_steps=10)
    res = net.train(2, 1, lik, n_chains=2, verbose=False)
    assert res.main_path == "K3" and res.fused_main and res.fused_hyper
    assert res.theta_samples.shape[:2] == (2, 2)
    assert np.isfinite(res.theta_samples).all()


class _Ran(Exception):
    pass


def test_memory_policy_raises_before_any_epoch(monkeypatch):
    """keep_samples="auto" refuses a run whose recorded samples project
    past 2 GiB, and that has no folder to stream them to, before any epoch
    runs (JAX driver.py:786-805); keep_samples=True buffers them."""
    from tensorbnn_tpu_torch.sampler import driver

    def runner(*args, **kwargs):
        raise _Ran
    monkeypatch.setattr(driver, "make_multichain_chunk_runner", runner)
    net = _small_network()
    lik = T.FixedGaussianLikelihood(sd=0.1)
    # 2e7 recorded epochs x 2 chains x (19 + 8) floats: ~4.3 GB
    with pytest.raises(ValueError, match="keep_samples"):
        net.train(20_000_000, 1, lik, n_chains=2, verbose=False)
    with pytest.raises(_Ran):
        net.train(20_000_000, 1, lik, n_chains=2, verbose=False,
                  keep_samples=True)
    with pytest.raises(_Ran):
        net.train(40, 1, lik, n_chains=2, verbose=False)


def test_network_device_defaults_to_cuda():
    x = np.linspace(-1, 1, 5).astype(np.float32)
    if torch.cuda.is_available():
        assert T.Network(np.float32, 1, x, x, x, x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.Network(np.float32, 1, x, x, x, x)
