"""U-turn dynamic trajectories (``trajectory="uturn"``) of the torch port
against the JAX package: the ``UTurnAdapter`` copy, the recording leapfrog,
K1's recording twin against the Pallas kernel's ``record_uturn`` program
(interpret mode), three injected-draw epochs on K1's twin, K3's twin and the
plain path, and the driver on the CPU.

The recorded U-turn steps are compared with ``array_equal``: on these
inputs no projection lies near enough to 0 for the two float32 orders of
summation to give it different signs, so no mismatch is allowed anywhere.
torch's generators cannot reproduce JAX's threefry streams, so the epoch
test hands the port the JAX package's own draws, computed from its chain
keys as tests/test_torch_sampler.py does.
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
from tensorbnn_tpu.network import Network as JNetwork
from tensorbnn_tpu.ops.fused_mlp import try_build_fused_trajectory as \
    j_traj_build
from tensorbnn_tpu.parallel.chains import init_multichain_state as j_init
from tensorbnn_tpu.sampler.gibbs import make_epoch_fn as j_epoch
from tensorbnn_tpu.sampler.hmc import leapfrog_batched as j_leapfrog
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu.sampler import uturn as j_uturn
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops import fused_mlp
from tensorbnn_tpu_torch.ops.fused_hyper import \
    try_build_fused_hyper_trajectory
from tensorbnn_tpu_torch.ops.fused_mlp import try_build_fused_main_vg, \
    try_build_fused_trajectory
from tensorbnn_tpu_torch.sampler import uturn as t_uturn
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws, \
    make_epoch_fn as t_epoch
from tensorbnn_tpu_torch.sampler.hmc import leapfrog_batched as t_leapfrog
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials

torch.set_num_threads(1)

#: the trajectory tolerances of tests/test_fused_trajectory.py:72-79,
#: (rtol, atol) for q, v, lp0, lp1
TRAJ_TOL = ((1e-3, 1e-4), (1e-3, 1e-3), (1e-4, 1e-3), (1e-4, 1e-2))


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


# ---------------------------------------------------------------------------
# the UTurnAdapter copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe", ["alternate", "always"])
def test_uturn_adapter_copy_matches_jax(probe):
    """The same plan/observe sequence gives equal plans, reservoirs and
    state dicts: burn-in chunks of 7 epochs (the last one crosses the
    burn-in boundary and freezes the step size), U-turn steps with
    censored chains (0), then sampling chunks drawn from the reservoir;
    a state dict moves between the two."""
    kw = dict(step_size_start=2e-3, step_size_min=5e-4, step_size_max=2e-2,
              leapfrog_start=50, leapfrog_min=20, leapfrog_max=200,
              burnin=60, seed=3, probe=probe)
    ja, ta = j_uturn.UTurnAdapter(**kw), t_uturn.UTurnAdapter(**kw)
    rng = np.random.default_rng(0)
    iter_, c = 0, 16
    while iter_ < 120:
        chunk = 7 if iter_ < kw["burnin"] else 13
        j_eps, j_leaps = ja.plan_chunk(iter_, chunk)
        t_eps, t_leaps = ta.plan_chunk(iter_, chunk)
        assert j_eps == t_eps
        np.testing.assert_array_equal(t_leaps, j_leaps)
        accept = rng.uniform(0.4, 1.0, chunk)
        uturns = rng.integers(1, 260, (chunk, c))
        uturns[rng.random((chunk, c)) < 0.3] = 0        # censored
        ja.observe(iter_, accept, uturns, j_leaps)
        ta.observe(iter_, accept, uturns, t_leaps)
        assert ta.state_dict() == ja.state_dict()
        iter_ += chunk
        assert ta.frozen == (iter_ >= kw["burnin"])
    assert ta.reservoir and ta.frozen
    restored = t_uturn.UTurnAdapter(**kw)
    restored.load_state_dict(ja.state_dict())
    r_eps, r_leaps = restored.plan_chunk(iter_, 9)
    j_eps, j_leaps = ja.plan_chunk(iter_, 9)
    assert r_eps == j_eps
    np.testing.assert_array_equal(r_leaps, j_leaps)
    for name in ("UT_TARGET", "RM_GAIN", "RM_DECAY", "UT_KAPPA",
                 "RESERVOIR_CAP", "GROW"):
        assert getattr(t_uturn, name) == getattr(j_uturn, name)
    with pytest.raises(ValueError, match="probe must be"):
        t_uturn.UTurnAdapter(**{**kw, "probe": "never"})


# ---------------------------------------------------------------------------
# the recording leapfrog
# ---------------------------------------------------------------------------

def _leapfrog_case(case, per_chain):
    """``(c, thetas, momenta, j_vg, t_vg, eps (C,), L (C,))``, numpy but for
    the two value-and-grad functions:
    the standard Gaussian of tests/test_uturn.py:32 (16 x 6, eps 0.1, L
    100: half period ~31 steps) or a 1-6-1 tanh MLP (eps 5e-3, L 60, as
    tests/test_fused_trajectory.py:241-312 runs it)."""
    if case == "gaussian":
        rng = np.random.default_rng(0)
        c, d = 16, 6
        q = rng.normal(size=(c, d)).astype(np.float32)
        v = rng.normal(size=(c, d)).astype(np.float32)
        eps = np.full(c, 0.1, np.float32)
        steps = (np.asarray([100, 20, 40, 70] * 4) if per_chain
                 else np.full(c, 100))

        def j_iso(qs):
            return -0.5 * jnp.sum(qs ** 2, -1), -qs

        def t_iso(qs):
            return -0.5 * (qs ** 2).sum(-1), -qs

        return c, q, v, j_iso, t_iso, eps, steps
    j_model, j_lik, t_model, t_lik = _pair([(1, 6), (6, 1)])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(11, 1)).astype(np.float32)
    y = rng.normal(size=(11,)).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    t_flat = t_flatten(*convert.from_jax(params, hypers, {}))
    c = 4
    rng = np.random.default_rng(7)
    q = (0.3 * rng.normal(size=(c, flat.theta.size))).astype(np.float32)
    v = rng.normal(size=q.shape).astype(np.float32)
    etas = np.tile(np.asarray(flat.eta), (c, 1))
    jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      flat.unravel_theta, flat.unravel_eta)
    tp = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta)
    jvg = jax.vmap(jp.main_vg)
    et = torch.tensor(etas)
    if per_chain:
        eps = np.asarray([2e-2, 4e-2, 3e-2, 2.5e-2], np.float32)
        steps = np.asarray([50, 8, 30, 3])
    else:
        eps, steps = np.full(c, 5e-3, np.float32), np.full(c, 60)
    return c, q, v, (lambda qs: jvg(qs, etas)), \
        (lambda qs: tp.main_vg(qs, et)), eps, steps


@pytest.mark.parametrize("per_chain", [False, True])
@pytest.mark.parametrize("case", ["gaussian", "mlp"])
def test_recording_leapfrog_matches_jax(case, per_chain):
    """``leapfrog_batched(record_uturn=True)`` against the JAX package's,
    shared and per-chain (eps, L): U-turn steps equal, and the endpoint
    to the trajectory tolerances."""
    c, q, v, j_vg, t_vg, eps, steps = _leapfrog_case(case, per_chain)
    if per_chain:
        j_args = (jnp.asarray(eps)[:, None], jnp.asarray(steps, jnp.int32))
        t_args = (torch.tensor(eps)[:, None], steps)
    else:
        j_args = (jnp.asarray(float(eps[0])),
                  jnp.asarray(int(steps[0]), jnp.int32))
        t_args = (float(eps[0]), int(steps[0]))
    jq, jv, jlp, _, jut = j_leapfrog(j_vg, jnp.asarray(q), jnp.asarray(v),
                                     *j_args, record_uturn=True)
    tq, tv, tlp, _, tut = t_leapfrog(t_vg, torch.tensor(q), torch.tensor(v),
                                     *t_args, record_uturn=True)
    jut = np.asarray(jut)
    assert tut.dtype == torch.int32
    np.testing.assert_array_equal(tut.numpy(), jut)
    assert (jut > 0).any()
    assert ((jut == 0) | (jut <= steps)).all()
    if case == "gaussian" and not per_chain:
        # tests/test_uturn.py:32-52: the fleet turns near pi / eps
        assert abs(float(np.median(jut)) - math.pi / 0.1) < 10
    _close(tq, jq, *TRAJ_TOL[0])
    _close(tv, jv, *TRAJ_TOL[1])
    _close(tlp, jlp, *TRAJ_TOL[3])
    # recording changes nothing else
    plain = t_leapfrog(t_vg, torch.tensor(q), torch.tensor(v), *t_args)
    for got, want in zip(plain, (tq, tv, tlp)):
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


# ---------------------------------------------------------------------------
# K1's recording twin against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["shared", "per_chain"])
def test_k1_recording_twin_matches_pallas(mode):
    """K1 variant (e): ``trajectory_plain`` of a recording program against
    the Pallas kernel's ``record_uturn`` program in interpret mode, on the
    inputs of tests/test_fused_trajectory.py:241-312 (1-6-1 tanh, seeds 7
    and 9, shared (5e-3, 60) and per-chain (eps, L)); the U-turn steps
    equal, the rest to the trajectory tolerances and bit for bit the
    non-recording twin's."""
    pair = _pair([(1, 6), (6, 1)])
    j_model, j_lik, t_model, t_lik = pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(11, 1)).astype(np.float32)
    y = rng.normal(size=(11,)).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    t_flat = t_flatten(*convert.from_jax(params, hypers, {}))
    c = 4
    rng = np.random.default_rng(7 if mode == "shared" else 9)
    thetas = (0.3 * rng.normal(size=(c, flat.theta.size))).astype(
        np.float32)
    etas = np.tile(np.asarray(flat.eta), (c, 1))
    momenta = rng.normal(size=thetas.shape).astype(np.float32)
    if mode == "shared":
        eps, steps = np.float32(5e-3), np.int32(60)
        t_eps, t_l = float(eps), int(steps)
    else:
        eps = np.asarray([2e-2, 4e-2, 3e-2, 2.5e-2], np.float32)
        steps = np.asarray([50, 8, 30, 3], np.int32)
        t_eps, t_l = torch.tensor(eps), torch.tensor(steps)

    j_traj = j_traj_build(j_model, j_lik, flat.unravel_theta,
                          flat.unravel_eta, x, y, eta_dim=flat.eta.size,
                          block_c=c, interpret=True, record_uturn=True)
    xt, yt = torch.tensor(x), torch.tensor(y)
    t_traj = try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
        eta_dim=t_flat.eta.numel(), record_uturn=True)
    assert j_traj is not None and t_traj is not None
    assert t_traj.args[0].record_uturn
    want = j_traj(jnp.asarray(thetas), jnp.asarray(etas),
                  jnp.asarray(momenta), x, y, jnp.asarray(eps),
                  jnp.asarray(steps))
    args = (torch.tensor(thetas), torch.tensor(etas), torch.tensor(momenta),
            xt, yt, t_eps, t_l)
    launches = fused_mlp.fused_trajectory.LAUNCHES
    got = t_traj(*args)
    assert fused_mlp.fused_trajectory.LAUNCHES == launches
    assert len(got) == 5 and got[4].dtype == torch.int32
    j_ut = np.asarray(want[4]).reshape(-1)
    np.testing.assert_array_equal(got[4].numpy(), j_ut)
    if mode == "shared":
        assert (j_ut > 0).any() and (j_ut == 0).any()   # turns + censoring
    else:
        assert (j_ut > 0).any()
        assert ((j_ut == 0) | (j_ut <= steps)).all()
    for g, w, (rtol, atol) in zip(got[:4], want[:4], TRAJ_TOL):
        _close(g, np.asarray(w).reshape(g.shape), rtol, atol)
    plain = try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
        eta_dim=t_flat.eta.numel())
    for g, w in zip(got[:4], plain(*args)):
        torch.testing.assert_close(g, w, rtol=0.0, atol=0.0)


def test_recording_program_shared_memory_is_unchanged():
    """Recording re-reads q0 from the theta input in device memory, so the
    program asks for no more shared memory than the non-recording one."""
    _, _, t_model, t_lik = _pair([(1, 10), (10, 10), (10, 10), (10, 1)])
    params, hypers = t_model.init(torch.Generator().manual_seed(0))
    flat = t_flatten(params, hypers, {})
    programs = [fused_mlp.build_trajectory_program(
        t_model, t_lik, flat.unravel_theta, flat.unravel_eta,
        flat.eta.numel(), n_rows=11, record_uturn=rec) for rec in (False,
                                                                    True)]
    assert [p.record_uturn for p in programs] == [False, True]
    assert programs[0].smem_bytes == programs[1].smem_bytes


# ---------------------------------------------------------------------------
# three epochs with injected draws
# ---------------------------------------------------------------------------

def _jax_draws(keys, d, h):
    """The draws one JAX epoch takes from its per-chain keys (as
    tests/test_torch_sampler.py computes them)."""
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


@pytest.mark.parametrize("path", ["K1", "K3", "plain"])
def test_three_uturn_epochs_match_jax_with_injected_draws(path):
    """Three ``record_uturn=True`` epochs of the port against three of the
    JAX package (its XLA path), from one state and with JAX's own draws, at
    (eps, L) = (5e-3, 60) on a 1-6-1 tanh MLP, where chains turn within
    the trajectory. The port's main block runs on K1's recording twin, on
    K3's twin under ``hmc_step_batched(record_uturn=True)``, or on the
    plain potential; the U-turn steps equal, the rest to the tolerances of
    test_three_epochs_match_jax_with_injected_draws."""
    j_model, j_lik, t_model, t_lik = _pair([(1, 6), (6, 1)])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(11, 1)).astype(np.float32)
    y = rng.normal(size=(11,)).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    c, d, h = 8, flat.theta.size, flat.eta.size
    kw = dict(adjust_hypers=True, hyper_leapfrog=10, burnin=100.0,
              mu=math.log(100 * 1e-3), eta_dim=h, record_uturn=True)
    j_fn = jax.jit(j_epoch(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                           flat.unravel_theta, flat.unravel_eta, **kw))
    t_flat = t_flatten(*convert.from_jax(params, hypers, {}))
    xt, yt = torch.tensor(x), torch.tensor(y)
    kernels = {}
    if path == "K1":
        kernels["batched_main_traj"] = try_build_fused_trajectory(
            t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
            h, record_uturn=True)
    elif path == "K3":
        kernels["batched_main_vg"] = try_build_fused_main_vg(
            t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
            h)
    if path != "plain":
        kernels["batched_hyper_traj"] = try_build_fused_hyper_trajectory(
            t_model, t_lik, t_flat.unravel_eta, h, 10)
    assert all(k is not None for k in kernels.values())
    t_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                   t_flat.unravel_eta, **kernels, **kw)

    j_carry = j_init(flat.theta, flat.eta, jax.random.key(1), 1e-3, c,
                     jitter=0.05)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))
    turned = 0
    for _ in range(3):
        draws = _jax_draws(j_carry.key, d, h)
        j_carry, j_tr = j_fn(j_carry, jnp.asarray(5e-3, jnp.float32),
                             jnp.asarray(60, jnp.int32))
        t_carry, t_tr = t_fn(t_carry, 5e-3, 60, None, draws=draws)
        j_ut = np.asarray(j_tr.uturn)
        assert t_tr.uturn.dtype == torch.int32
        np.testing.assert_array_equal(t_tr.uturn.numpy(), j_ut)
        turned += int((j_ut > 0).sum())
        for field, rtol, atol in (("theta", 1e-3, 1e-4),
                                  ("eta", 1e-3, 1e-4),
                                  ("hyper_step", 1e-4, 0.0),
                                  ("log_eps_bar", 1e-4, 1e-5),
                                  ("h", 1e-4, 1e-5)):
            _close(getattr(t_carry, field).numpy(),
                   getattr(j_carry, field), rtol, atol, field)
        for field in ("main_accept", "hyper_accept", "sjd"):
            _close(getattr(t_tr, field).numpy(), getattr(j_tr, field),
                   1e-3, 1e-3, field)
    assert 0 < turned < 3 * c


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _net(module, seed=0, learned_sd=False):
    x = np.linspace(-2, 2, 11).astype(np.float32)
    y = (np.sin(x * math.pi * 2) * x - np.cos(x * math.pi)).astype(
        np.float32)
    if module is T:
        net = T.Network(np.float32, 1, x, y, x, y, seed=seed, device="cpu")
    else:
        net = JNetwork(jnp.float32, 1, x, y, x, y, seed=seed)
    net.add(module.GaussianDenseLayer(1, 6)).add(module.Tanh())
    net.add(module.GaussianDenseLayer(6, 1))
    net.setup_mcmc(burnin=20, leapfrog_start=10, leapfrog_min=5,
                   leapfrog_max=30, leapfrog_increment=5, averaging_steps=5,
                   random_steps=2, hyper_leapfrog=10, step_size_start=2e-3,
                   step_size_min=5e-4, step_size_max=2e-2)
    lik = (module.GaussianLikelihood(sd=0.1) if learned_sd
           else module.FixedGaussianLikelihood(sd=0.1))
    return net, lik


@pytest.mark.parametrize("probe", ["alternate", "always"])
def test_network_train_uturn_runs_on_cpu(probe):
    """``Network.train(trajectory="uturn")`` through K1's recording twin:
    finite samples, post-burn-in acceptance near the 0.8 target, and the
    executed leapfrog count of every epoch (burn-in chunks of
    ``averaging_steps`` epochs share one count)."""
    net, lik = _net(T)
    res = net.train(40, 2, lik, n_chains=4, chain_jitter=0.05,
                    trajectory="uturn", uturn_probe=probe, verbose=False)
    assert res.main_path == "K1" and res.fused_hyper
    assert res.theta_samples.shape == (10, 4, 19)
    assert np.isfinite(res.theta_samples).all()
    assert np.isfinite(res.eta_samples).all()
    acc = float(res.main_accept[20:].mean())
    assert 0.5 < acc <= 1.0, acc
    assert len(res.leapfrog) == 40
    assert ((res.leapfrog >= 5) & (res.leapfrog <= 30)).all()
    assert (res.leapfrog == np.round(res.leapfrog)).all()
    for start in range(0, 20, 5):
        assert len(set(res.leapfrog[start:start + 5])) == 1
    assert 5 <= res.final_leapfrog <= 30
    assert 5e-4 <= res.final_step_size <= 2e-2
    assert res.uturn_turned.shape == (40,)
    assert ((res.uturn_turned >= 0) & (res.uturn_turned <= 4)).all()


def test_uturn_takes_k3_where_k1_declines():
    """A learned sd keeps the model out of K1: U-turn mode runs the main
    block on K3 under ``hmc_step_batched(record_uturn=True)``."""
    net, lik = _net(T, learned_sd=True)
    res = net.train(30, 2, lik, n_chains=4, chain_jitter=0.05,
                    trajectory="uturn", verbose=False)
    assert res.main_path == "K3"
    assert np.isfinite(res.theta_samples).all()
    assert len(res.leapfrog) == 30
    assert res.uturn_turned.shape == (30,)


@pytest.mark.parametrize("kwargs", [
    dict(trajectory="nuts"),
    dict(trajectory="uturn", n_chains=4, n_adapters=2),
    dict(trajectory="uturn", uturn_probe="never"),
    dict(trajectory="uturn", n_chains=4, tempering=2),
])
def test_uturn_validation_matches_jax(kwargs):
    """The JAX driver's errors for the trajectory options
    (driver.py:486-494, :512-514, and the UTurnAdapter's probe check),
    worded as there."""
    j_net, j_lik = _net(J)
    with pytest.raises(ValueError) as j_err:
        j_net.train(4, 2, j_lik, verbose=False, **kwargs)
    t_net, t_lik = _net(T)
    with pytest.raises(ValueError) as t_err:
        t_net.train(4, 2, t_lik, verbose=False, **kwargs)
    assert str(t_err.value) == str(j_err.value)
