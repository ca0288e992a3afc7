"""The port's Kahan-compensated leapfrog and ``numerics="exact"`` against
the JAX package (``tensorbnn_tpu/sampler/hmc.py:36``, ``:146-331``;
``sampler/driver.py:63-86``).

A plain float32 drift ``q + eps * v`` freezes once ``eps * v`` falls below
half an ulp of ``q``; ``compensated=True`` carries each drift's and kick's
rounding error. The port's integrator is held against the JAX package's
on the same inputs and momenta: ``_kahan_add`` bit for bit, trajectories to
float32 tolerance (rtol 1e-5, atol 1e-6 on a quadratic target whose
U-turn projections stay clear of zero; the flagship's potential at the
tolerances of tests/test_fused_trajectory.py:72-79), U-turn steps exactly.
"""

import dataclasses
import json
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.sampler import driver as j_driver
from tensorbnn_tpu.sampler.hmc import _kahan_add as j_kahan, \
    hmc_step_batched as j_hmc_step, leapfrog_batched as j_leapfrog
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.sampler import driver as t_driver
from tensorbnn_tpu_torch.sampler.gibbs import make_epoch_fn as t_epoch
from tensorbnn_tpu_torch.sampler.hmc import _kahan_add as t_kahan, \
    hmc_step_batched as t_hmc_step, leapfrog_batched as t_leapfrog
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials

torch.set_num_threads(1)

PREC = np.asarray([4.0, 1.0, 0.25, 9.0, 2.0, 0.5], np.float32)


def _quad_vg(lib):
    """The log-density ``-0.5 sum(prec q^2)`` and its gradient in ``lib``."""
    if lib is jnp:
        prec = jnp.asarray(PREC)
        return lambda q: (-0.5 * jnp.sum(prec * q * q, axis=-1), -prec * q)
    prec = torch.tensor(PREC)
    return lambda q: (-0.5 * (prec * q * q).sum(-1), -prec * q)


def test_kahan_add_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    s = (rng.normal(size=512) * 10.0 ** rng.integers(-3, 4, 512)).astype(
        np.float32)
    c = (rng.normal(size=512) * 1e-7).astype(np.float32)
    d = (rng.normal(size=512) * 10.0 ** rng.integers(-9, 1, 512)).astype(
        np.float32)
    jt, jc = j_kahan(jnp.asarray(s), jnp.asarray(c), jnp.asarray(d))
    tt, tc = t_kahan(torch.tensor(s), torch.tensor(c), torch.tensor(d))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("per_chain", [False, True])
def test_compensated_uturn_leapfrog_matches_jax(per_chain):
    """Shared and per-chain counts, U-turn recording in the metric's space
    (``uturn_inv_scale``), the same momenta: q and v to rtol 1e-5 / atol
    1e-6, the first U-turn steps exactly."""
    rng = np.random.default_rng(1)
    c, d = 4, PREC.size
    q0 = rng.normal(size=(c, d)).astype(np.float32)
    mom = rng.normal(size=(c, d)).astype(np.float32)
    inv = (1.0 / rng.uniform(0.5, 2.0, size=d)).astype(np.float32)
    if per_chain:
        eps = np.asarray([0.11, 0.07, 0.13, 0.05], np.float32)[:, None]
        steps = np.asarray([25, 9, 40, 17])
        j_eps, t_eps = jnp.asarray(eps), torch.tensor(eps)
        j_l, t_l = jnp.asarray(steps, jnp.int32), steps
    else:
        j_eps, t_eps = jnp.float32(0.1), 0.1
        j_l, t_l = jnp.asarray(30, jnp.int32), 30
    jq, jv, jlp, _, jut = j_leapfrog(
        _quad_vg(jnp), jnp.asarray(q0), jnp.asarray(mom), j_eps, j_l,
        record_uturn=True, uturn_inv_scale=jnp.asarray(inv),
        compensated=True)
    tq, tv, tlp, _, tut = t_leapfrog(
        _quad_vg(torch), torch.tensor(q0), torch.tensor(mom), t_eps, t_l,
        record_uturn=True, uturn_inv_scale=torch.tensor(inv),
        compensated=True)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tut.numpy(), np.asarray(jut))
    assert (tut.numpy() > 0).sum() >= 2


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
    return JSequential(j_layers), TSequential(t_layers), x, y


@pytest.mark.parametrize("per_chain", [False, True])
def test_compensated_flagship_leapfrog_matches_jax(per_chain):
    """The Kahan leapfrog on the flagship's potential (plain potentials on
    both sides) from 0.3 N(0, 1) weights, at the trajectory tolerances of
    tests/test_fused_trajectory.py:72-79 (q rtol 1e-3 / atol 1e-4, v atol
    1e-3, log p atol 1e-2)."""
    j_model, t_model, x, y = _flagship()
    j_lik, t_lik = J.FixedGaussianLikelihood(sd=0.1), \
        T.FixedGaussianLikelihood(sd=0.1)
    params, hypers = j_model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    t_flat = t_flatten(*convert.from_jax(params, hypers, {}))
    c = 4
    rng = np.random.default_rng(2)
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
                                j_eps, j_l, compensated=True)
    et = torch.tensor(etas)
    tq, tv, tlp, _ = t_leapfrog(lambda th: tp.main_vg(th, et),
                                torch.tensor(thetas), torch.tensor(mom),
                                t_eps, t_l, compensated=True)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-4,
                               atol=1e-2)


def _jax_step_draws(keys, d):
    """The momenta and log coins ``hmc_step_batched`` draws from its keys
    (tensorbnn_tpu/sampler/hmc.py:312-316)."""
    k2 = jax.vmap(lambda k: jax.random.split(k))(keys)
    mom = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(
        k2[:, 0])
    log_u = jnp.log(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32))(k2[:, 1]))
    return torch.tensor(np.asarray(mom)), torch.tensor(np.asarray(log_u))


@pytest.mark.parametrize("compensated", [False, True])
def test_hmc_step_with_step_scale_matches_jax(compensated):
    """One transition with a per-coordinate ``step_scale``, per-chain step
    sizes and U-turn recording, the port fed the JAX step's own draws:
    positions and accept probabilities to rtol 1e-5 / atol 1e-6, the
    accept decisions and U-turn steps exactly."""
    rng = np.random.default_rng(3)
    c, d = 6, PREC.size
    q0 = rng.normal(size=(c, d)).astype(np.float32)
    scale = rng.uniform(0.3, 1.5, size=d).astype(np.float32)
    eps = rng.uniform(0.05, 0.2, size=c).astype(np.float32)
    keys = jax.random.split(jax.random.key(4), c)
    j_res = j_hmc_step(keys, jnp.asarray(q0), _quad_vg(jnp),
                       jnp.asarray(eps), jnp.asarray(20, jnp.int32),
                       step_scale=jnp.asarray(scale), record_uturn=True,
                       compensated=compensated)
    mom, log_u = _jax_step_draws(keys, d)
    t_res = t_hmc_step(None, torch.tensor(q0), _quad_vg(torch),
                       torch.tensor(eps), 20, momenta=mom, log_u=log_u,
                       step_scale=torch.tensor(scale), record_uturn=True,
                       compensated=compensated)
    np.testing.assert_allclose(t_res.position.numpy(),
                               np.asarray(j_res.position), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t_res.accept_prob.numpy(),
                               np.asarray(j_res.accept_prob), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(t_res.accepted.numpy(),
                                  np.asarray(j_res.accepted))
    np.testing.assert_array_equal(t_res.uturn.numpy(),
                                  np.asarray(j_res.uturn))


def _free_vg(q):
    return torch.zeros(q.shape[0]), torch.zeros_like(q)


def test_plain_drift_freezes_below_an_ulp_compensated_moves():
    """eps * v = 1e-8 is below half an ulp of 1.0: the plain drift rounds
    to nothing every step, the compensated one accumulates it (rtol 1e-4,
    as tests/test_compensated.py)."""
    q0, v0 = torch.ones(2, 4), torch.ones(2, 4)
    q_plain, *_ = t_leapfrog(_free_vg, q0, v0, 1e-8, 1000)
    q_comp, *_ = t_leapfrog(_free_vg, q0, v0, 1e-8, 1000, compensated=True)
    np.testing.assert_array_equal(q_plain.numpy(), np.ones((2, 4)))
    np.testing.assert_allclose(q_comp.numpy(), 1.0 + 1000 * 1e-8, rtol=1e-4)


def test_compensated_tracks_float64_in_the_quantization_regime():
    """|q| ~ 1000 with eps ~ one ulp of q: the compensated trajectory stays
    within 1e-4 of the float64 leapfrog and at least 3x closer than the
    plain one (as tests/test_compensated.py)."""
    center, eps, n = 1000.0, 6e-5, 300
    q0 = np.full((1, 1), 1000.5, np.float32)
    v0 = np.full((1, 1), 1.0, np.float32)

    def vg(q):
        dq = q - center
        return -0.5 * (dq * dq).sum(-1), -dq

    q, v = q0.astype(np.float64), v0.astype(np.float64)
    v = v - 0.5 * eps * (q - center)
    for _ in range(n):
        q = q + eps * v
        v = v - eps * (q - center)
    q_plain, *_ = t_leapfrog(vg, torch.tensor(q0), torch.tensor(v0), eps, n)
    q_comp, *_ = t_leapfrog(vg, torch.tensor(q0), torch.tensor(v0), eps, n,
                            compensated=True)
    err_plain = abs(float(q_plain[0, 0]) - q[0, 0])
    err_comp = abs(float(q_comp[0, 0]) - q[0, 0])
    assert err_comp < 1e-4, (err_comp, err_plain)
    assert err_comp < err_plain / 3, (err_comp, err_plain)


def test_compensated_per_chain_counts_freeze_finished_chains():
    """A chain past its own count keeps (q, cq, v, cv): chain 0 at 3 steps
    inside a fleet running 7 lands where it lands alone (rtol 1e-6)."""
    rng = np.random.default_rng(5)
    q0 = torch.tensor(rng.normal(size=(2, 6)).astype(np.float32))
    v0 = torch.tensor(rng.normal(size=(2, 6)).astype(np.float32))
    vg = _quad_vg(torch)
    q_m, v_m, *_ = t_leapfrog(vg, q0, v0, 0.05, np.asarray([3, 7]),
                              compensated=True)
    q_s, v_s, *_ = t_leapfrog(vg, q0[:1], v0[:1], 0.05, 3, compensated=True)
    np.testing.assert_allclose(q_m[0].numpy(), q_s[0].numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(v_m[0].numpy(), v_s[0].numpy(), rtol=1e-6,
                               atol=1e-7)


def test_epoch_refuses_compensated_with_k1():
    _, t_model, x, y = _flagship()
    params, hypers = t_model.init(torch.Generator().manual_seed(0))
    flat = t_flatten(params, hypers, {})
    with pytest.raises(ValueError, match="compensated"):
        t_epoch(t_model, T.FixedGaussianLikelihood(sd=0.1), torch.tensor(x),
                torch.tensor(y), flat.unravel_theta, flat.unravel_eta,
                adjust_hypers=True, hyper_leapfrog=5, burnin=10.0, mu=0.0,
                batched_main_traj=lambda *a: None, compensated=True)


def test_exact_numerics_model_matches_jax():
    """Each package's preset on the same stack: "highest" on every dense
    layer without a precision, activations untouched, an explicit "high"
    kept; a bf16 layer raises the same message."""
    def stack(pkg, **kw):
        return [pkg.GaussianDenseLayer(1, 5, **kw), pkg.Tanh(),
                pkg.CauchyDenseLayer(5, 1)]

    for kw in ({}, {"matmul_precision": "high"}):
        got = t_driver.exact_numerics_model(TSequential(stack(T, **kw)))
        want = j_driver.exact_numerics_model(JSequential(stack(J, **kw)))
        for g, w in zip(got.layers, want.layers):
            assert type(g).__name__ == type(w).__name__
            assert getattr(g, "matmul_precision", None) == getattr(
                w, "matmul_precision", None)
    model = TSequential(stack(T))
    assert t_driver.exact_numerics_model(model).layers[1] is model.layers[1]
    assert model.layers[0].matmul_precision is None
    errors = []
    for pkg, mod, seq in ((T, t_driver, TSequential),
                          (J, j_driver, JSequential)):
        layer = dataclasses.replace(pkg.GaussianDenseLayer(1, 5),
                                    compute_dtype="bfloat16")
        with pytest.raises(ValueError) as err:
            mod.exact_numerics_model(seq([layer]))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


TINY_MCMC = dict(step_size_start=2e-3, step_size_min=1e-5,
                 step_size_max=5e-2, step_size_options=8, leapfrog_start=8,
                 leapfrog_min=2, leapfrog_max=32, leapfrog_increment=4,
                 hyper_leapfrog=4, burnin=40, averaging_steps=5,
                 random_steps=2, adapter_seed=0)


def _tiny_net(seed=7, layer_kw=None, pkg=T, **mcmc):
    """The JAX package's tests/test_compensated.py network, in ``pkg``."""
    x = np.linspace(-1, 1, 16)
    y = np.sin(x * math.pi)
    if pkg is J:
        from tensorbnn_tpu.network import Network
        net = Network(jnp.float32, 1, x, y, x, y, seed=seed)
    else:
        net = T.Network(np.float32, 1, x, y, x, y, seed=seed, device="cpu")
    net.add(pkg.GaussianDenseLayer(1, 5, **(layer_kw or {})))
    net.add(pkg.Tanh())
    net.add(pkg.GaussianDenseLayer(5, 1, **(layer_kw or {})))
    net.setup_mcmc(**(TINY_MCMC | mcmc))
    return net


def test_numerics_exact_preset_equals_the_manual_flags(capsys):
    """``numerics="exact"`` is ``compensated=True`` plus "highest" on every
    dense layer: the same seeds give bit-equal runs, on the plain path for
    both blocks (as the JAX driver routes it)."""
    lik = T.FixedGaussianLikelihood(sd=0.1)
    res = _tiny_net().train(60, 4, lik, n_chains=4, chain_jitter=0.05,
                            numerics="exact")
    assert "main block: plain; hyper block: plain" in capsys.readouterr().out
    assert res.main_path == "plain" and not res.fused_hyper
    res2 = _tiny_net(layer_kw={"matmul_precision": "highest"}).train(
        60, 4, lik, n_chains=4, chain_jitter=0.05, compensated=True,
        verbose=False)
    assert np.isfinite(res.theta_samples).all()
    assert 0.0 < float(res.main_accept.mean()) <= 1.0
    np.testing.assert_array_equal(res.theta_samples, res2.theta_samples)
    np.testing.assert_array_equal(res.main_accept, res2.main_accept)


def test_numerics_guards_match_jax():
    """The option errors in each package's words (the port says "fused
    kernels" where the JAX package says "Pallas kernels"): an unknown
    numerics, compensated with use_fused=True."""
    for kw in (dict(numerics="fast"), dict(compensated=True,
                                           use_fused=True)):
        msgs = []
        for pkg in (T, J):
            with pytest.raises(ValueError) as err:
                _tiny_net(pkg=pkg).train(
                    10, 2, pkg.FixedGaussianLikelihood(sd=0.1),
                    verbose=False, **kw)
            msgs.append(str(err.value).replace("Pallas", "fused"))
        assert msgs[0] == msgs[1], msgs


def test_numerics_advisory_fires_in_the_quantization_regime():
    """A step size within 16 ulps of |theta| warns once without
    ``compensated`` and never with it (as tests/test_compensated.py)."""
    tiny = dict(step_size_start=1e-9, step_size_min=1e-10,
                step_size_max=5e-9, step_size_options=4, leapfrog_start=4,
                leapfrog_min=2, leapfrog_max=8, leapfrog_increment=2,
                burnin=20)
    lik = T.FixedGaussianLikelihood(sd=0.1)
    with pytest.warns(RuntimeWarning, match="quantize or freeze") as rec:
        _tiny_net(seed=11, **tiny).train(30, 4, lik, n_chains=4,
                                         verbose=False)
    assert sum("quantize or freeze" in str(w.message) for w in rec) == 1
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _tiny_net(seed=11, **tiny).train(30, 4, lik, n_chains=4,
                                         compensated=True, verbose=False)
    assert not [w for w in rec if "quantize or freeze" in str(w.message)]


def test_compensated_uturn_run_and_fingerprint(tmp_path):
    """compensated composes with ``trajectory="uturn"``; its checkpoint's
    fingerprint carries "+kahan" and equals the JAX driver's for the same
    run, and a resume without ``compensated`` is refused."""
    fps = []
    for pkg in (T, J):
        ckpt = tmp_path / pkg.__name__
        res = _tiny_net(seed=9, pkg=pkg).train(
            40, 4, pkg.FixedGaussianLikelihood(sd=0.1), n_chains=4,
            chain_jitter=0.05, trajectory="uturn", compensated=True,
            verbose=False, checkpoint_dir=str(ckpt))
        assert np.isfinite(res.theta_samples).all()
        assert 0.0 < float(res.main_accept.mean()) <= 1.0
        fps.append(json.load(open(ckpt / "resume.json"))["fingerprint"])
    assert fps[0] == fps[1]
    assert fps[0]["trajectory"] == "uturn:alternate+kahan"
    with pytest.raises(ValueError, match="trajectory"):
        _tiny_net(seed=9).train(60, 4, T.FixedGaussianLikelihood(sd=0.1),
                                n_chains=4, chain_jitter=0.05,
                                trajectory="uturn", verbose=False,
                                checkpoint_dir=str(tmp_path / T.__name__))
