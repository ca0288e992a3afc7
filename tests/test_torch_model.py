"""The torch port's model math and potentials against the JAX package.

Same inputs (made with numpy from a seed) go through both packages; state
crosses as numpy arrays via ``tensorbnn_tpu_torch.convert``. Tolerances
are float32 ones: the two packages sum in different orders.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.sampler.hyper_stats import make_stats_hyper as j_stats
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper as \
    t_stats
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials

torch.set_num_threads(1)

# float32 value/gradient agreement across two frameworks' summation orders
RTOL, ATOL = 1e-5, 1e-4


def _flagship_pair(lik_cls=("FixedGaussianLikelihood", 0.1)):
    name, sd = lik_cls
    widths = [(1, 10), (10, 10), (10, 10), (10, 1)]
    j_layers, t_layers = [], []
    for i, (a, b) in enumerate(widths):
        j_layers.append(J.GaussianDenseLayer(a, b))
        t_layers.append(T.GaussianDenseLayer(a, b))
        if i < len(widths) - 1:
            j_layers.append(J.Tanh())
            t_layers.append(T.Tanh())
    return (JSequential(j_layers), getattr(J, name)(sd=sd),
            TSequential(t_layers), getattr(T, name)(sd=sd))


def _data(seed=0, n=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    return x, y


def _states(j_model, j_lik, c=4, seed=0):
    """Per-chain perturbed JAX flat states (numpy) and the flat layout."""
    params, hypers = j_model.init(jax.random.key(seed))
    flat = j_flatten(params, hypers, j_lik.init_hypers())
    rng = np.random.default_rng(seed + 1)
    thetas = (np.asarray(flat.theta)[None]
              + 0.3 * rng.normal(size=(c, flat.theta.size))).astype(
                  np.float32)
    etas = (np.asarray(flat.eta)[None]
            + 0.05 * rng.normal(size=(c, flat.eta.size))).astype(np.float32)
    return params, hypers, flat, thetas, etas


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_distributions_match_jax():
    from tensorbnn_tpu import distributions as jd
    from tensorbnn_tpu_torch import distributions as td
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    mu = np.float32(0.3)
    for sigma in (np.float32(0.7), np.abs(rng.normal(size=(7, 3))).astype(
            np.float32) + 0.1, np.float32(1e-12)):   # last one is clamped
        _close(td.gaussian_logprob(torch.tensor(sigma), mu, torch.tensor(x)),
               jd.gaussian_logprob(sigma, mu, x), rtol=1e-5, atol=1e-3)
    _close(td.normal_logprob(torch.tensor(x), 1.0, 0.1),
           jd.normal_logprob(x, 1.0, 0.1))
    for name in ("cauchy_logprob", "cauchy_logprob_compat"):
        _close(getattr(td, name)(torch.tensor(0.4), mu, torch.tensor(x)),
               getattr(jd, name)(np.float32(0.4), mu, x))


@pytest.mark.parametrize("act", ["Tanh", "Relu", "Sigmoid", "Exp", "Elu"])
def test_activations_match_jax(act):
    x = np.random.default_rng(1).normal(size=(5, 4)).astype(np.float32)
    _close(getattr(T, act)().apply({}, torch.tensor(x)),
           getattr(J, act)().apply({}, x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cls", ["GaussianDenseLayer", "CauchyDenseLayer"])
def test_dense_layer_matches_jax(cls):
    j_layer, t_layer = getattr(J, cls)(3, 4), getattr(T, cls)(3, 4)
    params, hypers = j_layer.init(jax.random.key(3))
    hypers = {k: v + 0.1 * i for i, (k, v) in enumerate(hypers.items())}
    (t_params,), (t_hypers,), _ = convert.from_jax((params,), (hypers,), {})
    x = np.random.default_rng(2).normal(size=(6, 3)).astype(np.float32)
    _close(t_layer.apply(t_params, torch.tensor(x)),
           j_layer.apply(params, x))
    _close(t_layer.log_prior(t_hypers, t_params),
           j_layer.log_prior(hypers, params))
    _close(t_layer.log_hyper_prior(t_hypers, t_params),
           j_layer.log_hyper_prior(hypers, params))


def test_convert_round_trip_and_flat_layout():
    j_model, j_lik, t_model, t_lik = _flagship_pair(("GaussianLikelihood",
                                                     0.2))
    params, hypers = j_model.init(jax.random.key(5))
    lik_h = j_lik.init_hypers()
    theta, eta = convert.flat_from_jax(params, hypers, lik_h)
    # the port's flat order is the JAX package's ravel_pytree order
    np.testing.assert_array_equal(theta.numpy(), ravel_pytree(params)[0])
    np.testing.assert_array_equal(eta.numpy(),
                                  ravel_pytree((hypers, lik_h))[0])
    assert theta.numel() == 251 and eta.numel() == 17
    back_p, back_h, back_l = convert.jax_from_flat(theta, eta, params,
                                                   hypers, lik_h)
    for a, b in zip(jax.tree.leaves((params, hypers, lik_h)),
                    jax.tree.leaves((back_p, back_h, back_l))):
        np.testing.assert_array_equal(np.asarray(a), b)
    t_params, t_hypers, t_lik_h = convert.from_jax(params, hypers, lik_h)
    np.testing.assert_array_equal(
        t_flatten(t_params, t_hypers, t_lik_h).theta.numpy(), theta.numpy())
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(convert.to_numpy(t_params))):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("lik", [("FixedGaussianLikelihood", 0.1),
                                 ("GaussianLikelihood", 0.2)])
def test_flagship_potentials_match_jax(lik):
    j_model, j_lik, t_model, t_lik = _flagship_pair(lik)
    x, y = _data()
    params, hypers, flat, thetas, etas = _states(j_model, j_lik)
    jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      flat.unravel_theta, flat.unravel_eta)
    t_flat = t_flatten(*convert.from_jax(params, hypers,
                                         j_lik.init_hypers()))
    tp = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta)
    th_t, et_t = torch.tensor(thetas), torch.tensor(etas)

    jv, jg = jax.vmap(jp.main_vg)(thetas, etas)
    tv, tg = tp.main_vg(th_t, et_t)
    _close(tv, jv, rtol=1e-5, atol=1e-2)
    _close(tg, jg, rtol=1e-4, atol=1e-2)

    jv, jg = jax.vmap(jp.hyper_vg)(etas, thetas)
    tv, tg = tp.hyper_vg(et_t, th_t)
    _close(tv, jv, rtol=1e-5, atol=1e-2)
    _close(tg, jg, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("lik", [("FixedGaussianLikelihood", 0.1),
                                 ("GaussianLikelihood", 0.2)])
def test_stats_potential_matches_jax(lik):
    j_model, j_lik, t_model, t_lik = _flagship_pair(lik)
    x, y = _data(seed=3)
    params, hypers, flat, thetas, etas = _states(j_model, j_lik, seed=3)
    j_stats_fn, j_vg, _ = j_stats(j_model, j_lik, jnp.asarray(x),
                                  jnp.asarray(y), flat.unravel_eta,
                                  flat.eta.size)
    t_flat = t_flatten(*convert.from_jax(params, hypers,
                                         j_lik.init_hypers()))
    t_stats_fn, t_vg, _ = t_stats(t_model, t_lik, torch.tensor(x),
                                  torch.tensor(y), t_flat.unravel_theta,
                                  t_flat.unravel_eta, t_flat.eta.numel())
    js = j_stats_fn(jax.vmap(flat.unravel_theta)(thetas))
    ts = t_stats_fn(torch.tensor(thetas))
    _close(ts, js, rtol=1e-5, atol=1e-3)
    jv, jg = j_vg(etas, js)
    tv, tg = t_vg(torch.tensor(etas), ts)
    _close(tv, jv, rtol=1e-5, atol=1e-2)
    _close(tg, jg, rtol=1e-4, atol=1e-2)


def test_import_loads_no_jax():
    code = ("import sys, tensorbnn_tpu_torch, tensorbnn_tpu_torch.network, "
            "tensorbnn_tpu_torch.convert, tensorbnn_tpu_torch.ops.fused_mlp, "
            "tensorbnn_tpu_torch.ops.fused_hyper, "
            "tensorbnn_tpu_torch.sampler.tempering, "
            "tensorbnn_tpu_torch.utils.autocorr, "
            "tensorbnn_tpu_torch.utils.diagnostics, "
            "tensorbnn_tpu_torch.utils.tracing, tensorbnn_tpu_torch.metrics, "
            "tensorbnn_tpu_torch.predictor, tensorbnn_tpu_torch.models.mlp, "
            "tensorbnn_tpu_torch.io.checkpoint, "
            "tensorbnn_tpu_torch.io.reference_format; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'tensorbnn_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
