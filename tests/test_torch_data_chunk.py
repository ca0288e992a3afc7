"""The port's chunked likelihood (``data_chunk``) against the JAX package's
(``tensorbnn_tpu/sampler/potential.py:126-215``,
``sampler/hyper_stats.py:107-160``).

The chunked path takes the likelihood's value and gradient chunk by chunk,
the values summed with a Kahan carry; only float association changes. The
port's chunked oracles are held against the JAX package's chunked ones on
the same inputs for every likelihood head, at relative 1e-5 (atol 1e-5 on
values of |log p| ~ 1e2, 1e-5 on gradients), and so is the stats
potential's chunked residual power. A 3-epoch run on the chunked plain
path with the Kahan leapfrog and a step scale is held against the JAX
epoch fed the same draws.
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
from tensorbnn_tpu.sampler.gibbs import make_epoch_fn as j_epoch
from tensorbnn_tpu.sampler.hyper_stats import make_stats_hyper as j_stats
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws, \
    make_epoch_fn as t_epoch
from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper as \
    t_stats
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials, row_chunks

torch.set_num_threads(1)

HEADS = {
    "fixed_gaussian": (lambda p: p.FixedGaussianLikelihood(sd=0.1), None),
    "gaussian": (lambda p: p.GaussianLikelihood(sd=0.1), None),
    "bernoulli": (lambda p: p.BernoulliLikelihood(), lambda p: p.Sigmoid()),
    "categorical": (lambda p: p.CategoricalLikelihood(),
                    lambda p: p.Softmax()),
}


def _problem(head, n=24, seed=0):
    """The JAX package's tests/test_data_chunk.py problem in both packages:
    ``(j_model, t_model, j_lik, t_lik, j_flat, t_flat, x, y)``."""
    make_lik, make_head = HEADS[head]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    if head == "bernoulli":
        y = (x.sum(axis=1) > 0).astype(np.float32)
    elif head == "categorical":
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    else:
        y = np.sin(x.sum(axis=1)).astype(np.float32)
    out = 3 if head == "categorical" else 1
    models = []
    for pkg, seq in ((J, JSequential), (T, TSequential)):
        layers = [pkg.GaussianDenseLayer(2, 5), pkg.Tanh(),
                  pkg.GaussianDenseLayer(5, out)]
        if make_head is not None:
            layers.append(make_head(pkg))
        models.append(seq(layers))
    j_lik, t_lik = make_lik(J), make_lik(T)
    params, hypers = models[0].init(jax.random.key(seed))
    lik_h = j_lik.init_hypers()
    j_flat = j_flatten(params, hypers, lik_h)
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    return (*models, j_lik, t_lik, j_flat, t_flat, x, y)


@pytest.mark.parametrize("head", list(HEADS))
def test_chunked_potentials_match_jax(head):
    """The chunked main and hyper oracles (plain and tempered) and the
    log-likelihood, at relative 1e-5, against the JAX package's chunked
    ones (and, on the port's side, its unchunked ones)."""
    j_model, t_model, j_lik, t_lik, j_flat, t_flat, x, y = _problem(head)
    jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      j_flat.unravel_theta, j_flat.unravel_eta, data_chunk=6)
    tp = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta, data_chunk=6)
    tp1 = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                       t_flat.unravel_theta, t_flat.unravel_eta)
    c = 3
    rng = np.random.default_rng(1)
    thetas = (np.asarray(j_flat.theta)
              + 0.1 * rng.normal(size=(c, j_flat.theta.size))).astype(
                  np.float32)
    etas = (np.asarray(j_flat.eta)
            + 0.05 * rng.normal(size=(c, j_flat.eta.size))).astype(np.float32)
    betas = np.asarray([1.0, 0.6, 0.3], np.float32)
    th, et, bt = torch.tensor(thetas), torch.tensor(etas), torch.tensor(betas)
    want = {
        "main_vg": jax.vmap(jp.main_vg)(thetas, etas),
        "hyper_vg": jax.vmap(jp.hyper_vg)(etas, thetas),
        "main_vg_t": jax.vmap(jp.main_vg_t)(thetas, etas, betas),
        "hyper_vg_t": jax.vmap(jp.hyper_vg_t)(etas, thetas, betas),
        "loglik": jax.vmap(jp.loglik)(thetas, etas),
        "main": jax.vmap(jp.main)(thetas, etas),
        "hyper": jax.vmap(jp.hyper)(etas, thetas),
    }
    for pots in (tp, tp1):
        got = {
            "main_vg": pots.main_vg(th, et),
            "hyper_vg": pots.hyper_vg(et, th),
            "main_vg_t": pots.main_vg_t(th, et, bt),
            "hyper_vg_t": pots.hyper_vg_t(et, th, bt),
            "loglik": pots.loglik(th, et),
            "main": torch.stack([pots.main(th[i], et[i]) for i in range(c)]),
            "hyper": torch.stack([pots.hyper(et[i], th[i])
                                  for i in range(c)]),
        }
        for name, w in want.items():
            g = got[name]
            for gi, wi in zip(g if isinstance(g, tuple) else (g,),
                              w if isinstance(w, tuple) else (w,)):
                np.testing.assert_allclose(gi.numpy(), np.asarray(wi),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=name)


def test_chunk_must_divide_rows_and_one_chunk_is_the_plain_path():
    """A chunk that does not divide the rows raises the JAX package's
    message; one chunk (or none) is the plain path."""
    j_model, t_model, j_lik, t_lik, j_flat, t_flat, x, y = _problem(
        "fixed_gaussian")
    msgs = []
    with pytest.raises(ValueError) as err:
        j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                     j_flat.unravel_theta, j_flat.unravel_eta, data_chunk=7)
    msgs.append(str(err.value))
    with pytest.raises(ValueError) as err:
        t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                     t_flat.unravel_theta, t_flat.unravel_eta, data_chunk=7)
    msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    xt, yt = torch.tensor(x), torch.tensor(y)
    assert row_chunks(xt, yt, None) is None
    assert row_chunks(xt, yt, 24) is None
    chunks = row_chunks(xt, yt, 8)
    assert [c[0].shape[0] for c in chunks] == [8, 8, 8]
    torch.testing.assert_close(torch.cat([c[1] for c in chunks]), yt,
                               rtol=0, atol=0)


def test_stats_hyper_chunked_residual_matches_jax():
    """The learned-sd stats potential's residual power R over chunks of 8
    rows against the JAX package's chunked and unchunked R (rtol 1e-5,
    atol 1e-6), and its value and gradient."""
    j_model, t_model, j_lik, t_lik, j_flat, t_flat, x, y = _problem(
        "gaussian")
    rng = np.random.default_rng(2)
    thetas = (np.asarray(j_flat.theta)
              + 0.1 * rng.normal(size=(3, j_flat.theta.size))).astype(
                  np.float32)
    etas = np.tile(np.asarray(j_flat.eta), (3, 1))
    j_full = j_stats(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                     j_flat.unravel_eta, j_flat.eta.size)
    j_chunk = j_stats(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      j_flat.unravel_eta, j_flat.eta.size, data_chunk=8)
    t_chunk = t_stats(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta,
                      t_flat.eta.numel(), data_chunk=8)
    trees = jax.vmap(j_flat.unravel_theta)(thetas)
    s_got = t_chunk[0](torch.tensor(thetas))
    for j_pair in (j_chunk, j_full):
        np.testing.assert_allclose(s_got.numpy(),
                                   np.asarray(j_pair[0](trees)), rtol=1e-5,
                                   atol=1e-6)
    s_want = j_chunk[0](trees)
    v_want, g_want = j_chunk[1](jnp.asarray(etas), s_want)
    v_got, g_got = t_chunk[1](torch.tensor(etas), s_got)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want), rtol=1e-5)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-5,
                               atol=1e-5)


class _SumY:
    """A per-chunk log-"likelihood" of ``sum(y)``: the chunk carry's
    arithmetic is set by the data."""

    main_probs_in_hypers = False

    def log_likelihood(self, preds, y, hypers):
        del preds, hypers
        return y.sum()


def test_chunk_carry_is_compensated():
    """Chunk 0 holds 2**24 (ulp 2 there) and 63 chunks hold 1.0 each: a
    plain float32 carry drops every one of them, the Kahan carry keeps the
    total to ulp / 2 (as tests/test_matmul_precision.py)."""
    n_chunks, chunk = 64, 8
    y = np.zeros((n_chunks, chunk), np.float32)
    y[0, 0] = 2.0 ** 24
    y[1:, 0] = 1.0
    x = np.zeros((n_chunks * chunk, 1), np.float32)
    model = TSequential([T.GaussianDenseLayer(1, 1)])
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = t_flatten(params, hypers, {})
    pots = t_potentials(model, _SumY(), torch.tensor(x),
                        torch.tensor(y.reshape(-1)), flat.unravel_theta,
                        flat.unravel_eta, data_chunk=chunk)
    total = float(pots.loglik(flat.theta[None], flat.eta[None])[0])
    assert abs(total - (2.0 ** 24 + 63.0)) <= 2.0, total
    plain = np.float32(0.0)
    for row in y:
        plain = np.float32(plain + np.float32(row.sum()))
    assert plain == np.float32(2.0 ** 24)


def _jax_draws(keys, d, h):
    """The draws one JAX epoch takes from its per-chain keys
    (gibbs.py:163-166, hmc.py:312-316)."""
    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(keys)

    def block(k, dim):
        k2 = jax.vmap(lambda kk: jax.random.split(kk))(k)
        mom = jax.vmap(lambda kk: jax.random.normal(
            kk, (dim,), jnp.float32))(k2[:, 0])
        log_u = jnp.log(jax.vmap(lambda kk: jax.random.uniform(
            kk, (), jnp.float32))(k2[:, 1]))
        return torch.tensor(np.asarray(mom)), torch.tensor(np.asarray(log_u))

    return EpochDraws(*block(keys3[:, 1], d), *block(keys3[:, 2], h))


@pytest.mark.parametrize("head", ["gaussian", "bernoulli"])
def test_three_chunked_compensated_epochs_match_jax(head):
    """Three epochs on the plain path with ``data_chunk``, the Kahan
    leapfrog and a per-coordinate step scale (the options the surrogate's
    run combines), the port fed the JAX epoch's own draws: states to rtol
    1e-3 / atol 1e-4, accept probabilities and SJD to 1e-3 (the tolerances
    of tests/test_torch_sampler.py's injected-draw epochs)."""
    j_model, t_model, j_lik, t_lik, j_flat, t_flat, x, y = _problem(head)
    c, d, h = 4, j_flat.theta.size, j_flat.eta.size
    scale = np.random.default_rng(3).uniform(0.5, 1.5, d).astype(np.float32)
    kw = dict(adjust_hypers=True, hyper_leapfrog=5, burnin=100.0,
              mu=math.log(100 * 1e-3), eta_dim=h, data_chunk=8,
              compensated=True)
    j_fn = jax.jit(j_epoch(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                           j_flat.unravel_theta, j_flat.unravel_eta,
                           step_scale=jnp.asarray(scale), **kw))
    t_fn = t_epoch(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                   t_flat.unravel_theta, t_flat.unravel_eta, **kw)
    j_carry = j_init(j_flat.theta, j_flat.eta, jax.random.key(1), 1e-3, c,
                     jitter=0.05)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))
    for _ in range(3):
        draws = _jax_draws(j_carry.key, d, h)
        j_carry, j_tr = j_fn(j_carry, jnp.asarray(2e-2, jnp.float32),
                             jnp.asarray(6, jnp.int32))
        t_carry, t_tr = t_fn(t_carry, 2e-2, 6, None, draws=draws,
                             step_scale=torch.tensor(scale))
        for field, rtol, atol in (("theta", 1e-3, 1e-4),
                                  ("eta", 1e-3, 1e-4),
                                  ("hyper_step", 1e-4, 0.0)):
            np.testing.assert_allclose(
                getattr(t_carry, field).numpy(),
                np.asarray(getattr(j_carry, field)), rtol=rtol, atol=atol,
                err_msg=field)
        for field in ("main_accept", "hyper_accept", "sjd"):
            np.testing.assert_allclose(
                getattr(t_tr, field).numpy(),
                np.asarray(getattr(j_tr, field)), rtol=1e-3, atol=1e-3,
                err_msg=field)


def test_driver_runs_with_data_chunk():
    """End to end: ``Network.train`` with ``data_chunk`` samples a healthy
    posterior (as tests/test_data_chunk.py, the flat layout), and its first
    epochs equal a run without it to float32 association (rtol 1e-4)."""
    x = np.linspace(-1, 1, 24)
    y = np.sin(x * math.pi)

    def run(epochs, **kw):
        net = T.Network(np.float32, 1, x, y, x, y, seed=3, device="cpu")
        net.add(T.GaussianDenseLayer(1, 4)).add(T.Tanh())
        net.add(T.GaussianDenseLayer(4, 1))
        net.setup_mcmc(step_size_start=5e-3, step_size_min=1e-3,
                       step_size_max=1e-2, step_size_options=5,
                       leapfrog_start=6, leapfrog_min=2, leapfrog_max=12,
                       leapfrog_increment=2, hyper_leapfrog=4, burnin=20,
                       averaging_steps=5, random_steps=2)
        return net.train(epochs, 4, T.GaussianLikelihood(sd=0.1), n_chains=2,
                         use_fused=False, verbose=False, **kw)

    res = run(80, data_chunk=8)
    assert np.isfinite(res.theta_samples).all()
    assert res.main_accept.mean() > 0.05
    assert res.main_path == "plain"
    short = [run(24, **kw) for kw in ({"data_chunk": 8}, {})]
    np.testing.assert_allclose(short[0].theta_samples,
                               short[1].theta_samples, rtol=1e-4, atol=1e-5)
