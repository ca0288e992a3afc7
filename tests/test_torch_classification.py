"""The torch port's classification family against the JAX package: the
Bernoulli and categorical log-probs and likelihoods, the Softmax,
LeakyRelu, Prelu and SquarePrelu layers, their potentials, K1 variant (d)
and K3's new tails and ops through their plain twins against the Pallas
kernels in interpret mode, the stats layout and K2, three injected-draw
epochs of the JAX bench's ``classification`` and ``multiclass`` models,
the driver's routing and ``Network.train``.

Inputs are made with numpy from a seed and go through both packages;
tolerances are those of the JAX package's own kernel tests, cited where
used.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu import distributions as jd
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.ops import fused_mlp as j_fused
from tensorbnn_tpu.ops.fused_hyper import \
    try_build_fused_hyper_trajectory as j_hyper_build
from tensorbnn_tpu.parallel.chains import init_multichain_state as j_init
from tensorbnn_tpu.sampler.gibbs import make_epoch_fn as j_epoch
from tensorbnn_tpu.sampler.hyper_stats import make_stats_hyper as j_stats, \
    probe_stats_layout as j_probe
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch import distributions as td
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochDraws, \
    make_epoch_fn as t_epoch
from tensorbnn_tpu_torch.sampler.hyper_stats import probe_stats_layout as \
    t_probe
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials

torch.set_num_threads(1)

# K1 against the Pallas K1: (rtol, atol) for lp0, q, v, lp1, the
# tolerances of tests/test_fused_trajectory.py:72-79
K1_TOL = ((1e-4, 1e-3), (1e-3, 1e-4), (1e-3, 1e-3), (1e-4, 1e-2))
# K3 against the Pallas K3: (rtol, atol) for ll and grad,
# tests/test_fused_mlp.py:33-36
K3_TOL = ((1e-4, 1e-4), (1e-3, 1e-4))


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


def _both(*specs):
    """The same stack in both packages: ``specs`` are (class name, args,
    kwargs) triples."""
    return tuple(seq([getattr(m, name)(*args, **kw)
                      for name, args, kw in specs])
                 for m, seq in ((J, JSequential), (T, TSequential)))


def _l(name, *args, **kw):
    return (name, args, kw)


def _lik(name, **kw):
    return getattr(J, name)(**kw), getattr(T, name)(**kw)


def _classification(d_in=10, width=16):
    """The JAX bench's ``classification`` stack
    (benchmarks/run_benchmarks.py:260-264), its widths as arguments."""
    return _both(_l("GaussianDenseLayer", d_in, width),
                 _l("SquarePrelu", width),
                 _l("GaussianDenseLayer", width, width),
                 _l("SquarePrelu", width),
                 _l("GaussianDenseLayer", width, 1), _l("Sigmoid"))


def _multiclass():
    """The JAX bench's ``multiclass`` stack (:312-313)."""
    return _both(_l("GaussianDenseLayer", 2, 8), _l("Tanh"),
                 _l("GaussianDenseLayer", 8, 3), _l("Softmax"))


def _data(lik, n, d_in, seed=0, n_classes=None):
    """x ~ N(0, 1) and labels as tests/test_fused_trajectory.py:32-38 makes
    them: Bernoulli 0/1, categorical class ids, else N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    if isinstance(lik, J.BernoulliLikelihood):
        y = (y > 0).astype(np.float32)
    elif n_classes is not None:
        y = rng.integers(0, n_classes, size=n).astype(np.float32)
    return x, y


def _flats(j_model, j_lik, seed=0):
    params, hypers = j_model.init(jax.random.key(seed))
    lik_h = j_lik.init_hypers()
    return (params, hypers, j_flatten(params, hypers, lik_h),
            t_flatten(*convert.from_jax(params, hypers, lik_h)))


# ---------------------------------------------------------------------------
# (a) log-probs, likelihoods and layers
# ---------------------------------------------------------------------------

def test_logprobs_match_jax():
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(size=(7, 3))).astype(np.float32)
    for rate in (0.3, -0.7):          # the rate goes through abs()
        _close(td.exponential_logprob(torch.tensor(rate), torch.tensor(x)),
               jd.exponential_logprob(np.float32(rate), x), 1e-6, 1e-6)
    # probabilities at and past both clip ends
    p = np.asarray([0.0, 1e-9, 0.3, 0.9, 1.0 - 1e-8, 1.0], np.float32)
    y = np.asarray([0, 1, 1, 0, 1, 0], np.float32)
    _close(td.bernoulli_logprob(torch.tensor(p), torch.tensor(y)),
           jd.bernoulli_logprob(p, y), 1e-6, 1e-5)
    logits = rng.normal(size=(7, 4)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs[0] = [1.0, 0.0, 0.0, 0.0]   # a zero probability is floored
    ids = rng.integers(0, 4, size=7)
    ids[0] = 2
    # ids, one-hot rows, and an (N, 1) column of ids (not one-hot:
    # tests/test_categorical.py:113)
    for labels in (ids.astype(np.float32), np.eye(4, dtype=np.float32)[ids],
                   ids[:, None].astype(np.float32)):
        _close(td.categorical_logprob(torch.tensor(probs),
                                      torch.tensor(labels)),
               jd.categorical_logprob(probs, labels), 1e-6, 1e-5)
    np.testing.assert_allclose(
        float(td.categorical_logprob(torch.tensor(probs), torch.tensor(
            ids[:, None].astype(np.float32)))[0]), math.log(1e-8),
        rtol=1e-6)


@pytest.mark.parametrize("labels", ["bernoulli", "ids", "onehot", "column"])
def test_likelihoods_match_jax(labels):
    rng = np.random.default_rng(1)
    if labels == "bernoulli":
        j_lik, t_lik = _lik("BernoulliLikelihood")
        preds = rng.uniform(size=(9, 1)).astype(np.float32)
        y = (rng.uniform(size=9) > 0.5).astype(np.float32)
    else:
        j_lik, t_lik = _lik("CategoricalLikelihood")
        logits = rng.normal(size=(9, 3))
        preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                 ).astype(np.float32)
        ids = rng.integers(0, 3, size=9)
        y = {"ids": ids, "onehot": np.eye(3)[ids],
             "column": ids[:, None]}[labels].astype(np.float32)
    assert t_lik.init_hypers() == {} and not t_lik.main_probs_in_hypers
    assert t_lik.n_ref_hyper_scalars == j_lik.n_ref_hyper_scalars == 0
    _close(t_lik.log_likelihood(torch.tensor(preds), torch.tensor(y), {}),
           j_lik.log_likelihood(jnp.asarray(preds), jnp.asarray(y), {}),
           1e-6, 1e-4)


@pytest.mark.parametrize("layer", ["Softmax", "LeakyRelu", "Prelu",
                                   "SquarePrelu"])
def test_layers_match_jax(layer):
    args = (5,) if layer in ("Prelu", "SquarePrelu") else ()
    j_layer, t_layer = getattr(J, layer)(*args), getattr(T, layer)(*args)
    params, hypers = j_layer.init(jax.random.key(0))
    rng = np.random.default_rng(2)
    if params:
        # slopes of both signs and a zero, hypers off their starts
        params = {"slopes": np.asarray([0.4, -0.3, 0.0, 1.2, -0.8],
                                       np.float32)}
        hypers = {k: np.float32(v + 0.1 * (i + 1))
                  for i, (k, v) in enumerate(hypers.items())}
    (t_params,), (t_hypers,), _ = convert.from_jax((params,), (hypers,), {})
    assert set(t_params) == set(params) and set(t_hypers) == set(hypers)
    assert t_layer.has_hypers == bool(hypers)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    _close(t_layer.apply(t_params, torch.tensor(x)),
           j_layer.apply(params, x), 1e-6, 1e-6)
    if hypers:
        _close(t_layer.log_prior(t_hypers, t_params),
               j_layer.log_prior(hypers, params), 1e-5, 1e-4)
        _close(t_layer.log_hyper_prior(t_hypers, t_params),
               j_layer.log_hyper_prior(hypers, params), 1e-5, 1e-4)


# ---------------------------------------------------------------------------
# (b) potentials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["classification", "multiclass"])
def test_potentials_match_jax(cell):
    """``make_potentials``' main and hyper value and gradient for the two
    bench models, the multiclass one with class-id labels."""
    if cell == "classification":
        (j_model, t_model), liks = _classification(), _lik(
            "BernoulliLikelihood")
        x, y = _data(liks[0], 64, 10, seed=2)
    else:
        (j_model, t_model), liks = _multiclass(), _lik(
            "CategoricalLikelihood")
        x, y = _data(liks[0], 16, 2, seed=3, n_classes=3)
    params, hypers, j_flat, t_flat = _flats(j_model, liks[0])
    rng = np.random.default_rng(4)
    c = 4
    thetas = (np.asarray(j_flat.theta)[None] + 0.3 * rng.normal(
        size=(c, j_flat.theta.size))).astype(np.float32)
    etas = (np.asarray(j_flat.eta)[None] + 0.05 * rng.normal(
        size=(c, j_flat.eta.size))).astype(np.float32)
    jp = j_potentials(j_model, liks[0], jnp.asarray(x), jnp.asarray(y),
                      j_flat.unravel_theta, j_flat.unravel_eta)
    tp = t_potentials(t_model, liks[1], torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta)
    th, et = torch.tensor(thetas), torch.tensor(etas)
    # tolerances of tests/test_torch_model.py's flagship potentials
    for got, want in ((tp.main_vg(th, et), jax.vmap(jp.main_vg)(thetas,
                                                                etas)),
                      (tp.hyper_vg(et, th), jax.vmap(jp.hyper_vg)(etas,
                                                                  thetas))):
        _close(got[0], want[0], 1e-5, 1e-2)
        _close(got[1], want[1], 1e-4, 1e-2)


# ---------------------------------------------------------------------------
# (c) K1 variant (d): the twin against the Pallas K1
# ---------------------------------------------------------------------------

#: the cases of tests/test_fused_trajectory.py (line), plus a LeakyRelu
#: one: (layers, likelihood, kwargs, d_in, L, eps, classes)
K1_CASES = {
    "learned_sd": ([_l("GaussianDenseLayer", 2, 8), _l("Tanh"),
                    _l("GaussianDenseLayer", 8, 1)],
                   ("GaussianLikelihood", {"sd": 0.2}), 2, 7, 1e-2, None),
    "bernoulli": ([_l("GaussianDenseLayer", 2, 6), _l("Tanh"),
                   _l("GaussianDenseLayer", 6, 1), _l("Sigmoid")],
                  ("BernoulliLikelihood", {}), 2, 9, 5e-2, None),
    "cauchy_compat": ([_l("CauchyDenseLayer", 1, 8), _l("Tanh"),
                       _l("CauchyDenseLayer", 8, 1)],
                      ("FixedGaussianLikelihood", {"sd": 0.1}), 1, 9, 5e-3,
                      None),
    "cauchy_proper": ([_l("CauchyDenseLayer", 2, 6, proper=True),
                       _l("Tanh"),
                       _l("CauchyDenseLayer", 6, 1, proper=True)],
                      ("FixedGaussianLikelihood", {"sd": 0.1}), 2, 7, 1e-2,
                      None),
    "mixed_priors": ([_l("GaussianDenseLayer", 1, 6), _l("Tanh"),
                      _l("CauchyDenseLayer", 6, 1)],
                     ("FixedGaussianLikelihood", {"sd": 0.1}), 1, 5, 1e-2,
                     None),
    "squareprelu_bernoulli": ([_l("GaussianDenseLayer", 2, 6),
                               _l("SquarePrelu", 6),
                               _l("GaussianDenseLayer", 6, 1),
                               _l("Sigmoid")],
                              ("BernoulliLikelihood", {}), 2, 7, 2e-2, None),
    "prelu": ([_l("GaussianDenseLayer", 1, 5), _l("Prelu", 5),
               _l("GaussianDenseLayer", 5, 1)],
              ("FixedGaussianLikelihood", {"sd": 0.1}), 1, 6, 5e-3, None),
    "softmax_categorical": ([_l("GaussianDenseLayer", 2, 6), _l("Tanh"),
                             _l("GaussianDenseLayer", 6, 3), _l("Softmax")],
                            ("CategoricalLikelihood", {}), 2, 7, 2e-2, 3),
    "leakyrelu": ([_l("GaussianDenseLayer", 2, 6), _l("LeakyRelu", 0.2),
                   _l("GaussianDenseLayer", 6, 6), _l("LeakyRelu"),
                   _l("GaussianDenseLayer", 6, 1)],
                  ("FixedGaussianLikelihood", {"sd": 0.1}), 2, 7, 1e-2,
                  None),
}


def _k1_pair(case, mode, c=4, tempered=False):
    """Both packages' K1 for ``case`` and the inputs of one trajectory, as
    tests/test_fused_trajectory.py:46-59 draws them: 0.3 N(0, 1) weights,
    N(0, 1) momenta, (eps, L) shared or per chain."""
    specs, (lik_name, lik_kw), d_in, steps, eps, n_classes = K1_CASES[case]
    j_model, t_model = _both(*specs)
    j_lik, t_lik = _lik(lik_name, **lik_kw)
    x, y = _data(j_lik, 11, d_in, n_classes=n_classes)
    _, _, j_flat, t_flat = _flats(j_model, j_lik)
    h = j_flat.eta.size
    j_traj = j_fused.try_build_fused_trajectory(
        j_model, j_lik, j_flat.unravel_theta, j_flat.unravel_eta, x, y,
        eta_dim=h, block_c=c, interpret=True, tempered=tempered)
    t_traj = fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=h, tempered=tempered)
    assert j_traj is not None and t_traj is not None
    rng = np.random.default_rng(1)
    thetas = (0.3 * rng.normal(size=(c, j_flat.theta.size))).astype(
        np.float32)
    etas = np.tile(np.asarray(j_flat.eta)[None], (c, 1)).astype(np.float32)
    momenta = rng.normal(size=thetas.shape).astype(np.float32)
    if mode == "shared":
        eps_a, l_a = np.float32(eps), np.int32(steps)
        t_eps, t_l = float(eps), int(steps)
    else:
        eps_a = (eps * np.asarray([1.0, 0.5, 0.25, 1.0])).astype(np.float32)
        l_a = np.asarray([steps, steps - 2, 3, 1], np.int32)
        t_eps, t_l = torch.tensor(eps_a), torch.tensor(l_a)
    j_in = (jnp.asarray(thetas), jnp.asarray(etas), jnp.asarray(momenta), x,
            y, jnp.asarray(eps_a), jnp.asarray(l_a))
    t_in = (torch.tensor(thetas), torch.tensor(etas), torch.tensor(momenta),
            torch.tensor(x), torch.tensor(y), t_eps, t_l)
    return j_traj, t_traj, j_in, t_in


def _check_k1(got, want):
    tq, tv, tlp0, tlp1 = got
    jq, jv, jlp0, jlp1 = want
    for label, g, w, (rtol, atol) in zip(
            ("lp0", "q", "v", "lp1"), (tlp0, tq, tv, tlp1),
            (jlp0, jq, jv, jlp1), K1_TOL):
        _close(g, w, rtol, atol, label)


@pytest.mark.parametrize("mode", ["shared", "per_chain"])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_d_twin_matches_pallas(case, mode):
    j_traj, t_traj, j_in, t_in = _k1_pair(case, mode)
    program = t_traj.args[0]
    assert program.lik == {"bernoulli": "bernoulli",
                           "squareprelu_bernoulli": "bernoulli",
                           "softmax_categorical": "categorical"}.get(
                               case, "gaussian")
    assert (program.sd_idx is not None) == (case == "learned_sd")
    launches = fused_mlp.fused_trajectory.LAUNCHES
    got = t_traj(*t_in)
    # CPU tensors take the twin: no kernel launch is counted
    assert fused_mlp.fused_trajectory.LAUNCHES == launches
    _check_k1(got, j_traj(*j_in))


@pytest.mark.parametrize("mode", ["shared", "per_chain"])
def test_k1_d_tempered_bernoulli_twin_matches_pallas(mode):
    """The tempered program (variant (c)) under the Bernoulli tail and
    SquarePrelu: beta scales the tail's value and gradient."""
    j_traj, t_traj, j_in, t_in = _k1_pair("squareprelu_bernoulli", mode,
                                          tempered=True)
    betas = np.asarray([1.0, 0.5, 0.2, 0.05], np.float32)
    _check_k1(t_traj(*t_in, torch.tensor(betas)),
              j_traj(*j_in, jnp.asarray(betas)))


def test_k1_d_program_tables():
    """The op and prior tables K1 reads (leakyrelu's alpha as float32
    bits, each prior block's kind and sign) and the build it launches."""
    _, t_traj, _, _ = _k1_pair("leakyrelu", "shared")
    ops_t, prior_t = t_traj.args[0].tables("cpu")
    assert ops_t.shape == (5, 4) and prior_t.shape == (6, 5)
    assert ops_t[1, 0] == fused_mlp.OP_CODES["leakyrelu"]
    alphas = ops_t[:, 3].numpy().view(np.float32)
    assert alphas[1] == np.float32(0.2) and alphas[3] == np.float32(0.3)
    _, t_traj, _, _ = _k1_pair("cauchy_proper", "shared")
    _, prior_t = t_traj.args[0].tables("cpu")
    assert (prior_t[:, 0] == fused_mlp.PRIOR_CODES["cauchy"]).all()
    assert (prior_t[:, 4] == -1).all()
    # the kernel's general build for every program but those of the
    # Gaussian tail, gauss priors and the five activations
    assert t_traj.args[0].full
    for case, full in (("learned_sd", False), ("bernoulli", True),
                       ("prelu", True), ("leakyrelu", True),
                       ("mixed_priors", True)):
        assert _k1_pair(case, "shared")[1].args[0].full == full, case


# ---------------------------------------------------------------------------
# (d) K3's tails and ops: the twin against the Pallas K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prelu", "sqprelu", "leakyrelu", "elu",
                                  "sigmoid", "exp"])
def test_k3_ops_twin_matches_pallas(kind):
    """The ops of tests/test_fused_mlp.py:91-112, slope rows included,
    under the Gaussian tail."""
    rng = np.random.default_rng(3)
    n, c, d = 9, 4, 5
    op = {"leakyrelu": ("leakyrelu", d, 0.3)}.get(kind, (kind, d))
    ops = (("dense", 2, d), op, ("dense", d, 1))
    d_total = sum(fused_mlp._op_rows(o) for o in ops)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    thetas = 0.5 * rng.normal(size=(c, d_total)).astype(np.float32)
    j_vg = j_fused.make_fused_potential_vg(ops, n, lik="gaussian",
                                           block_c=c, interpret=True)
    t_vg = fused_mlp.make_fused_potential_vg(ops, n)
    jl, jg = j_vg(jnp.asarray(thetas), 0.1, x, y)
    tl, tg = t_vg(torch.tensor(thetas), 0.1, torch.tensor(x),
                  torch.tensor(y))
    _close(tl, jl, *K3_TOL[0])
    _close(tg, jg, *K3_TOL[1])


def test_k3_bernoulli_twin_matches_pallas():
    """tests/test_fused_mlp.py:116: SquarePrelu and a sigmoid under the
    Bernoulli tail."""
    rng = np.random.default_rng(4)
    n, c = 13, 4
    ops = (("dense", 3, 6), ("sqprelu", 6), ("dense", 6, 1),
           ("sigmoid", 1))
    d_total = sum(fused_mlp._op_rows(o) for o in ops)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.uniform(size=(n, 1)) > 0.5).astype(np.float32)
    thetas = 0.7 * rng.normal(size=(c, d_total)).astype(np.float32)
    j_vg = j_fused.make_fused_potential_vg(ops, n, lik="bernoulli",
                                           block_c=c, interpret=True)
    t_vg = fused_mlp.make_fused_potential_vg(ops, n, lik="bernoulli")
    jl, jg = j_vg(jnp.asarray(thetas), 1.0, x, y)
    tl, tg = t_vg(torch.tensor(thetas), 1.0, torch.tensor(x),
                  torch.tensor(y))
    _close(tl, jl, *K3_TOL[0])
    _close(tg, jg, *K3_TOL[1])


@pytest.mark.parametrize("labels", ["ids", "onehot"])
def test_k3_categorical_matches_make_potentials(labels):
    """K3's categorical tail (through ``try_build_fused_main_vg``, priors
    added outside it) against ``CategoricalLikelihood`` through the JAX
    package's ``make_potentials``, not against ``reference_potential_vg``,
    which treats categorical as Bernoulli (ROADMAP queue 3)."""
    j_model, t_model = _both(_l("GaussianDenseLayer", 4, 7), _l("Tanh"),
                             _l("GaussianDenseLayer", 7, 5), _l("Softmax"))
    j_lik, t_lik = _lik("CategoricalLikelihood")
    x, y = _data(j_lik, 12, 4, seed=5, n_classes=5)
    if labels == "onehot":
        y = np.eye(5, dtype=np.float32)[y.astype(int)]
    params, hypers, j_flat, t_flat = _flats(j_model, j_lik)
    rng = np.random.default_rng(6)
    c = 4
    thetas = (np.asarray(j_flat.theta)[None] + 0.5 * rng.normal(
        size=(c, j_flat.theta.size))).astype(np.float32)
    etas = np.tile(np.asarray(j_flat.eta)[None], (c, 1)).astype(np.float32)
    h = j_flat.eta.size
    t_vg = fused_mlp.try_build_fused_main_vg(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=h)
    assert t_vg is not None
    jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      j_flat.unravel_theta, j_flat.unravel_eta)
    jv, jg = jax.vmap(jp.main_vg)(thetas, etas)
    tv, tg = t_vg(torch.tensor(thetas), torch.tensor(etas), torch.tensor(x),
                  torch.tensor(y))
    _close(tv, jv, *K3_TOL[0])
    _close(tg, jg, *K3_TOL[1])


@pytest.mark.parametrize("cell", ["classification", "multiclass"])
def test_k3_main_vg_matches_jax(cell):
    """``batched_main_vg`` (K3's twin plus the closed-form priors, the
    SquarePrelu's gauss_raw blocks included) against the JAX package's
    ``try_build_fused_main_vg`` (its K3 in interpret mode plus the priors
    through ``jax.grad``) at the bench models."""
    if cell == "classification":
        (j_model, t_model), (j_lik, t_lik) = _classification(4, 6), _lik(
            "BernoulliLikelihood")
        x, y = _data(j_lik, 16, 4, seed=7)
    else:
        (j_model, t_model), (j_lik, t_lik) = _multiclass(), _lik(
            "CategoricalLikelihood")
        x, y = _data(j_lik, 16, 2, seed=8, n_classes=3)
    params, hypers, j_flat, t_flat = _flats(j_model, j_lik)
    rng = np.random.default_rng(9)
    c, h = 4, j_flat.eta.size
    thetas = (np.asarray(j_flat.theta)[None] + 0.3 * rng.normal(
        size=(c, j_flat.theta.size))).astype(np.float32)
    etas = (np.asarray(j_flat.eta)[None] + 0.05 * rng.normal(
        size=(c, h))).astype(np.float32)
    j_vg = j_fused.try_build_fused_main_vg(
        j_model, j_lik, j_flat.unravel_theta, j_flat.unravel_eta, x, y,
        eta_dim=h, block_c=c, interpret=True)
    t_vg = fused_mlp.try_build_fused_main_vg(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=h)
    assert j_vg is not None and t_vg is not None
    jv, jg = j_vg(jnp.asarray(thetas), jnp.asarray(etas), x, y)
    tv, tg = t_vg(torch.tensor(thetas), torch.tensor(etas), torch.tensor(x),
                  torch.tensor(y))
    _close(tv, jv, *K3_TOL[0])
    _close(tg, jg, *K3_TOL[1])


# ---------------------------------------------------------------------------
# (e) the stats layout and K2
# ---------------------------------------------------------------------------

def test_stats_layout_and_k2_match_jax():
    """The multiclass model's hyper block: the port's stats layout equals
    the JAX one (uncoupled), and K2's twin matches the Pallas K2 in
    interpret mode on its stats; the SquarePrelu stack has no stats layout
    in either package."""
    (j_model, t_model), (j_lik, t_lik) = _multiclass(), _lik(
        "CategoricalLikelihood")
    x, y = _data(j_lik, 16, 2, seed=3, n_classes=3)
    _, _, j_flat, t_flat = _flats(j_model, j_lik)
    h = j_flat.eta.size
    j_layout = j_probe(j_model, j_lik, j_flat.unravel_eta, h)
    t_layout = t_probe(t_model, t_lik, t_flat.unravel_eta, h)
    assert t_layout is not None and t_layout[1:] == (False, None)
    assert t_layout == j_layout

    rng = np.random.default_rng(10)
    c, n_steps = 4, 5
    thetas = (np.asarray(j_flat.theta)[None] + 0.3 * rng.normal(
        size=(c, j_flat.theta.size))).astype(np.float32)
    etas = (np.asarray(j_flat.eta)[None] + 0.05 * rng.normal(
        size=(c, h))).astype(np.float32)
    j_stats_fn, _, _ = j_stats(j_model, j_lik, jnp.asarray(x),
                               jnp.asarray(y), j_flat.unravel_eta, h)
    stats = np.asarray(j_stats_fn(jax.vmap(j_flat.unravel_theta)(thetas)))
    momenta = rng.normal(size=etas.shape).astype(np.float32)
    eps = (0.01 + 0.01 * rng.random(c)).astype(np.float32)
    j_traj = j_hyper_build(j_model, j_lik, j_flat.unravel_eta, h,
                           n_steps=n_steps, block_c=c, interpret=True)
    t_traj = fused_hyper.try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, h, n_steps)
    assert j_traj is not None and t_traj is not None
    got = t_traj(torch.tensor(etas), torch.tensor(stats),
                 torch.tensor(momenta), torch.tensor(eps))
    # tolerances of tests/test_fused_hyper.py
    for g, w, (rtol, atol) in zip(got, j_traj(etas, stats, momenta, eps),
                                  ((1e-4, 1e-5), (1e-4, 1e-4),
                                   (1e-4, 1e-3), (1e-4, 1e-3))):
        _close(g, w, rtol, atol)

    (j_cls, t_cls), (jb, tb) = _classification(), _lik("BernoulliLikelihood")
    _, _, jc_flat, tc_flat = _flats(j_cls, jb)
    hc = jc_flat.eta.size
    assert j_probe(j_cls, jb, jc_flat.unravel_eta, hc) is None
    assert t_probe(t_cls, tb, tc_flat.unravel_eta, hc) is None


# ---------------------------------------------------------------------------
# (f) three epochs with injected JAX draws
# ---------------------------------------------------------------------------

def _jax_draws(keys, d, h):
    """The draws one JAX epoch takes from its per-chain keys
    (gibbs.py:163-166; each block key splits into (momentum, MH coin))."""
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


@pytest.mark.parametrize("path", ["K1", "plain"])
@pytest.mark.parametrize("cell", ["classification", "multiclass"])
def test_three_epochs_match_jax_with_injected_draws(cell, path):
    """Three epochs of the port, its main block on K1's twin or on the
    plain potential and its hyper block on K2's twin (multiclass) or plain
    (the SquarePrelu stack), against three of the JAX package (its XLA
    path) from one state with JAX's own draws: the ``classification``
    stack narrowed to 4-6-6-1 over 16 rows, ``multiclass`` at its bench
    size with class-id labels. Tolerances of
    test_torch_sampler.py::test_three_epochs_match_jax_with_injected_draws."""
    if cell == "classification":
        (j_model, t_model), (j_lik, t_lik) = _classification(4, 6), _lik(
            "BernoulliLikelihood")
        x, y = _data(j_lik, 16, 4, seed=2)
        eps, steps, hyper_steps = 2e-2, 8, 10
    else:
        (j_model, t_model), (j_lik, t_lik) = _multiclass(), _lik(
            "CategoricalLikelihood")
        x, y = _data(j_lik, 16, 2, seed=3, n_classes=3)
        eps, steps, hyper_steps = 1e-2, 10, 5
    params, hypers, j_flat, t_flat = _flats(j_model, j_lik)
    c, d, h = 4, j_flat.theta.size, j_flat.eta.size
    kw = dict(adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
              mu=math.log(100 * 1e-3), eta_dim=h)
    j_fn = jax.jit(j_epoch(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                           j_flat.unravel_theta, j_flat.unravel_eta, **kw))
    xt, yt = torch.tensor(x), torch.tensor(y)
    kernels = {}
    if path == "K1":
        kernels["batched_main_traj"] = fused_mlp.try_build_fused_trajectory(
            t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
            h)
        hyper = fused_hyper.try_build_fused_hyper_trajectory(
            t_model, t_lik, t_flat.unravel_eta, h, hyper_steps)
        assert (hyper is None) == (cell == "classification")
        kernels["batched_hyper_traj"] = hyper
        assert kernels["batched_main_traj"] is not None
    t_fn = t_epoch(t_model, t_lik, xt, yt, t_flat.unravel_theta,
                   t_flat.unravel_eta, **kernels, **kw)

    j_carry = j_init(j_flat.theta, j_flat.eta, jax.random.key(1), 1e-3, c,
                     jitter=0.05)
    t_carry = ChainState(*(torch.tensor(np.asarray(getattr(j_carry, f)))
                           for f in ChainState._fields))
    for _ in range(3):
        draws = _jax_draws(j_carry.key, d, h)
        j_carry, j_tr = j_fn(j_carry, jnp.asarray(eps, jnp.float32),
                             jnp.asarray(steps, jnp.int32))
        t_carry, t_tr = t_fn(t_carry, eps, steps, None, draws=draws)
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


# ---------------------------------------------------------------------------
# (g) the driver: Network.train and its routing
# ---------------------------------------------------------------------------

def _net(cell, module=T, seed=0, **kw):
    """A Network of the bench's ``classification`` stack narrowed to
    4-6-6-1 over 32 rows, or of ``multiclass`` at its bench size with
    class-id labels."""
    rng = np.random.default_rng(2 if cell == "classification" else 3)
    if cell == "classification":
        x = rng.normal(size=(32, 4)).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.float32)
        layers = [module.GaussianDenseLayer(4, 6), module.SquarePrelu(6),
                  module.GaussianDenseLayer(6, 6), module.SquarePrelu(6),
                  module.GaussianDenseLayer(6, 1), module.Sigmoid()]
        lik = module.BernoulliLikelihood()
        # a warm start of the first slopes, as the tutorial passes them
        start = {1: {"slopes": np.linspace(0.3, 0.8, 6).astype(np.float32)}}
    else:
        x = rng.normal(size=(16, 2)).astype(np.float32)
        y = rng.integers(0, 3, size=16).astype(np.float32)
        layers = [module.GaussianDenseLayer(2, 8), module.Tanh(),
                  module.GaussianDenseLayer(8, 3), module.Softmax()]
        lik = module.CategoricalLikelihood()
        start = {}
    net = module.Network(np.float32, x.shape[1], x, y, x, y, seed=seed,
                         **kw)
    for i, layer in enumerate(layers):
        net.add(layer, parameters=start.get(i))
    return net, lik


@pytest.mark.parametrize("cell", ["classification", "multiclass"])
def test_network_train_runs_on_cpu(cell):
    """``Network.train`` with each likelihood (categorical on class ids)
    through K1's twin: the warm-started slopes of ``add(...,
    parameters=...)``, finite samples, acceptance in (0, 1], the hyper
    block on K2's twin for multiclass and plain for the SquarePrelu stack,
    and the posterior-mean prediction fitting the training labels better
    than chance."""
    net, lik = _net(cell, device="cpu")
    net.setup_mcmc(burnin=10, step_size_start=5e-3, step_size_min=1e-3,
                   step_size_max=1e-2, leapfrog_start=10, leapfrog_min=5,
                   leapfrog_max=20, leapfrog_increment=5, averaging_steps=5,
                   random_steps=2, hyper_leapfrog=5, hyper_step_size=1e-3)
    res = net.train(20, 1, lik, n_chains=4, chain_jitter=0.01,
                    verbose=False)
    assert res.main_path == "K1"
    assert res.fused_hyper == (cell == "multiclass")
    s, c, d = res.theta_samples.shape
    assert (s, c) == (10, 4)
    assert np.isfinite(res.theta_samples).all()
    assert np.isfinite(res.eta_samples).all()
    assert 0.0 < res.main_accept.mean() <= 1.0
    assert 0.0 < res.hyper_accept.mean() <= 1.0
    params, hypers = net.init_state()
    if cell == "classification":
        np.testing.assert_array_equal(
            params[1]["slopes"].numpy(),
            np.linspace(0.3, 0.8, 6, dtype=np.float32))
        np.testing.assert_array_equal(params[3]["slopes"].numpy(),
                                      np.full(6, 0.2, np.float32))
    unravel = t_flatten(params, hypers, {}).unravel_theta
    preds = torch.func.vmap(lambda th: net.model.apply(
        unravel(th), net.train_x))(torch.tensor(res.theta_pooled)).mean(0)
    y = net.train_y.numpy()
    if cell == "classification":
        acc = ((preds[:, 0].numpy() > 0.5) == (y > 0.5)).mean()
    else:
        acc = (preds.numpy().argmax(1) == y.astype(int)).mean()
    assert acc > (0.5 if cell == "classification" else 1.0 / 3.0), acc


def _routes(t_model, t_lik, j_model, j_lik, x, y):
    """(K1 accepts, K3 accepts, K2 accepts) in the port; in the JAX package
    (interpret mode, 128-chain blocks) K1's acceptance at the data's rows
    and at one row (its TPU VMEM gate aside: the program, the priors and
    the unrolled-layer gate), and K2's."""
    params, hypers = j_model.init(jax.random.key(0))
    lik_h = j_lik.init_hypers()
    j_flat = j_flatten(params, hypers, lik_h)
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    h = j_flat.eta.size
    xt, yt = torch.tensor(x), torch.tensor(y)
    port = (
        fused_mlp.try_build_fused_trajectory(
            t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
            h) is not None,
        fused_mlp.try_build_fused_main_vg(
            t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta, xt, yt,
            h) is not None,
        fused_hyper.try_build_fused_hyper_trajectory(
            t_model, t_lik, t_flat.unravel_eta, h, 5) is not None)
    jax_ = tuple(
        j_fused.try_build_fused_trajectory(
            j_model, j_lik, j_flat.unravel_theta, j_flat.unravel_eta, x, y,
            eta_dim=h, block_c=128, interpret=True, n_rows=n) is not None
        for n in (x.shape[0], 1)) + (
        j_hyper_build(j_model, j_lik, j_flat.unravel_eta, h, 5,
                      interpret=True) is not None,)
    return port, jax_


@pytest.mark.parametrize("cell", ["classification", "multiclass",
                                  "learned_sd_flagship", "cauchy",
                                  "tutorial"])
def test_driver_routes_as_jax(cell):
    """The main and hyper kernels each model gets, in the port and in the
    JAX package: K1 for the bench's two classification models, the
    learned-sd flagship and a Cauchy model; K3 for the tutorial-shaped
    model (784 inputs over 9,585 rows, past K1's shared memory here and
    past the JAX K1's unrolled-layer gate there); K2 for multiclass and
    the learned-sd flagship; the plain hyper block for the SquarePrelu
    stacks and Cauchy priors. The one difference is a gate of the TPU
    that the port does not carry: at the ``classification`` cell's 64
    rows the JAX K1 needs 14.5 MB of VMEM at 128-chain blocks, over its
    12 MB budget, so the JAX package runs that cell's main block on its
    K3 or XLA; the port's K1 holds it in 34 KB of shared memory."""
    rng = np.random.default_rng(0)
    if cell in ("classification", "multiclass"):
        (j_model, t_model), (j_lik, t_lik) = (
            (_classification(), _lik("BernoulliLikelihood"))
            if cell == "classification" else
            (_multiclass(), _lik("CategoricalLikelihood")))
        n, d_in = (64, 10) if cell == "classification" else (16, 2)
        x, y = _data(j_lik, n, d_in, n_classes=3)
        want = (True, True, cell == "multiclass")
    elif cell == "tutorial":
        j_model, t_model = _both(
            _l("GaussianDenseLayer", 784, 20),
            _l("SquarePrelu", 20, alpha=math.sqrt(0.1)),
            _l("GaussianDenseLayer", 20, 20), _l("SquarePrelu", 20),
            _l("GaussianDenseLayer", 20, 1), _l("Sigmoid"))
        j_lik, t_lik = _lik("BernoulliLikelihood")
        x = rng.uniform(size=(9585, 784)).astype(np.float32)
        y = (x @ rng.normal(size=784) > 0).astype(np.float32)
        want = (False, True, False)
    else:
        dense = ("CauchyDenseLayer" if cell == "cauchy"
                 else "GaussianDenseLayer")
        j_model, t_model = _both(
            _l(dense, 1, 10), _l("Tanh"), _l(dense, 10, 10), _l("Tanh"),
            _l(dense, 10, 10), _l("Tanh"), _l(dense, 10, 1))
        j_lik, t_lik = (_lik("FixedGaussianLikelihood", sd=0.1)
                        if cell == "cauchy"
                        else _lik("GaussianLikelihood", sd=0.1))
        x = np.linspace(-2, 2, 11).astype(np.float32)[:, None]
        y = np.sin(x[:, 0]).astype(np.float32)
        want = (True, True, cell != "cauchy")
    port, (j_k1, j_k1_scope, j_k2) = _routes(t_model, t_lik, j_model,
                                             j_lik, x, y)
    assert port == want
    assert (j_k1_scope, j_k2) == (want[0], want[2])
    assert j_k1 == (want[0] and cell != "classification")


# ---------------------------------------------------------------------------
# (h) the op program's scope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "multiclass", "classification", "softmax_not_last",
    "softmax_with_bernoulli", "softmax_with_gaussian",
    "categorical_without_softmax", "softmax_only", "leakyrelu_first",
    "prelu_width", "activation_first"])
def test_model_program_scope_matches_jax(case):
    """``_model_program`` accepts and rejects what the JAX one does
    (tests/test_fused_trajectory.py:144 and fused_mlp.py:1046-1110): a
    trailing Softmax folds into the categorical tail; a softmax anywhere
    else, or without ``CategoricalLikelihood``, is out of scope."""
    d = ("GaussianDenseLayer", 2, 3)
    specs, lik = {
        "multiclass": ([_l(*d), _l("Tanh"), _l("GaussianDenseLayer", 3, 3),
                        _l("Softmax")], "CategoricalLikelihood"),
        "classification": ([_l(*d), _l("SquarePrelu", 3),
                            _l("GaussianDenseLayer", 3, 1), _l("Sigmoid")],
                           "BernoulliLikelihood"),
        "softmax_not_last": ([_l(*d), _l("Softmax"),
                              _l("GaussianDenseLayer", 3, 3)],
                             "CategoricalLikelihood"),
        "softmax_with_bernoulli": ([_l(*d), _l("Softmax")],
                                   "BernoulliLikelihood"),
        "softmax_with_gaussian": ([_l(*d), _l("Softmax")],
                                  "FixedGaussianLikelihood"),
        "categorical_without_softmax": ([_l(*d), _l("Tanh")],
                                        "CategoricalLikelihood"),
        "softmax_only": ([_l("Softmax")], "CategoricalLikelihood"),
        "leakyrelu_first": ([_l("LeakyRelu"), _l(*d)],
                            "FixedGaussianLikelihood"),
        "prelu_width": ([_l(*d), _l("Prelu", 4)],
                        "FixedGaussianLikelihood"),
        "activation_first": ([_l("Tanh"), _l(*d)],
                             "FixedGaussianLikelihood"),
    }[case]
    j_model, t_model = _both(*specs)
    j_lik, t_lik = _lik(lik)
    got = fused_mlp._model_program(t_model, t_lik)
    assert got == j_fused._model_program(j_model, j_lik)
    assert (got is not None) == (case in ("multiclass", "classification"))


def test_k1_declines_big_data_as_jax():
    """tests/test_fused_trajectory.py:144: 5,000,000 rows are past K1's
    shared memory, as they are past the JAX K1's VMEM."""
    (j_model, t_model) = _both(_l("GaussianDenseLayer", 1, 4), _l("Tanh"),
                               _l("GaussianDenseLayer", 4, 1))
    j_lik, t_lik = _lik("FixedGaussianLikelihood", sd=0.1)
    _, _, j_flat, t_flat = _flats(j_model, j_lik)
    x, y = np.zeros((5, 1), np.float32), np.zeros((5,), np.float32)
    assert j_fused.try_build_fused_trajectory(
        j_model, j_lik, j_flat.unravel_theta, j_flat.unravel_eta, x, y,
        eta_dim=j_flat.eta.size, interpret=True, n_rows=5_000_000) is None
    assert fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=t_flat.eta.numel(),
        n_rows=5_000_000) is None
    assert fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y),
        eta_dim=t_flat.eta.numel()) is not None
