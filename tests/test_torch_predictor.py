"""The port's ``Predictor`` against the JAX package's, each reading the
other's store.

A posterior of the 1-10-10-1 trig net (4 chains x 48 draws, an AR(1)
walk per chain around its own offset, made with numpy from a seed) is
written by both packages, as the reference text store and as the npz
store; both Predictors read every store and must agree on ``predict``,
``predict_mean_sd``, ``predict_quantiles``, ``reweight`` (a Gaussian-to-
Cauchy prior swap) and ``autocorrelation_length`` within float32
tolerances. The port writes chain ids in every store, so its multichain
stores get the per-chain autocorrelation time; the JAX package's npz and
buffered stores have none and give the pooled one.
"""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.io import checkpoint as j_ckpt, \
    reference_format as j_ref
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.network import Network as JNetwork
from tensorbnn_tpu.predictor import Predictor as JPredictor
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.io import checkpoint as t_ckpt, \
    reference_format as t_ref
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.predictor import Predictor as TPredictor
from tensorbnn_tpu_torch.utils import autocorr

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
C, S = 4, 48
X = np.linspace(-2, 2, 11).astype(np.float32)
Y = (np.sin(X * math.pi * 2) * X - np.cos(X * math.pi)).astype(np.float32)
X_TEST = np.linspace(-1.5, 1.5, 7).astype(np.float32)[:, None]


def _layers(pkg, dense="GaussianDenseLayer"):
    widths = ((1, 10), (10, 10), (10, 1))
    out = []
    for i, (a, b) in enumerate(widths):
        out.append(getattr(pkg, dense)(a, b))
        if i < len(widths) - 1:
            out.append(pkg.Tanh())
    return out


def _posterior():
    """Chain-major numpy sample trees (C * S networks) and their chain
    ids: each chain an AR(1) walk around the JAX init plus its own
    offset."""
    model = JSequential(_layers(J))
    params, hypers = model.init(jax.random.key(0))
    flat = j_flatten(params, hypers, {})
    d, h = flat.theta.size, flat.eta.size
    rng = np.random.default_rng(0)
    theta = np.empty((C, S, d), np.float32)
    for c in range(C):
        walk = np.zeros(d)
        for s in range(S):
            walk = 0.8 * walk + 0.02 * rng.normal(size=d)
            theta[c, s] = np.asarray(flat.theta) + 0.05 * c + walk
    eta = (np.asarray(flat.eta) + 0.05 * rng.normal(size=(C, S, h))).astype(
        np.float32)
    p_s = jax.tree.map(np.asarray, jax.vmap(flat.unravel_theta)(
        jnp.asarray(theta.reshape(C * S, d))))
    h_s, lik_s = jax.tree.map(np.asarray, jax.vmap(flat.unravel_eta)(
        jnp.asarray(eta.reshape(C * S, h))))
    return p_s, h_s, lik_s, np.repeat(np.arange(C), S)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{(writer, format): directory} for writer in (jax, torch) and format
    in (text, npz)."""
    p_s, h_s, lik_s, chains = _posterior()
    lik_j, lik_t = J.FixedGaussianLikelihood(0.1), T.FixedGaussianLikelihood(
        0.1)
    out = {}
    for writer in ("jax", "torch"):
        for fmt in ("text", "npz"):
            d = str(tmp_path_factory.mktemp(f"{writer}_{fmt}"))
            if writer == "jax":
                j_ref.save_run(d, JSequential(_layers(J)), lik_j, p_s, h_s,
                               lik_s, 16)
                if fmt == "npz":
                    j_ckpt.save_samples(d, p_s, h_s, lik_s)
            else:
                t_ref.save_run(d, TSequential(_layers(T)), lik_t, p_s, h_s,
                               lik_s, 16, chain_ids=chains)
                if fmt == "npz":
                    t_ckpt.save_samples(d, p_s, h_s, lik_s,
                                        chain_index=chains)
            out[writer, fmt] = d
    return out


def _pair(d):
    return (JPredictor(d, likelihood=J.FixedGaussianLikelihood(0.1)),
            TPredictor(d, likelihood=T.FixedGaussianLikelihood(0.1),
                       device="cpu"))


@pytest.mark.parametrize("writer,fmt", [("jax", "text"), ("jax", "npz"),
                                        ("torch", "text"),
                                        ("torch", "npz")])
def test_each_predictor_reads_the_others_store(stores, writer, fmt):
    jp, tp = _pair(stores[writer, fmt])
    assert tp.n_networks == jp.n_networks == C * S
    for n in (1, 3):
        np.testing.assert_allclose(tp.predict(X_TEST, n),
                                   jp.predict(X_TEST, n), rtol=RTOL,
                                   atol=ATOL)
    for got, want in zip(tp.predict_mean_sd(X_TEST),
                         jp.predict_mean_sd(X_TEST)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.predict_quantiles(X_TEST, 2),
                               jp.predict_quantiles(X_TEST, 2), rtol=RTOL,
                               atol=ATOL)
    # the Gaussian-to-Cauchy prior swap, likelihood term included
    w_t = tp.reweight(_layers(T, "CauchyDenseLayer"), X[:, None], Y,
                      likelihood=T.FixedGaussianLikelihood(0.1))
    w_j = jp.reweight(_layers(J, "CauchyDenseLayer"), X[:, None], Y,
                      likelihood=J.FixedGaussianLikelihood(0.1))
    assert np.isfinite(w_t).all() and w_t.sum() == pytest.approx(1.0)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(tp.extract_hyper_parameters(),
                               jp.extract_hyper_parameters())
    for got, want in zip(tp.parameter_statistics(),
                         jp.parameter_statistics()):
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)
    # autocorrelation: the same estimate wherever both see the same chain
    # ids; the JAX reader ignores the ids of the port's npz store
    tau_t = tp.autocorrelation_length(X_TEST, 1000)
    if (writer, fmt) == ("torch", "npz"):
        jp = _pair(stores["torch", "text"])[0]
    assert tau_t == pytest.approx(jp.autocorrelation_length(X_TEST, 1000),
                                  rel=RTOL)
    np.testing.assert_allclose(tp.autocorrelation(X_TEST, 10),
                               jp.autocorrelation(X_TEST, 10), rtol=1e-4,
                               atol=ATOL)


def test_multichain_store_gives_the_per_chain_tau(stores):
    """Every store the port writes yields each chain's tau, averaged; the
    JAX package's buffered stores give the pooled chain-major value, which
    the chains' offsets inflate."""
    tp = _pair(stores["torch", "npz"])[1]
    np.testing.assert_array_equal(tp.chain_index,
                                  np.repeat(np.arange(C), S))
    assert tp._chain_blocks() == [(c * S, (c + 1) * S) for c in range(C)]
    out = tp.predict(X_TEST)[..., 0].T                # (points, C * S)
    per_chain = np.concatenate([autocorr.integrated_time_batch(
        out[:, c * S:(c + 1) * S]) for c in range(C)])
    want = float(per_chain[~np.isnan(per_chain)].mean())
    for store in (("torch", "npz"), ("torch", "text")):
        assert _pair(stores[store])[1].autocorrelation_length(
            X_TEST, 1000) == pytest.approx(want, rel=1e-12)
    pooled = _pair(stores["jax", "npz"])[0].autocorrelation_length(
        X_TEST, 1000)
    assert pooled > 1.5 * want


def test_reweight_takes_an_architecture_file_and_refuses_data(stores,
                                                             tmp_path):
    jp, tp = _pair(stores["torch", "text"])
    arch = tmp_path / "cauchy.txt"
    arch.write_text("dense\ntanh\ndense\ntanh\ndense\n")
    np.testing.assert_allclose(tp.reweight(str(arch)), jp.reweight(str(arch)),
                               rtol=1e-4, atol=ATOL)
    with pytest.raises(TypeError, match="architecture"):
        tp.reweight(X_TEST)
    np.testing.assert_allclose(
        tp.train_probs(X[:, None], Y, 2, T.FixedGaussianLikelihood(0.1)),
        jp.train_probs(X[:, None], Y, 2, J.FixedGaussianLikelihood(0.1)),
        rtol=RTOL)


def test_predictor_refuses_a_mesh_and_needs_a_card(stores):
    """A mesh is carried now (tests/test_torch_mesh.py holds the sharded
    predictions against the JAX package's): on the constructor and on a
    call, a 2x2 mesh of CPU entries gives the unsharded predictions; the
    Predictor still needs a card unless told the CPU."""
    from tensorbnn_tpu_torch.parallel.mesh import make_mesh
    d = stores["torch", "npz"]
    mesh = make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    tp = TPredictor(d, device="cpu")
    want = tp.predict(X_TEST)
    np.testing.assert_allclose(
        TPredictor(d, device="cpu", mesh=mesh).predict(X_TEST), want,
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp.predict(X_TEST, mesh=mesh), want,
                               rtol=1e-6, atol=1e-7)
    assert T.predictor is T.Predictor
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TPredictor(d)


def _trig_network(pkg, seed=3, **kw):
    if pkg is J:
        net = JNetwork(jnp.float32, 1, X, Y, X[::2], Y[::2], seed=seed)
    else:
        net = T.Network(torch.float32, 1, X, Y, X[::2], Y[::2], seed=seed,
                        **kw)
    for layer in _layers(pkg):
        net.add(layer)
    return net


def test_network_predict_matches_jax():
    """``Network.predict`` on the train and validation splits at the JAX
    package's parameters, carried over by ``convert``."""
    jnet = _trig_network(J)
    tnet = _trig_network(T, device="cpu")
    params, _ = jnet.init_state()
    t_params, _, _ = convert.from_jax(params, (), {})
    for train in (True, False):
        np.testing.assert_allclose(
            tnet.predict(train, t_params).numpy(),
            np.asarray(jnet.predict(train, params)), rtol=RTOL, atol=ATOL)
    # without params, a fresh initial state of the right shape
    assert tnet.predict(False).shape == (6, 1)


def test_predictor_reads_a_runs_buffered_and_streamed_stores(tmp_path):
    """A port run with ``folder_name`` (buffered) and the same run streamed
    (``keep_samples=False``): the text store, the npz store and the
    streamed store all load to the run's chain-major ensemble, bit for
    bit, and ``predict`` equals ``model.apply`` over the run's samples."""
    lik = T.FixedGaussianLikelihood(0.1)

    def run(folder, **kw):
        net = _trig_network(T, device="cpu")
        net.setup_mcmc(burnin=4, leapfrog_start=8, leapfrog_min=8,
                       leapfrog_max=12, averaging_steps=4, hyper_leapfrog=5,
                       step_size_start=2e-3)
        return net, net.train(16, 2, lik, n_chains=3, chain_jitter=0.05,
                              folder_name=folder, networks_per_file=6,
                              verbose=False, **kw)

    net, res = run(str(tmp_path / "buffered"))
    _, streamed = run(str(tmp_path / "streamed"), keep_samples=False)
    assert streamed.theta_samples.shape == (0, 3, res.theta_samples.shape[2])
    text = tmp_path / "text"
    shutil.copytree(tmp_path / "buffered", text)
    (text / "samples.npz").unlink()
    want = res.param_samples
    x = torch.as_tensor(X_TEST)
    for d in ("buffered", "text", "streamed"):
        tp = TPredictor(str(tmp_path / d), likelihood=lik, device="cpu")
        assert tp.n_networks == 18
        np.testing.assert_array_equal(tp.chain_index,
                                      np.repeat(np.arange(3), 6))
        for got, w in zip(tp.param_samples, want):
            for k in w:
                np.testing.assert_array_equal(got[k], w[k])
        np.testing.assert_array_equal(
            tp.predict(X_TEST),
            torch.func.vmap(net.model.apply, in_dims=(0, None))(
                tuple({k: torch.as_tensor(v) for k, v in p.items()}
                      for p in want), x).numpy())
