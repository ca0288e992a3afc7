"""The port's ``(chains, data)`` mesh against the JAX package's, on the
8-device virtual CPU mesh that ``tests/conftest.py`` forces for JAX and a
mesh of 8 CPU entries for the port (a device may repeat in a port mesh).

Held against the JAX package: ``make_mesh`` and ``pad_to_multiple``; the
sharded potentials (value and gradient of ``main_vg``, ``hyper_vg``,
their tempered variants and the log-likelihood, summed over the data
peers with the priors counted once) and the stats columns ``R`` and
``K`` against ``shard_map`` and ``psum`` of the JAX ones, at rtol 1e-5;
the driver's ``ValueError`` messages; the sharded ``Predictor`` against
the JAX one with ``mesh=`` on the same store (rtol 1e-5, atol 1e-6).
Held against the port without a mesh: K3's twin on a 1x4 mesh (rtol
1e-5); the chunk runner on four mesh shapes over 3 epochs from the same
generator (identical MH decisions, theta and eta within 1e-5 relative,
acceptance within 1e-4); tempering on a 1x4 mesh (swap decisions
identical) and ``n_adapters=2`` on a 2x2 mesh (samples within 1e-5 of
their largest entry); a run stopped and resumed under a 2x2 mesh,
bit-equal to the uninterrupted one; and ``tests/test_parallel.py``'s
preconditioned, chunked run on a 4x2 mesh, with its assertions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.network import Network as JNetwork
from tensorbnn_tpu.parallel import mesh as j_mesh
from tensorbnn_tpu.sampler.hyper_stats import make_stats_hyper as j_stats
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
from tensorbnn_tpu_torch.parallel import mesh as t_mesh
from tensorbnn_tpu_torch.parallel.chains import init_multichain_state, \
    make_multichain_chunk_runner
from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper as \
    t_stats
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials

torch.set_num_threads(1)

CPU = torch.device("cpu")
DATA = t_mesh.DATA_AXIS


def _t_mesh(n_chain, n_data):
    return t_mesh.make_mesh(n_chain, n_data, devices=[CPU] * (n_chain
                                                              * n_data))


@pytest.fixture(scope="module")
def problem():
    """``tests/test_parallel.py``'s problem (64 rows of 3 inputs, 3-8-1
    tanh, a learned-sd Gaussian likelihood) in both packages, three chains
    around the JAX init: ``(j_model, t_model, j_lik, t_lik, j_flat,
    t_flat, x, y, thetas (3, D), etas (3, H))``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    models = [seq([pkg.GaussianDenseLayer(3, 8), pkg.Tanh(),
                   pkg.GaussianDenseLayer(8, 1)])
              for pkg, seq in ((J, JSequential), (T, TSequential))]
    params, hypers = models[0].init(jax.random.key(0))
    j_lik, t_lik = J.GaussianLikelihood(sd=0.1), T.GaussianLikelihood(sd=0.1)
    lik_h = j_lik.init_hypers()
    j_flat = j_flatten(params, hypers, lik_h)
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    theta, eta = np.asarray(j_flat.theta), np.asarray(j_flat.eta)
    thetas = (theta + 0.1 * rng.normal(size=(3, theta.size))).astype(
        np.float32)
    etas = (eta + 0.05 * rng.normal(size=(3, eta.size))).astype(np.float32)
    return (*models, j_lik, t_lik, j_flat, t_flat, x, y, thetas, etas)


# -- make_mesh and pad_to_multiple -----------------------------------------

@pytest.mark.parametrize("shape", [(None, None), (8, None), (None, 8),
                                   (2, 4), (4, 2), (1, 8), (3, None),
                                   (3, 2), (None, 3)])
def test_make_mesh_matches_jax(shape):
    """Shapes, and the ``ValueError`` text where the axes do not tile the
    devices (8 on each side)."""
    try:
        want = j_mesh.make_mesh(*shape)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            t_mesh.make_mesh(*shape, devices=[CPU] * 8)
        assert str(got.value) == str(err)
        return
    got = t_mesh.make_mesh(*shape, devices=[CPU] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert [[str(d) for d in row] for row in got.devices] == \
        [["cpu"] * want.shape[DATA]] * want.shape[t_mesh.CHAIN_AXIS]


def test_make_mesh_takes_cuda_devices_only():
    """Without ``devices`` the mesh takes every CUDA device, never the CPU:
    here, with none, it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the mesh would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh()


@pytest.mark.parametrize("shape, multiple, axis",
                         [((5, 3), 4, 0), ((8, 3), 4, 0), ((5, 3), 2, 1),
                          ((7,), 3, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    got, got_pad = t_mesh.pad_to_multiple(x, multiple, axis)
    want, want_pad = j_mesh.pad_to_multiple(x, multiple, axis)
    assert got_pad == want_pad
    np.testing.assert_array_equal(got, want)


# -- the sharded potentials and stats ----------------------------------------

def _jax_sharded(body, n_data, x, y, *args):
    """``body(x_shard, y_shard, *args)`` under ``shard_map`` over a 1 x
    ``n_data`` JAX mesh, the rows split over the data axis and ``args``
    replicated."""
    mesh = j_mesh.make_mesh(1, n_data, devices=jax.devices()[:n_data])
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(DATA), P(DATA)) + (P(),) * len(args),
                   out_specs=P(), check_vma=False)
    return jax.jit(fn)(jnp.asarray(x), jnp.asarray(y), *map(jnp.asarray,
                                                            args))


ORACLES = {
    # name: the arguments' order, beta or not
    "main_vg": (False, False),
    "hyper_vg": (True, False),
    "main_vg_t": (False, True),
    "hyper_vg_t": (True, True),
    "loglik": (False, False),
}


@pytest.mark.parametrize("data_chunk", [None, 4])
@pytest.mark.parametrize("name", list(ORACLES))
def test_sharded_potentials_match_jax_psum(problem, name, data_chunk):
    """Each oracle on a 1x8 mesh (8 rows a peer; with ``data_chunk=4`` two
    chunks a peer) against JAX's ``shard_map`` + ``psum`` of the same
    potential, vmapped over 3 chains: value and gradient within rtol 1e-5
    (the prior counted once on both sides)."""
    jm, tm, jl, tl, jf, tf, x, y, thetas, etas = problem
    eta_first, tempered = ORACLES[name]
    args = [etas, thetas] if eta_first else [thetas, etas]
    if tempered:
        args.append(np.array([1.0, 0.7, 0.4], np.float32))

    def body(xs, ys, *a):
        pots = j_potentials(jm, jl, xs, ys, jf.unravel_theta,
                            jf.unravel_eta, axis_name=DATA,
                            data_chunk=data_chunk)
        return jax.vmap(getattr(pots, name))(*a)

    want = _jax_sharded(body, 8, x, y, *args)
    peers = t_mesh.DataPeers.split([CPU] * 8, torch.tensor(x),
                                   torch.tensor(y))
    pots = t_potentials(tm, tl, *peers.shards[0], tf.unravel_theta,
                        tf.unravel_eta, data_chunk=data_chunk, peers=peers)
    got = getattr(pots, name)(*map(torch.tensor, args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("data_chunk", [None, 4])
def test_sharded_stats_sum_r_and_k_as_jax(problem, data_chunk):
    """The stats columns on a 1x8 mesh against JAX's sharded
    ``stats_fn``: the residual power R and the row count K summed over
    the data peers (K exactly 64, not a peer's 8), rtol 1e-5."""
    jm, tm, jl, tl, jf, tf, x, y, thetas, _ = problem
    eta_dim = int(jf.eta.size)

    def body(xs, ys, th):
        stats_fn = j_stats(jm, jl, xs, ys, jf.unravel_eta, eta_dim,
                           axis_name=DATA, data_chunk=data_chunk)[0]
        return stats_fn(jax.vmap(jf.unravel_theta)(th))

    want = np.asarray(_jax_sharded(body, 8, x, y, thetas))
    peers = t_mesh.DataPeers.split([CPU] * 8, torch.tensor(x),
                                   torch.tensor(y))
    got = t_stats(tm, tl, *peers.shards[0], tf.unravel_theta,
                  tf.unravel_eta, eta_dim, data_chunk=data_chunk,
                  peers=peers)[0](torch.tensor(thetas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got[:, -1], 64.0)


def test_k3_twin_on_a_data_mesh_matches_the_unsharded_twin(problem):
    """K3 built for a peer's 16 rows, run on each of 4 peers and summed,
    then the priors added once, against K3 over all 64 rows and against
    the plain potential (rtol 1e-5)."""
    _, tm, _, tl, _, tf, x, y, thetas, etas = problem
    eta_dim = tf.eta.numel()
    xt, yt, th, et = map(torch.tensor, (x, y, thetas, etas))
    peers = t_mesh.DataPeers.split([CPU] * 4, xt, yt)
    sharded = fused_mlp.try_build_fused_main_vg(
        tm, tl, tf.unravel_theta, tf.unravel_eta, *peers.shards[0], eta_dim,
        n_rows=16)
    whole = fused_mlp.try_build_fused_main_vg(
        tm, tl, tf.unravel_theta, tf.unravel_eta, xt, yt, eta_dim)
    got = sharded(th, et, *peers.shards[0], peers=peers)
    plain = t_potentials(tm, tl, xt, yt, tf.unravel_theta,
                         tf.unravel_eta).main_vg(th, et)
    for want in (whole(th, et, xt, yt), plain):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)


# -- the chunk runner ----------------------------------------------------------

def _runner_kernels(tm, tl, tf, n_rows, n_data, use_fused):
    """The kernels the driver would build (their CPU twins): K1 on a data
    axis of 1, K3 for a peer's rows above it, K2 for the hyper block."""
    if not use_fused:
        return {}
    eta_dim = tf.eta.numel()
    kw = {"batched_hyper_traj": fused_hyper.try_build_fused_hyper_trajectory(
        tm, tl, tf.unravel_eta, eta_dim, 5)}
    if n_data == 1:
        kw["batched_main_traj"] = fused_mlp.try_build_fused_trajectory(
            tm, tl, tf.unravel_theta, tf.unravel_eta, None, None, eta_dim,
            n_rows=n_rows)
    else:
        kw["batched_main_vg"] = fused_mlp.try_build_fused_main_vg(
            tm, tl, tf.unravel_theta, tf.unravel_eta, None, None, eta_dim,
            n_rows=n_rows // n_data)
    return kw


def _moves(start, trace) -> np.ndarray:
    """Each epoch's MH decisions, per block and chain: ``(2, epochs, C)``,
    True where the main block's theta or the hyper block's eta moved."""
    theta = torch.cat([start.theta[None], trace.theta])
    eta = torch.cat([start.eta[None], trace.eta])
    return np.stack([(theta[1:] != theta[:-1]).any(-1).numpy(),
                     (eta[1:] != eta[:-1]).any(-1).numpy()])


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_runner_on_a_mesh_matches_the_meshless_runner(problem, shape,
                                                      use_fused):
    """Three epochs of 8 chains on a mesh against the mesh-less runner
    from the same generator, on the plain path and on the kernels' twins
    (K1 + K2 on chains-only meshes, K3 + K2 on data meshes)."""
    _, tm, _, tl, _, tf, x, y, _, _ = problem
    xt, yt = torch.tensor(x), torch.tensor(y)
    kw = dict(adjust_hypers=True, hyper_leapfrog=5, burnin=50.0,
              hyper_step_size_init=1e-3, eta_dim=tf.eta.numel())

    def run(mesh):
        n_data = 1 if mesh is None else mesh.shape[DATA]
        runner = make_multichain_chunk_runner(
            tm, tl, xt, yt, tf.unravel_theta, tf.unravel_eta, mesh=mesh,
            **kw, **_runner_kernels(tm, tl, tf, 64, n_data, use_fused))
        gen = torch.Generator().manual_seed(7)
        start = init_multichain_state(tf.theta, tf.eta, 1e-3, 8, gen,
                                      jitter=0.01)
        carry, trace = runner(start, 5e-4, 8, 3, gen)
        return carry, trace, _moves(start, trace), start.theta.numpy()

    (c0, t0, m0, start), (c1, t1, m1, _) = run(None), run(_t_mesh(*shape))
    # the same MH decisions, theta and eta within 1e-5 relative. A data
    # mesh sums the likelihood in another order, and a chain shard's batch
    # may too (one chain a shard: products, not batched products), so a
    # log density of ~1e2 moves by an ulp, ~1e-5, and its exp, the
    # acceptance probability, by as much (at most 3.1e-5 seen, theta 2.4e-6
    # relative). The main block moved theta by ~9% of its largest entry, so
    # a main block that froze or followed another gradient fails here
    np.testing.assert_array_equal(m1, m0)
    assert np.abs(c0.theta.numpy() - start).max() > \
        1e-2 * np.abs(start).max()
    for got, want in ((c1.theta, c0.theta), (t1.theta, t0.theta),
                      (c1.eta, c0.eta)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=0)
    np.testing.assert_allclose(t1.main_accept.numpy(),
                               t0.main_accept.numpy(), rtol=0, atol=1e-4)
    assert t1.theta.shape == t0.theta.shape == (3, 8, tf.theta.numel())
    assert np.isfinite(t1.sjd.numpy()).all()


# -- the driver ------------------------------------------------------------------

XD = np.linspace(-1, 1, 16).astype(np.float32)
YD = np.sin(XD * math.pi).astype(np.float32)
MCMC = dict(step_size_start=1e-3, leapfrog_start=6, leapfrog_min=4,
            leapfrog_max=10, burnin=10, averaging_steps=5, hyper_leapfrog=5,
            random_steps=2, adapter_seed=0)


def _net(pkg=T, n_rows=16, seed=5, **mcmc):
    x, y = XD[:n_rows], YD[:n_rows]
    if pkg is J:
        net = JNetwork(jnp.float32, 1, x, y, x, y, seed=seed)
    else:
        net = T.Network(torch.float32, 1, x, y, x, y, seed=seed,
                        device="cpu")
    net.add(pkg.GaussianDenseLayer(1, 5)).add(pkg.Tanh())
    net.add(pkg.GaussianDenseLayer(5, 1))
    net.setup_mcmc(**(MCMC | mcmc))
    return net, pkg.GaussianLikelihood(sd=0.1)


@pytest.mark.parametrize("case", [
    dict(shape=(1, 2), n_rows=9, train=dict(n_chains=2)),
    dict(shape=(2, 1), train=dict(n_chains=3)),
    dict(shape=(2, 1), train=dict(n_chains=2, tempering=2)),
], ids=["rows", "chains", "tempering"])
def test_driver_errors_match_jax(case):
    """Rows that do not divide the data axis, chains that are not a
    multiple of the chains axis, tempering over a chains axis above 1: the
    JAX driver's ``ValueError`` and message."""
    errs = []
    for pkg in (J, T):
        net, lik = _net(pkg, n_rows=case.get("n_rows", 16))
        mesh = (j_mesh.make_mesh(*case["shape"],
                                 devices=jax.devices()[:2]) if pkg is J
                else _t_mesh(*case["shape"]))
        with pytest.raises(ValueError) as err:
            net.train(10, 2, lik, verbose=False, mesh=mesh, **case["train"])
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def test_driver_refuses_a_network_off_the_mesh():
    """The run's data and generator must live on the mesh's first
    device."""
    net, lik = _net()
    mesh = t_mesh.Mesh([[torch.device("meta")]])
    with pytest.raises(ValueError, match="mesh's first device"):
        net.train(10, 2, lik, verbose=False, mesh=mesh)


RUNS = {
    # n_chains, the train options, the mesh
    "tempered_1x4": (2, dict(tempering=2, tempering_beta_min=0.5,
                             use_fused=False), (1, 4)),
    "adapters_2x2": (4, dict(n_adapters=2), (2, 2)),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_driver_on_a_mesh_matches_the_meshless_run(case):
    """A tempered run on a 1x4 data mesh (the plain main block, the swap
    on the summed log-likelihood) and an ``n_adapters=2`` run on a 2x2
    mesh (per-chain (eps, L) sharded with the chains, K3 + K2) against the
    same runs without a mesh: the same swap decisions and leapfrog
    counts, each epoch's acceptance within 1e-4 and the samples within
    1e-5 of their largest entry (the likelihood summed in another order:
    2.3e-5 and 3.3e-7 seen; the samples span 44-72% of it)."""
    n_chains, kw, shape = RUNS[case]
    res = []
    for mesh in (None, _t_mesh(*shape)):
        net, lik = _net()
        res.append(net.train(20, 2, lik, n_chains=n_chains, verbose=False,
                             chain_jitter=0.05, mesh=mesh, **kw))
    if "tempering" in kw:
        assert res[1].main_path == "plain"
        np.testing.assert_array_equal(res[1].swap_accept_rung,
                                      res[0].swap_accept_rung)
    else:
        assert res[1].main_path == "K3" and res[1].fused_hyper
    want = res[0].theta_samples
    scale = np.abs(want).max()
    assert np.abs(want[-1] - want[0]).max() > 0.1 * scale
    np.testing.assert_allclose(res[1].theta_samples, want, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(res[1].main_accept, res[0].main_accept,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(res[1].leapfrog, res[0].leapfrog)


def test_resume_under_a_mesh_is_bit_equal(tmp_path):
    """A 2x2-mesh run stopped at epoch 15 (its checkpoint every chunk,
    holding the gathered state) and resumed by a fresh Network of the same
    seed under the same mesh equals the uninterrupted mesh run bit for
    bit."""
    kw = dict(n_chains=4, verbose=False, chain_jitter=0.05,
              checkpoint_every=1)

    def train(epochs, ckpt=None):
        net, lik = _net()
        return net.train(epochs, 2, lik, mesh=_t_mesh(2, 2),
                         checkpoint_dir=ckpt, **kw)

    full = train(30)
    ckpt = str(tmp_path / "ckpt")
    assert train(15, ckpt).n_epochs == 15
    res = train(30, ckpt)
    assert res.resume_epoch == 15
    np.testing.assert_array_equal(res.theta_samples, full.theta_samples)
    np.testing.assert_array_equal(res.eta_samples, full.eta_samples)
    np.testing.assert_array_equal(res.main_accept, full.main_accept[15:])


def test_precondition_and_data_chunk_under_mesh():
    """``tests/test_parallel.py::test_precondition_and_data_chunk_under_
    mesh`` in the port, with its assertions: the step scale reaches every
    chain shard and the chunked likelihood sums over the data peers. 60
    epochs, the JAX test's 120 halved: each evaluation here is 20
    ``torch.func`` calls (4 chain shards, each 2 peers x 2 chunks and the
    prior), ~0.6 s an epoch on a CPU; the burn-in, and with it the
    estimate's epoch, are the JAX test's."""
    mesh = _t_mesh(4, 2)
    x = np.linspace(-1, 1, 16)
    y = np.sin(x * math.pi)
    net = T.Network(torch.float32, 1, x, y, x, y, seed=6, device="cpu")
    net.add(T.GaussianDenseLayer(1, 5)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(5, 1))
    net.setup_mcmc(step_size_start=2e-3, step_size_min=5e-4,
                   step_size_max=1e-2, step_size_options=8,
                   leapfrog_start=8, leapfrog_min=4, leapfrog_max=16,
                   leapfrog_increment=4, hyper_leapfrog=4, burnin=40,
                   averaging_steps=5, random_steps=2, adapter_seed=0)
    res = net.train(60, 4, T.FixedGaussianLikelihood(sd=0.1),
                    n_chains=8, chain_jitter=0.05, mesh=mesh,
                    precondition=True, data_chunk=4, use_fused=False,
                    verbose=False)
    assert np.isfinite(res.theta_samples).all()
    assert 0.05 < res.main_accept[40:].mean() <= 1.0
    assert np.std(res.theta_samples[:, 0, 0]) > 0


# -- the Predictor -----------------------------------------------------------------

def test_sharded_predictor_matches_jax(tmp_path):
    """``tests/test_parallel.py::test_predictor_mesh_sharded_inference`` in
    both packages on the same npz store: 11 networks on the 2-entry chains
    axis (padded) and 13 rows on the 4-entry data axis (padded); the
    constructor's mesh, a per-call mesh (twice: the cached ensemble) and
    ``predict_mean_sd``, rtol 1e-5 / atol 1e-6."""
    from tensorbnn_tpu.io import checkpoint
    from tensorbnn_tpu.predictor import Predictor as JPredictor

    model = JSequential([J.GaussianDenseLayer(2, 6), J.Tanh(),
                         J.GaussianDenseLayer(6, 1)])
    params, hypers = model.init(jax.random.key(1))
    flat = j_flatten(params, hypers, {})
    n_nets = 11
    rng = np.random.default_rng(2)
    thetas = jnp.asarray(
        flat.theta[None] + 0.1 * rng.normal(size=(n_nets, flat.theta.size)),
        jnp.float32)
    param_samples = jax.tree.map(np.asarray,
                                 jax.vmap(flat.unravel_theta)(thetas))
    hyper_samples = tuple(
        jax.tree.map(lambda v, n=n_nets: np.broadcast_to(
            np.asarray(v), (n,) + np.shape(v)).copy(), h)
        for h in hypers)
    d = str(tmp_path / "run")
    checkpoint.save_samples(d, param_samples, hyper_samples, {})
    with open(f"{d}/architecture.txt", "w") as f:
        for name in model.layer_names:
            f.write(name + "\n")
    x = rng.normal(size=(13, 2)).astype(np.float32)

    j_mesh_ = j_mesh.make_mesh(n_chain_devices=2, n_data_devices=4)
    want = JPredictor(d, likelihood=J.FixedGaussianLikelihood(sd=0.1),
                      mesh=j_mesh_).predict(x)
    mesh = _t_mesh(2, 4)
    lik = T.FixedGaussianLikelihood(sd=0.1)
    sharded = T.Predictor(d, likelihood=lik, device="cpu", mesh=mesh)
    plain = T.Predictor(d, likelihood=lik, device="cpu")
    out = sharded.predict(x)
    assert out.shape == want.shape == (n_nets, 13, 1)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, plain.predict(x), rtol=1e-5, atol=1e-6)
    for _ in range(2):
        np.testing.assert_allclose(plain.predict(x, mesh=mesh), want,
                                   rtol=1e-5, atol=1e-6)
    m, sd = sharded.predict_mean_sd(x)
    np.testing.assert_allclose(m, want.mean(axis=0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sd, want.std(axis=0), rtol=1e-5, atol=1e-6)
    q = plain.predict_quantiles(x, 1, mesh)
    np.testing.assert_allclose(q, np.quantile(want, [0.025, 0.5, 0.975],
                                              axis=0), rtol=1e-5, atol=1e-6)
