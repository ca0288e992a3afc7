"""K3 over row chunks (``try_build_fused_main_vg(..., data_chunk=)``) and the
driver's gate on K3's workspace (``parallel.graphs.k3_fits``).

With ``data_chunk`` K3 is built for a chunk's rows and an evaluation makes
one call a chunk, the values summed with the Kahan carry of the chunked
plain path, the gradients plainly; only float association changes. On the
CPU each call is K3's twin (``potential_plain``). The chunked route is held
against the JAX package's chunked ``make_potentials(..., data_chunk=)``
``main_vg`` for every likelihood head, against the port's unchunked K3
route, and over a 1x2 mesh of the CPU: in float64 on both sides (the JAX
package under ``jax.enable_x64``) at rtol 1e-5, atol 1e-5 (the tolerances
of tests/test_torch_data_chunk.py), and in float32 at relative 1e-5 on the
values and 1e-5 of the largest entry on the gradients (the card tests'
tolerances: at these 320 rows the gradients reach ~1e5, and two float32
orders of summation leave ~1e-7 of that on entries that cancel). A call's
workspace is
one chunk's, whatever the rows. The gate's decisions are fed memory
figures. ``Network.train`` with ``data_chunk`` takes K3 and its first
epochs equal the plain chunked run's to rtol 1e-4.

The model (4-32-32-out, 320 rows) is past K1's shared memory, so the
driver's "auto" builds K3 for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops import fused_mlp
from tensorbnn_tpu_torch.parallel import graphs
from tensorbnn_tpu_torch.parallel.mesh import DataPeers, make_mesh
from tensorbnn_tpu_torch.sampler.driver import _gate_k3
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten

torch.set_num_threads(1)

HEADS = {
    "fixed_gaussian": (lambda p: p.FixedGaussianLikelihood(sd=0.1), None),
    "gaussian": (lambda p: p.GaussianLikelihood(sd=0.1), None),
    "bernoulli": (lambda p: p.BernoulliLikelihood(), lambda p: p.Sigmoid()),
    "categorical": (lambda p: p.CategoricalLikelihood(),
                    lambda p: p.Softmax()),
}
#: the rows, a chunk's rows and the hidden width
N_ROWS, CHUNK, WIDTH = 320, 80, 32
#: chains of the oracles' comparisons
CHAINS = 3


def _problem(head, dtype="float32", n=N_ROWS, seed=0):
    """A 4-32-32-out stack under ``head`` in both packages, its data and
    ``CHAINS`` states near its init: ``(j_model, t_model, j_lik, t_lik,
    j_flat, t_flat, x, y, thetas, etas)``, the arrays numpy ``dtype`` (drawn
    in float32, so that both dtypes hold the same data)."""
    make_lik, make_head = HEADS[head]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    if head == "bernoulli":
        y = (x.sum(axis=1) > 0).astype(np.float32)
    elif head == "categorical":
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    else:
        y = np.sin(x.sum(axis=1)).astype(np.float32)
    out = 3 if head == "categorical" else 1
    models = []
    for pkg, seq in ((J, JSequential), (T, TSequential)):
        layers = [pkg.GaussianDenseLayer(4, WIDTH), pkg.Tanh(),
                  pkg.GaussianDenseLayer(WIDTH, WIDTH), pkg.Tanh(),
                  pkg.GaussianDenseLayer(WIDTH, out)]
        if make_head is not None:
            layers.append(make_head(pkg))
        models.append(seq(layers))
    j_lik, t_lik = make_lik(J), make_lik(T)
    params, hypers = models[0].init(jax.random.key(seed))
    lik_h = j_lik.init_hypers()
    j_flat = j_flatten(params, hypers, lik_h)
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    rng = np.random.default_rng(1)
    thetas = (np.asarray(j_flat.theta) + 0.05 * rng.normal(
        size=(CHAINS, j_flat.theta.size))).astype(np.float32)
    etas = (np.asarray(j_flat.eta) + 0.05 * rng.normal(
        size=(CHAINS, j_flat.eta.size))).astype(np.float32)
    return (*models, j_lik, t_lik, j_flat, t_flat,
            *(a.astype(dtype) for a in (x, y, thetas, etas)))


def _k3(t_model, t_lik, t_flat, x, y, **kw):
    vg = fused_mlp.try_build_fused_main_vg(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), t_flat.eta.numel(), **kw)
    assert vg is not None
    return vg


def _jax_chunked(p):
    """The JAX package's chunked ``main_vg`` at the problem's states, in
    their dtype."""
    j_model, _, j_lik, _, j_flat, _, x, y, thetas, etas = p
    with jax.enable_x64(x.dtype == np.float64):
        jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                          j_flat.unravel_theta, j_flat.unravel_eta,
                          data_chunk=CHUNK)
        value, grad = jax.vmap(jp.main_vg)(jnp.asarray(thetas),
                                           jnp.asarray(etas))
        value, grad = np.asarray(value), np.asarray(grad)
    assert value.dtype == x.dtype
    return value, grad


def _close(got, want):
    """float64: rtol 1e-5, atol 1e-5; float32: relative 1e-5 on the
    values, 1e-5 of the largest entry on the gradients."""
    (v, g), (wv, wg) = (t.numpy() for t in got), want
    assert v.dtype == wv.dtype and g.dtype == wg.dtype
    if v.dtype == np.float64:
        np.testing.assert_allclose(v, wv, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, wg, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(v, wv, rtol=1e-5, atol=0)
        np.testing.assert_allclose(g, wg, rtol=0,
                                   atol=1e-5 * float(np.abs(wg).max()))


DTYPES = ["float64", "float32"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head", list(HEADS))
def test_chunked_k3_matches_jax_chunked_main_vg(head, dtype):
    """Four chunks of 80 rows, one K3 twin's call each, against the JAX
    package's chunked ``main_vg``; K1 declines the model."""
    p = _problem(head, dtype)
    _, t_model, _, t_lik, _, t_flat, x, y, thetas, etas = p
    assert fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), t_flat.eta.numel()) is None
    vg = _k3(t_model, t_lik, t_flat, x, y, data_chunk=CHUNK)
    got = vg(torch.tensor(thetas), torch.tensor(etas), torch.tensor(x),
             torch.tensor(y))
    _close(got, _jax_chunked(p))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head", list(HEADS))
def test_chunked_k3_matches_unchunked_k3(head, dtype):
    """The chunked route against the port's unchunked K3 route (the
    parent's), to float association."""
    _, t_model, _, t_lik, _, t_flat, x, y, thetas, etas = _problem(head,
                                                                   dtype)
    args = (torch.tensor(thetas), torch.tensor(etas), torch.tensor(x),
            torch.tensor(y))
    got = _k3(t_model, t_lik, t_flat, x, y, data_chunk=CHUNK)(*args)
    want = _k3(t_model, t_lik, t_flat, x, y)(*args)
    _close(got, tuple(t.numpy() for t in want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head", list(HEADS))
def test_chunked_k3_over_a_data_mesh_matches_jax(head, dtype):
    """On a 1x2 mesh of the CPU each peer chunks its 160 rows in two and
    keeps its own carry; the peers' sums then take the priors once: the
    JAX package's chunked ``main_vg`` over all the rows."""
    p = _problem(head, dtype)
    _, t_model, _, t_lik, _, t_flat, x, y, thetas, etas = p
    mesh = make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    peers = DataPeers.split(mesh.devices[0], torch.tensor(x),
                            torch.tensor(y))
    vg = fused_mlp.try_build_fused_main_vg(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        *peers.shards[0], t_flat.eta.numel(), n_rows=N_ROWS // 2,
        data_chunk=CHUNK)
    got = vg(torch.tensor(thetas), torch.tensor(etas), *peers.shards[0],
             peers=peers)
    _close(got, _jax_chunked(p))


@pytest.mark.parametrize("data_chunk", [None, N_ROWS])
def test_one_chunk_is_the_unchunked_route_bit_for_bit(data_chunk):
    """No ``data_chunk``, or one chunk of every row: the parent's route,
    bit for bit, with its workspace."""
    _, t_model, _, t_lik, _, t_flat, x, y, thetas, etas = _problem(
        "gaussian")
    args = (torch.tensor(thetas), torch.tensor(etas), torch.tensor(x),
            torch.tensor(y))
    vg = _k3(t_model, t_lik, t_flat, x, y, data_chunk=data_chunk)
    base = _k3(t_model, t_lik, t_flat, x, y)
    for g, w in zip(vg(*args), base(*args)):
        assert torch.equal(g, w)
    assert vg.workspace_bytes(CHAINS) == base.workspace_bytes(CHAINS)


def test_chunk_must_divide_the_local_rows():
    """A chunk that does not divide a peer's rows raises the JAX package's
    message, as the chunked plain path does."""
    _, t_model, _, t_lik, _, t_flat, x, y, _, _ = _problem("gaussian")
    with pytest.raises(ValueError, match=r"data_chunk \(70\) must divide "
                                         r"the \(local\) training rows "
                                         r"\(160\)"):
        _k3(t_model, t_lik, t_flat, x, y, n_rows=N_ROWS // 2, data_chunk=70)


@pytest.mark.parametrize("c", [2, 8])
def test_workspace_is_one_chunks_whatever_the_rows(c):
    """``workspace_bytes(c)`` under ``data_chunk`` is one chunk's floats x 4
    (K3's program for the chunk's rows), the same at 320 and 1,280 rows,
    and a quarter of the unchunked call's planes at 320."""
    _, t_model, _, t_lik, _, t_flat, x, y, _, _ = _problem("gaussian")
    ops, lik = fused_mlp._model_program(t_model, t_lik)
    chunk_program = fused_mlp.make_fused_potential_vg(ops, CHUNK,
                                                      lik).args[0]
    sizes = [_k3(t_model, t_lik, t_flat, x, y, n_rows=n,
                 data_chunk=CHUNK).workspace_bytes(c)
             for n in (N_ROWS, 4 * N_ROWS)]
    assert sizes == [4 * chunk_program.workspace_floats(c)] * 2
    # the planes: 32 + 32 + 1 output columns and two gradient planes of 32
    planes = 4 * c * (WIDTH + WIDTH + 1 + 2 * WIDTH)
    whole = _k3(t_model, t_lik, t_flat, x, y).workspace_bytes(c)
    assert sizes[0] >= planes * CHUNK and whole >= planes * N_ROWS
    assert sizes[0] < whole


def _surrogate_vg(data_chunk):
    """K3 at the surrogate's 8-64-64-1 tanh, learned sd, over 1M rows
    (only the row count is used: no plane is allocated)."""
    model = TSequential([T.GaussianDenseLayer(8, 64), T.Tanh(),
                         T.GaussianDenseLayer(64, 64), T.Tanh(),
                         T.GaussianDenseLayer(64, 1)])
    lik = T.GaussianLikelihood(sd=0.1)
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = t_flatten(params, hypers, lik.init_hypers())
    x = torch.zeros(16, 8)
    return fused_mlp.try_build_fused_main_vg(
        model, lik, flat.unravel_theta, flat.unravel_eta, x, x[:, 0],
        flat.eta.numel(), n_rows=1_000_000, data_chunk=data_chunk)


#: an 80 GB card's memory, and what routes the surrogate's fleets take on
#: it: K3 (``k3_fits``) and the stepped runner (``stepped_fits``) without
#: ``data_chunk`` and with ``data_chunk=125,000``; the workspace in GB
CARD_BYTES = 80_000_000_000
SURROGATE_ROUTES = {
    32: ((True, True, 32.902), (True, True, 4.118)),
    64: ((True, False, 65.798), (True, True, 8.230)),
    128: ((False, False, 131.590), (True, True, 16.454)),
}


@pytest.mark.parametrize("chains", list(SURROGATE_ROUTES))
def test_gate_at_the_surrogates_fleets(chains, monkeypatch):
    """The gate fed an 80 GB card: unchunked, 128 chains' workspace (131.6
    GB) does not fit and 64 chains' (65.8 GB) fits once but not twice;
    with ``data_chunk=125,000`` every fleet up to 128 chains (16.45 GB)
    fits twice and takes K3 and the stepped runner. The figures include
    the split row sums' partials (6.5 MB at 32 chains)."""
    monkeypatch.setattr(graphs, "card_memory", lambda i: CARD_BYTES)
    for chunk, (k3, stepped, gb) in zip((None, 125_000),
                                       SURROGATE_ROUTES[chains]):
        workspace = _surrogate_vg(chunk).workspace_bytes(chains)
        assert workspace / 1e9 == pytest.approx(gb, abs=1e-3)
        assert graphs.k3_fits(workspace, {0}) == k3
        assert graphs.stepped_fits(workspace, {0}) == stepped


def test_gate_decisions_for_memory_figures(monkeypatch):
    """``k3_fits`` passes a workspace within each card's memory, to the
    byte, and anything without a card; the driver's ``_gate_k3`` reads a
    chain shard's chains and returns None (saying why under ``verbose``)
    where the gate declines."""
    memory = {0: 1000, 1: 2000}
    monkeypatch.setattr(graphs, "card_memory", lambda i: memory[i])
    assert graphs.k3_fits(1000, {0}) and not graphs.k3_fits(1001, {0})
    assert graphs.k3_fits(2000, {1}) and not graphs.k3_fits(1001, {0, 1})
    assert graphs.k3_fits(10 ** 15, set())

    def vg():
        pass

    vg.workspace_bytes = lambda c: 100 * c
    cuda = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert _gate_k3(vg, 10, None, cuda[0], False) is vg
    assert _gate_k3(vg, 11, None, cuda[0], False) is None
    assert _gate_k3(vg, 11, None, cuda[1], False) is vg
    # a 2x1 mesh: a shard's 10 of 20 chains on card 0 and on card 1
    chains = make_mesh(2, 1, devices=cuda)
    assert _gate_k3(vg, 20, chains, cuda[0], False) is vg
    assert _gate_k3(vg, 22, chains, cuda[0], False) is None
    # the CPU has no gate
    assert _gate_k3(vg, 10 ** 6, None, torch.device("cpu"), False) is vg


def test_gate_says_why_under_verbose(monkeypatch, capsys):
    monkeypatch.setattr(graphs, "card_memory", lambda i: 80 * 10 ** 9)

    def vg():
        pass

    vg.workspace_bytes = _surrogate_vg(None).workspace_bytes
    assert _gate_k3(vg, 128, None, torch.device("cuda", 0), True) is None
    said = capsys.readouterr().out
    assert "K3 declined" in said and "131.59" in said and "80.00" in said


def _net(rows=N_ROWS, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    net = T.Network(np.float32, 4, x, y, x, y, seed=seed, device="cpu")
    net.add(T.GaussianDenseLayer(4, WIDTH)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(WIDTH, WIDTH)).add(T.Tanh())
    net.add(T.GaussianDenseLayer(WIDTH, 1))
    net.setup_mcmc(step_size_start=1e-3, step_size_min=5e-4,
                   step_size_max=2e-3, step_size_options=5,
                   leapfrog_start=6, leapfrog_min=2, leapfrog_max=12,
                   leapfrog_increment=2, hyper_leapfrog=4, burnin=20,
                   averaging_steps=5, random_steps=2)
    return net


@pytest.mark.parametrize("lik", ["fixed", "learned"])
def test_driver_runs_k3_over_row_chunks(lik, capsys):
    """``Network.train`` with ``data_chunk`` and ``use_fused="auto"`` takes
    K3 (the verbose line says so) and samples finite states; its first
    epochs equal the plain chunked run to float32 association (rtol 1e-4,
    as tests/test_torch_data_chunk.py's driver test)."""

    def run(**kw):
        likelihood = (T.FixedGaussianLikelihood(sd=0.1) if lik == "fixed"
                      else T.GaussianLikelihood(sd=0.1))
        return _net().train(12, 2, likelihood, n_chains=2, data_chunk=CHUNK,
                            **kw)

    k3 = run(use_fused="auto", verbose=True)
    assert "fused K3" in capsys.readouterr().out
    plain = run(use_fused=False, verbose=False)
    assert (k3.main_path, plain.main_path) == ("K3", "plain")
    assert np.isfinite(k3.theta_samples).all()
    np.testing.assert_allclose(k3.theta_samples, plain.theta_samples,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(k3.eta_samples, plain.eta_samples,
                               rtol=1e-4, atol=1e-5)
