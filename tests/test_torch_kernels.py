"""K1, K2 and K3 of the torch port against the JAX package's Pallas
kernels.

On the CPU the port's kernel wrappers run their plain twins; those are
held here against the Pallas kernels in interpret mode on the same inputs,
with the tolerances of tests/test_fused_trajectory.py,
tests/test_fused_hyper.py and tests/test_fused_mlp.py. The CUDA kernels themselves are held against
the twins on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.ops import fused_mlp as j_fused
from tensorbnn_tpu.ops.fused_hyper import \
    try_build_fused_hyper_trajectory as j_hyper_build
from tensorbnn_tpu.ops.fused_mlp import try_build_fused_trajectory as \
    j_traj_build
from tensorbnn_tpu.sampler.hyper_stats import make_stats_hyper as j_stats
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
from tensorbnn_tpu_torch.sampler.potential import flatten_state as t_flatten

torch.set_num_threads(1)


def _pair(widths, act="Tanh", lik=("FixedGaussianLikelihood", 0.1),
          dense="GaussianDenseLayer"):
    j_layers, t_layers = [], []
    for i, (a, b) in enumerate(widths):
        j_layers.append(getattr(J, dense)(a, b))
        t_layers.append(getattr(T, dense)(a, b))
        if i < len(widths) - 1:
            j_layers.append(getattr(J, act)())
            t_layers.append(getattr(T, act)())
    name, sd = lik
    return (JSequential(j_layers), getattr(J, name)(sd=sd),
            TSequential(t_layers), getattr(T, name)(sd=sd))


def _setup(pair, c, seed=0, n=11, eta_noise=0.0):
    j_model, j_lik, t_model, t_lik = pair
    d_in = j_model.layers[0].in_dim
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(seed))
    lik_h = j_lik.init_hypers()
    j_flat = j_flatten(params, hypers, lik_h)
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    thetas = (0.3 * rng.normal(size=(c, j_flat.theta.size))).astype(
        np.float32)
    etas = (np.asarray(j_flat.eta)[None]
            + eta_noise * rng.normal(size=(c, j_flat.eta.size))).astype(
                np.float32)
    return x, y, j_flat, t_flat, thetas, etas, rng


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("mode", ["shared", "per_chain"])
@pytest.mark.parametrize("act", ["Tanh", "Relu"])
def test_k1_twin_matches_pallas(mode, act):
    c = 4
    pair = _pair([(1, 10), (10, 10), (10, 10), (10, 1)], act=act)
    j_model, j_lik, t_model, t_lik = pair
    x, y, j_flat, t_flat, thetas, etas, rng = _setup(pair, c,
                                                     eta_noise=0.05)
    if mode == "shared":
        eps, steps = np.float32(1e-2), 13
        j_eps, j_l = jnp.asarray(eps), jnp.asarray(steps, jnp.int32)
        t_eps, t_l = float(eps), steps
    else:
        eps = np.asarray([1e-2, 5e-3, 2e-3, 1e-2], np.float32)
        steps = np.asarray([13, 7, 1, 4], np.int32)
        j_eps, j_l = jnp.asarray(eps), jnp.asarray(steps)
        t_eps, t_l = torch.tensor(eps), torch.tensor(steps)
    momenta = rng.normal(size=thetas.shape).astype(np.float32)

    j_traj = j_traj_build(j_model, j_lik, j_flat.unravel_theta,
                          j_flat.unravel_eta, x, y,
                          eta_dim=j_flat.eta.size, block_c=c,
                          interpret=True)
    t_traj = fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=t_flat.eta.numel())
    assert j_traj is not None and t_traj is not None
    jq, jv, jlp0, jlp1 = j_traj(jnp.asarray(thetas), jnp.asarray(etas),
                                jnp.asarray(momenta), x, y, j_eps, j_l)
    launches = fused_mlp.fused_trajectory.LAUNCHES
    tq, tv, tlp0, tlp1 = t_traj(torch.tensor(thetas), torch.tensor(etas),
                                torch.tensor(momenta), torch.tensor(x),
                                torch.tensor(y), t_eps, t_l)
    # CPU tensors take the twin: no kernel launch is counted
    assert fused_mlp.fused_trajectory.LAUNCHES == launches
    # tolerances of tests/test_fused_trajectory.py:72-79
    _close(tlp0, jlp0, rtol=1e-4, atol=1e-3)
    _close(tq, jq, rtol=1e-3, atol=1e-4)
    _close(tv, jv, rtol=1e-3, atol=1e-3)
    _close(tlp1, jlp1, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("mode", ["shared", "per_chain"])
def test_k1_tempered_twin_matches_pallas(mode):
    """K1 variant (c): the twin with per-chain betas against the Pallas
    kernel's tempered program (interpret mode), as
    tests/test_fused_trajectory.py:363-415 runs it, at the flagship, with
    shared and per-chain (eps, L) and that test's tolerances (:396-403)."""
    c = 4
    pair = _pair([(1, 10), (10, 10), (10, 10), (10, 1)])
    j_model, j_lik, t_model, t_lik = pair
    x, y, j_flat, t_flat, thetas, etas, rng = _setup(pair, c)
    betas = np.asarray([1.0, 0.3, 0.06, 0.01], np.float32)
    if mode == "shared":
        eps, steps = np.float32(1e-2), np.int32(13)
        t_eps, t_l = float(eps), int(steps)
    else:
        eps = np.asarray([5e-3, 1e-2, 2e-2, 8e-3], np.float32)
        steps = np.asarray([3, 11, 7, 5], np.int32)
        t_eps, t_l = torch.tensor(eps), torch.tensor(steps)
    momenta = rng.normal(size=thetas.shape).astype(np.float32)

    j_traj = j_traj_build(j_model, j_lik, j_flat.unravel_theta,
                          j_flat.unravel_eta, x, y,
                          eta_dim=j_flat.eta.size, block_c=c,
                          interpret=True, tempered=True)
    t_traj = fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=t_flat.eta.numel(),
        tempered=True)
    assert j_traj is not None and t_traj is not None
    assert t_traj.args[0].tempered
    jq, jv, jlp0, jlp1 = j_traj(jnp.asarray(thetas), jnp.asarray(etas),
                                jnp.asarray(momenta), x, y, jnp.asarray(eps),
                                jnp.asarray(steps), jnp.asarray(betas))
    args = (torch.tensor(thetas), torch.tensor(etas), torch.tensor(momenta),
            torch.tensor(x), torch.tensor(y), t_eps, t_l)
    tq, tv, tlp0, tlp1 = t_traj(*args, torch.tensor(betas))
    _close(tlp0, jlp0, rtol=1e-4, atol=1e-3)
    _close(tq, jq, rtol=1e-3, atol=1e-4)
    _close(tv, jv, rtol=1e-3, atol=1e-3)
    _close(tlp1, jlp1, rtol=1e-4, atol=1e-2)
    # a tempered program needs its betas (JAX fused_mlp.py:660-662)
    with pytest.raises(TypeError, match="betas"):
        t_traj(*args)
    # at beta = 1 the tempered twin is the untempered one
    plain = fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=t_flat.eta.numel())
    for got, want in zip(t_traj(*args, torch.ones(c)), plain(*args)):
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("lik", [("FixedGaussianLikelihood", 0.1),
                                 ("GaussianLikelihood", 0.2)])
def test_k2_twin_matches_pallas(lik):
    c, n_steps = 4, 7
    pair = _pair([(2, 5), (5, 1)], lik=lik)
    j_model, j_lik, t_model, t_lik = pair
    x, y, j_flat, t_flat, thetas, etas, rng = _setup(pair, c, n=9,
                                                     eta_noise=0.05)
    j_stats_fn, _, _ = j_stats(j_model, j_lik, jnp.asarray(x),
                               jnp.asarray(y), j_flat.unravel_eta,
                               j_flat.eta.size)
    stats = np.asarray(j_stats_fn(jax.vmap(j_flat.unravel_theta)(thetas)))
    momenta = rng.normal(size=etas.shape).astype(np.float32)
    eps = (0.01 + 0.01 * rng.random(c)).astype(np.float32)

    j_traj = j_hyper_build(j_model, j_lik, j_flat.unravel_eta,
                           j_flat.eta.size, n_steps=n_steps, block_c=c,
                           interpret=True)
    t_traj = fused_hyper.try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, t_flat.eta.numel(), n_steps)
    assert j_traj is not None and t_traj is not None
    jq, jv, jlp0, jlp1 = j_traj(etas, stats, momenta, eps)
    tq, tv, tlp0, tlp1 = t_traj(torch.tensor(etas), torch.tensor(stats),
                                torch.tensor(momenta), torch.tensor(eps))
    # tolerances of tests/test_fused_hyper.py
    _close(tlp0, jlp0, rtol=1e-4, atol=1e-3)
    _close(tq, jq, rtol=1e-4, atol=1e-5)
    _close(tv, jv, rtol=1e-4, atol=1e-4)
    _close(tlp1, jlp1, rtol=1e-4, atol=1e-3)


def test_scope_cauchy_model_takes_the_plain_path():
    """A Cauchy-prior model is outside the port's K1 and K2 and the JAX
    package's hyper kernel (the JAX K1 covers Cauchy priors; the port's K1
    does not yet): its main block takes K3 under the plain HMC step, its
    hyper block the plain path."""
    pair = _pair([(1, 6), (6, 1)], dense="CauchyDenseLayer")
    j_model, j_lik, t_model, t_lik = pair
    x, y, j_flat, t_flat, _, _, _ = _setup(pair, 2)
    h = t_flat.eta.numel()
    assert fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=h) is None
    assert fused_hyper.try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, h, 5) is None
    assert j_hyper_build(j_model, j_lik, j_flat.unravel_eta, h, 5,
                         interpret=True) is None
    assert fused_mlp.try_build_fused_main_vg(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=h) is not None
    # a learned-sd likelihood is outside the port's K1, inside its K2
    pair = _pair([(1, 6), (6, 1)], lik=("GaussianLikelihood", 0.2))
    _, _, t_model, t_lik = pair
    _, _, _, t_flat, _, _, _ = _setup(pair, 2)
    assert fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y),
        eta_dim=t_flat.eta.numel()) is None
    assert fused_hyper.try_build_fused_hyper_trajectory(
        t_model, t_lik, t_flat.unravel_eta, t_flat.eta.numel(),
        5) is not None


def test_k1_shared_memory_gate():
    """A wide stack (10x256 over 128 rows) does not fit one block's
    shared memory: K1 declines it, and the driver takes K3 instead
    (test_torch_sampler.py::test_driver_takes_k3_where_k1_declines)."""
    t_model = TSequential([T.GaussianDenseLayer(1, 256), T.Tanh()]
                          + [T.GaussianDenseLayer(256, 256), T.Tanh()] * 9
                          + [T.GaussianDenseLayer(256, 1)])
    lik = T.FixedGaussianLikelihood(sd=0.1)
    params, hypers = t_model.init(torch.Generator().manual_seed(0))
    flat = t_flatten(params, hypers, {})
    assert fused_mlp.build_trajectory_program(
        t_model, lik, flat.unravel_theta, flat.unravel_eta,
        flat.eta.numel(), n_rows=128) is None
    # the flagship stack takes a few KB
    _, _, f_model, f_lik = _pair([(1, 10), (10, 10), (10, 10), (10, 1)])
    f_params, f_hypers = f_model.init(torch.Generator().manual_seed(0))
    f_flat = t_flatten(f_params, f_hypers, {})
    flagship = fused_mlp.build_trajectory_program(
        f_model, f_lik, f_flat.unravel_theta, f_flat.unravel_eta,
        f_flat.eta.numel(), n_rows=11)
    assert flagship is not None and flagship.smem_bytes < 8192


def _ops(dims, acts):
    ops = []
    for i, act in enumerate(acts):
        ops.append(("dense", dims[i], dims[i + 1]))
        if act != "none":
            ops.append((act, dims[i + 1]))
    return tuple(ops)


@pytest.mark.parametrize("dims,acts,sd,staged", [
    ((1, 10, 10, 10, 1), ("tanh", "tanh", "tanh", "none"), 0.1, False),
    ((3, 8, 2), ("relu", "none"), 0.1, False),
    ((2, 6, 5, 3), ("elu", "sigmoid", "exp"), 0.3, False),
    ((1, 6, 1), ("tanh", "none"), "per_chain", False),
    ((3, 7, 2), ("tanh", "none"), 0.1, True),
])
def test_k3_twin_matches_pallas(dims, acts, sd, staged, monkeypatch):
    """K3's twin against the Pallas potential kernel; ``staged`` forces
    the kernel's scratch-staged loop over input rows, as
    tests/test_fused_mlp.py:137 does."""
    if staged:
        monkeypatch.setattr(j_fused, "UNROLL_TEMP_BYTES", 0)
    rng = np.random.default_rng(3)
    n, c = 11, 4
    ops = _ops(dims, acts)
    d = sum(fused_mlp._op_rows(op) for op in ops)
    x = rng.normal(size=(n, dims[0])).astype(np.float32)
    y = rng.normal(size=(n, dims[-1])).astype(np.float32)
    thetas = (0.5 * rng.normal(size=(c, d))).astype(np.float32)
    if sd == "per_chain":
        sd_j = np.asarray([0.05, 0.1, 0.2, 0.4], np.float32)
        sd_t = torch.tensor(sd_j)
    else:
        sd_j, sd_t = np.float32(sd), float(sd)

    j_vg = j_fused.make_fused_potential_vg(ops, n, lik="gaussian",
                                           block_c=c, interpret=True)
    t_vg = fused_mlp.make_fused_potential_vg(ops, n)
    jl, jg = j_vg(jnp.asarray(thetas), jnp.asarray(sd_j), x, y)
    launches = fused_mlp.fused_potential.LAUNCHES
    tl, tg = t_vg(torch.tensor(thetas), sd_t, torch.tensor(x),
                  torch.tensor(y))
    # CPU tensors take the twin: no kernel launch is counted
    assert fused_mlp.fused_potential.LAUNCHES == launches
    # tolerances of tests/test_fused_mlp.py:33-36
    _close(tl, jl, rtol=1e-4, atol=1e-4)
    _close(tg, jg, rtol=1e-3, atol=1e-4)


def test_k3_scope_needs_each_activation_after_a_dense_layer():
    """K3 fuses an activation into the epilogue of the dense layer before
    it, so two activations in a row are outside its scope."""
    assert fused_mlp.make_fused_potential_vg(
        (("dense", 2, 3), ("tanh", 3), ("dense", 3, 1)), 5) is not None
    assert fused_mlp.make_fused_potential_vg(
        (("dense", 2, 3), ("tanh", 3), ("relu", 3), ("dense", 3, 1)),
        5) is None


@pytest.mark.parametrize("dense", ["GaussianDenseLayer", "CauchyDenseLayer"])
@pytest.mark.parametrize("lik", [("FixedGaussianLikelihood", 0.1),
                                 ("GaussianLikelihood", 0.2)])
def test_k3_main_vg_matches_jax(dense, lik):
    """``batched_main_vg`` (K3's likelihood plus the priors added outside
    it) against the JAX package's ``try_build_fused_main_vg``."""
    c = 4
    pair = _pair([(2, 8), (8, 8), (8, 1)], lik=lik, dense=dense)
    j_model, j_lik, t_model, t_lik = pair
    x, y, j_flat, t_flat, thetas, etas, _ = _setup(pair, c, n=9,
                                                   eta_noise=0.05)
    h = t_flat.eta.numel()
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
    # tolerances of tests/test_fused_mlp.py:33-36
    _close(tv, jv, rtol=1e-4, atol=1e-4)
    _close(tg, jg, rtol=1e-3, atol=1e-4)
