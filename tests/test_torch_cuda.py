"""K1 (untempered, tempered and U-turn-recording), K2 and K3 on an NVIDIA
card against their plain twins on the same card.

The CUDA kernels have no CPU mode, so these tests skip without a card.
This file imports no jax (the machine with the card has none); run it
there with ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
    GaussianDenseLayer, GaussianLikelihood, Tanh
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
from tensorbnn_tpu_torch.sampler.potential import flatten_state


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flagship(likelihood):
    model = Sequential([GaussianDenseLayer(1, 10), Tanh(),
                        GaussianDenseLayer(10, 10), Tanh(),
                        GaussianDenseLayer(10, 10), Tanh(),
                        GaussianDenseLayer(10, 1)])
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = flatten_state(params, hypers, likelihood.init_hypers())
    return model, flat


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("per_chain", [False, True])
def test_k1_kernel_matches_twin(device, per_chain):
    lik = FixedGaussianLikelihood(sd=0.1)
    model, flat = _flagship(lik)
    c, n = 64, 11
    program = fused_mlp.build_trajectory_program(
        model, lik, flat.unravel_theta, flat.unravel_eta, flat.eta.numel(),
        n_rows=n)
    rng = np.random.default_rng(0)
    # weights ~ 0.3 N(0, 1), as tests/test_fused_trajectory.py draws them:
    # from the He-init start, (eps, L) = (1e-2, 13) leaves the leapfrog's
    # stable range and two float32 summation orders drift apart there
    args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (
        0.3 * rng.normal(size=(c, flat.theta.numel())),
        np.tile(flat.eta.numpy(), (c, 1)),
        rng.normal(size=(c, flat.theta.numel())),
        np.linspace(-2, 2, n)[:, None], rng.normal(size=n))]
    if per_chain:
        eps = torch.tensor(np.repeat([1e-3, 2e-3, 5e-3, 1e-2], c // 4),
                           dtype=torch.float32, device=device)
        steps = torch.tensor(np.repeat([40, 20, 9, 13], c // 4),
                             dtype=torch.int32, device=device)
    else:
        eps = torch.full((c,), 1e-2, device=device)
        steps = torch.full((c,), 13, dtype=torch.int32, device=device)
    before = fused_mlp.fused_trajectory.LAUNCHES
    got = fused_mlp.fused_trajectory(program, *args, eps, steps)
    want = fused_mlp.trajectory_plain(program, *args, eps, steps)
    torch.cuda.synchronize()
    assert fused_mlp.fused_trajectory.LAUNCHES == before + 1
    # tolerances of tests/test_fused_trajectory.py:72-79 (q, v, lp0, lp1)
    for g, w, (rtol, atol) in zip(got, want, [(1e-3, 1e-4), (1e-3, 1e-3),
                                              (1e-4, 1e-3), (1e-4, 1e-2)]):
        _close(g, w, rtol, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("per_chain", [False, True])
def test_k1_uturn_kernel_matches_twin(device, per_chain):
    """K1's U-turn-recording program: q, v, lp0 and lp1 to the tolerances of
    tests/test_fused_trajectory.py:72-79, and the U-turn steps equal but
    where the twin's projection is near 0 (chip_smoke.check_uturns, which
    also requires chains that turn and chains that are censored)."""
    from chip_smoke import K1_TOL, check_uturns, uturn_inputs

    lik = FixedGaussianLikelihood(sd=0.1)
    model, flat = _flagship(lik)
    c, n = 64, 11
    program = fused_mlp.build_trajectory_program(
        model, lik, flat.unravel_theta, flat.unravel_eta, flat.eta.numel(),
        n_rows=n, record_uturn=True)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.linspace(-2, 2, n, device=device)[:, None]
    y = torch.randn(n, generator=g, device=device)
    flat_dev = flat._replace(eta=flat.eta.to(device))
    args = uturn_inputs(program, flat_dev, c, x, y, g)
    if per_chain:
        eps = torch.tensor(np.repeat([1e-3, 2e-3, 5e-3, 1e-2], c // 4),
                           dtype=torch.float32, device=device)
        steps = torch.tensor(np.repeat([100, 50, 25, 13], c // 4),
                             dtype=torch.int32, device=device)
    else:
        eps = torch.full((c,), 1e-3, device=device)
        steps = torch.full((c,), 100, dtype=torch.int32, device=device)
    got = fused_mlp.fused_trajectory(program, *args, eps, steps)
    want = fused_mlp.trajectory_plain(program, *args, eps, steps)
    torch.cuda.synchronize()
    assert len(got) == 5 and got[4].dtype == torch.int32
    for g_, w, (rtol, atol) in zip(got, want, K1_TOL):
        _close(g_, w, rtol, atol)
    check_uturns("K1 record_uturn", program, args, eps, steps, got[4],
                 want[4])


@pytest.mark.cuda
def test_k1_tempered_kernel_matches_twin(device):
    """K1 variant (c): per-chain betas on a rung-major fleet of 4 rungs of
    16 chains with per-rung (eps, L)."""
    lik = FixedGaussianLikelihood(sd=0.1)
    model, flat = _flagship(lik)
    c, n = 64, 11
    program = fused_mlp.build_trajectory_program(
        model, lik, flat.unravel_theta, flat.unravel_eta, flat.eta.numel(),
        n_rows=n, tempered=True)
    rng = np.random.default_rng(3)
    args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (
        0.3 * rng.normal(size=(c, flat.theta.numel())),
        np.tile(flat.eta.numpy(), (c, 1)),
        rng.normal(size=(c, flat.theta.numel())),
        np.linspace(-2, 2, n)[:, None], rng.normal(size=n))]
    eps = torch.tensor(np.repeat([1e-3, 2e-3, 5e-3, 1e-2], c // 4),
                       dtype=torch.float32, device=device)
    steps = torch.tensor(np.repeat([40, 20, 9, 13], c // 4),
                         dtype=torch.int32, device=device)
    betas = torch.tensor(np.repeat([1.0, 0.3, 0.06, 0.01], c // 4),
                         dtype=torch.float32, device=device)
    before = fused_mlp.fused_trajectory.LAUNCHES
    got = fused_mlp.fused_trajectory(program, *args, eps, steps, betas)
    want = fused_mlp.trajectory_plain(program, *args, eps, steps, betas)
    torch.cuda.synchronize()
    assert fused_mlp.fused_trajectory.LAUNCHES == before + 1
    for g, w, (rtol, atol) in zip(got, want, [(1e-3, 1e-4), (1e-3, 1e-3),
                                              (1e-4, 1e-3), (1e-4, 1e-2)]):
        _close(g, w, rtol, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("coupled", [False, True])
def test_k2_kernel_matches_twin(device, coupled):
    lik = (GaussianLikelihood(sd=0.2) if coupled
           else FixedGaussianLikelihood(sd=0.1))
    model, flat = _flagship(lik)
    c, h = 64, flat.eta.numel()
    program = fused_hyper.build_hyper_program(model, lik, flat.unravel_eta,
                                              h, 100)
    rng = np.random.default_rng(1)
    stats = np.abs(rng.normal(size=(c, program.n_stats))) * 10.0
    if coupled:
        stats[:, -1] = 11.0
    args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (
        np.tile(flat.eta.numpy(), (c, 1)) + 0.05 * rng.normal(size=(c, h)),
        stats, rng.normal(size=(c, h)), np.full(c, 1e-3))]
    before = fused_hyper.fused_hyper_trajectory.LAUNCHES
    got = fused_hyper.fused_hyper_trajectory(program, *args)
    want = fused_hyper.hyper_trajectory_plain(program, *args)
    torch.cuda.synchronize()
    assert fused_hyper.fused_hyper_trajectory.LAUNCHES == before + 1
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flagship", "ragged"])
def test_k3_kernel_matches_twin(device, shape):
    if shape == "flagship":
        ops = (("dense", 1, 10), ("tanh", 10), ("dense", 10, 10),
               ("tanh", 10), ("dense", 10, 10), ("tanh", 10),
               ("dense", 10, 1))
        c, n = 64, 11
    else:   # ragged edges in every tile dimension, relu and elu epilogues
        ops = (("dense", 3, 37), ("relu", 37), ("dense", 37, 70),
               ("elu", 70), ("dense", 70, 1))
        c, n = 5, 13
    d0, dk, d = fused_mlp._program_dims(ops)
    rng = np.random.default_rng(2)
    thetas, x, y, sd = (
        torch.tensor(a, dtype=torch.float32, device=device) for a in (
            0.3 * rng.normal(size=(c, d)), rng.normal(size=(n, d0)),
            rng.normal(size=(n, dk)), 0.1 + 0.2 * rng.random(c)))
    vg = fused_mlp.make_fused_potential_vg(ops, n)
    before = fused_mlp.fused_potential.LAUNCHES
    ll, grad = vg(thetas, sd, x, y)
    want_ll, want_grad = fused_mlp.potential_plain(ops, thetas, sd, x, y)
    torch.cuda.synchronize()
    assert fused_mlp.fused_potential.LAUNCHES == before + 1
    # tolerances of tests/test_fused_mlp.py:33-36
    _close(ll, want_ll, 1e-4, 1e-4)
    _close(grad, want_grad, 1e-3, 1e-4)
