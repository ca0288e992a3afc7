"""K1 (untempered, tempered, U-turn-recording, variant (d)'s tails,
activations and priors, and every path of its layer table), K2 (with its
widest item tables) and K3
(with its Bernoulli and categorical tails, slope ops, packed first layer
and split row sums) on an NVIDIA card against their plain twins on the same
card, K1's, K2's and K3's repeats bit-equal, and K1's and K2's entry
points refusing tables that cannot hold; and, with no kernel, the dense
layers' ``matmul_precision`` on the card ("highest" gives the float32
bits with TF32 switched on, "high" differs within TF32's tolerance) and
the chunked likelihood on the card against the CPU in float64; and K3
over row chunks against one unchunked call and the plain chunked path,
on the stepped runner bit-equal to eager; and the
``(chains, data)`` mesh on the card (K1 + K2 on 4x1, K3 + K2 on 2x2, K3
on 1x4, the sharded ``Predictor`` on 2x2) against the same work without
the mesh; and the ``Predictor``'s graph route (a replay of a captured
forward a key, a graph a mesh entry) against its eager route bit for bit,
its results never overwritten by a later call, a failed capture raising;
and the graph chunk runner against the eager runner, without a
mesh and on chains-only meshes (a graph a chain shard), and the stepped
runner without a mesh and on data meshes (its parts split at the data
peers' sums) against the eager mesh runner; each mesh test on a mesh of
this card repeated and on one of distinct cards (which skips on a
machine with fewer); and MAP pretraining, its optimizer steps as replays
of one captured graph, against its eager epochs.

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


def _stack(n_blocks, learned_sd):
    """``chip_smoke.stack_network``'s model on the CPU: K2's widest tables
    (32 items at 16 blocks, 31 with a learned sd at 15)."""
    import chip_smoke as cs

    net, lik = cs.stack_network(torch.device("cpu"), n_blocks, learned_sd)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers())
    return net.model, lik, flat


def _k2_case(device, model, lik, flat, c, n_steps, seed):
    """A K2 program and its inputs: etas around the init, stats of the
    scale of a posterior's (K = 11 rows for a learned sd), eps 1e-3."""
    h = flat.eta.numel()
    program = fused_hyper.build_hyper_program(model, lik, flat.unravel_eta,
                                              h, n_steps)
    rng = np.random.default_rng(seed)
    stats = np.abs(rng.normal(size=(c, program.n_stats))) * 10.0
    if program.coupled:
        stats[:, -1] = 11.0
    args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (
        np.tile(flat.eta.numpy(), (c, 1)) + 0.05 * rng.normal(size=(c, h)),
        stats, rng.normal(size=(c, h)), np.full(c, 1e-3))]
    return program, args


@pytest.mark.cuda
@pytest.mark.parametrize("coupled", [False, True])
def test_k2_two_calls_bit_equal(device, coupled):
    """Two K2 calls on the same inputs give bit-equal q, v, lp0, lp1: the
    flagship at 64 chains, 100 steps, uncoupled and with a learned sd."""
    lik = (GaussianLikelihood(sd=0.2) if coupled
           else FixedGaussianLikelihood(sd=0.1))
    model, flat = _flagship(lik)
    program, args = _k2_case(device, model, lik, flat, 64, 100, 3)
    first = fused_hyper.fused_hyper_trajectory(program, *args)
    second = fused_hyper.fused_hyper_trajectory(program, *args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("coupled", [False, True])
def test_k2_widest_tables_match_twin(device, coupled):
    """K2 against its twin at the widest tables, a chain's items filling
    its warp: 16 blocks uncoupled (32 items, H = 64) and 15 blocks with a
    learned sd (31 items, H = 61), 64 chains, 100 steps."""
    model, lik, flat = _stack(15 if coupled else 16, coupled)
    program, args = _k2_case(device, model, lik, flat, 64, 100, 4)
    assert len(program.items) == (31 if coupled else 32)
    assert program.lanes == 32
    got = fused_hyper.fused_hyper_trajectory(program, *args)
    want = fused_hyper.hyper_trajectory_plain(program, *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["missing_row", "repeated_row",
                                  "coupled_not_last"])
def test_k2_entry_point_refuses_bad_tables(device, case):
    """The wrapper decides K2's item table; the C entry point refuses one
    that does not cover each eta row (and stats column) exactly once, or
    whose coupled term is not the last item."""
    lik = GaussianLikelihood(sd=0.2)
    model, flat = _flagship(lik)
    program, args = _k2_case(device, model, lik, flat, 4, 3, 5)
    items = list(program.items)
    if case == "missing_row":
        items = items[:-2] + items[-1:]
    elif case == "repeated_row":
        items[1] = (items[0][0],) + items[1][1:]
    else:
        items[-2], items[-1] = items[-1], items[-2]
    program.__dict__["items"] = tuple(items)
    program.__dict__["table"] = np.asarray(items, np.int32).reshape(-1)
    program.__dict__["lanes"] = 1 << (len(items) - 1).bit_length()
    with pytest.raises(RuntimeError,
                       match="fused_hyper_trajectory launch failed"):
        fused_hyper.fused_hyper_trajectory(program, *args)


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


@pytest.mark.cuda
@pytest.mark.parametrize("per_chain", [False, True])
@pytest.mark.parametrize("case", ["learned_sd", "bernoulli", "categorical",
                                  "cauchy", "prelu_leakyrelu"])
def test_k1_d_kernel_matches_twin(device, case, per_chain):
    """K1 variant (d) at chip_smoke.py's models: the learned-sd flagship,
    the bench's classification (Bernoulli, SquarePrelu, gauss_raw) and
    multiclass (categorical on class ids) stacks, the Cauchy-compat
    flagship and the Prelu + LeakyRelu stack, from 0.3 N(0, 1) weights,
    to the tolerances of tests/test_fused_trajectory.py:72-79."""
    import chip_smoke as cs

    build = {"learned_sd": lambda d: cs.flagship_network(d, learned_sd=True),
             "bernoulli": cs.classification_network,
             "categorical": cs.multiclass_network,
             "cauchy": lambda d: cs.flagship_network(d, cauchy=True),
             "prelu_leakyrelu": cs.prelu_network}[case]
    net, lik = build(device)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=device))
    program = fused_mlp.build_trajectory_program(
        net.model, lik, flat.unravel_theta, flat.unravel_eta,
        flat.eta.numel(), n_rows=net.train_x.shape[0])
    assert program is not None
    c, d = 64, flat.theta.numel()
    g = torch.Generator(device=device).manual_seed(0)
    args = (0.3 * torch.randn((c, d), generator=g, device=device),
            flat.eta.expand(c, -1).contiguous(),
            torch.randn((c, d), generator=g, device=device),
            net.train_x, net.train_y)
    if per_chain:
        eps = torch.tensor(np.repeat([1e-3, 2e-3, 5e-3, 1e-2], c // 4),
                           dtype=torch.float32, device=device)
        steps = torch.tensor(np.repeat([40, 20, 9, 5], c // 4),
                             dtype=torch.int32, device=device)
    else:
        eps = torch.full((c,), 1e-3, device=device)
        steps = torch.full((c,), 40, dtype=torch.int32, device=device)
    before = fused_mlp.fused_trajectory.LAUNCHES
    got = fused_mlp.fused_trajectory(program, *args, eps, steps)
    want = fused_mlp.trajectory_plain(program, *args, eps, steps)
    torch.cuda.synchronize()
    assert fused_mlp.fused_trajectory.LAUNCHES == before + 1
    for g_, w, (rtol, atol) in zip(got, want, cs.K1_TOL):
        _close(g_, w, rtol, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["bernoulli_sqprelu", "categorical",
                                   "prelu_leakyrelu", "prelu_last"])
def test_k3_tails_and_slope_ops_match_twin(device, shape):
    """K3's Bernoulli and categorical tails (one-hot from class ids) and
    its slope ops (pre-activation planes, slope_grad_kernel), ragged in
    every tile dimension, a prelu after the last dense layer included,
    to the tolerances of tests/test_fused_mlp.py:33-36."""
    ops, lik = {
        "bernoulli_sqprelu": ((("dense", 3, 37), ("sqprelu", 37),
                               ("dense", 37, 70), ("sqprelu", 70),
                               ("dense", 70, 1), ("sigmoid", 1)),
                              "bernoulli"),
        "categorical": ((("dense", 3, 37), ("tanh", 37), ("dense", 37, 10)),
                        "categorical"),
        "prelu_leakyrelu": ((("dense", 3, 37), ("prelu", 37),
                             ("dense", 37, 70), ("leakyrelu", 70, 0.3),
                             ("dense", 70, 1)), "gaussian"),
        "prelu_last": ((("dense", 3, 8), ("tanh", 8), ("dense", 8, 2),
                        ("prelu", 2)), "gaussian"),
    }[shape]
    c, n = 5, 13
    d0, dk, d = fused_mlp._program_dims(ops)
    rng = np.random.default_rng(4)
    y = {"bernoulli": (rng.random(n) > 0.5).astype(np.float32),
         "categorical": rng.integers(0, dk, size=n).astype(np.float32),
         "gaussian": rng.normal(size=(n, dk))}[lik]
    thetas, x, y, sd = (
        torch.tensor(a, dtype=torch.float32, device=device) for a in (
            0.3 * rng.normal(size=(c, d)), rng.normal(size=(n, d0)), y,
            0.1 + 0.2 * rng.random(c)))
    vg = fused_mlp.make_fused_potential_vg(ops, n, lik)
    before = fused_mlp.fused_potential.LAUNCHES
    ll, grad = vg(thetas, sd, x, y)
    want_ll, want_grad = fused_mlp.potential_plain(ops, thetas, sd, x, y,
                                                   lik)
    torch.cuda.synchronize()
    assert fused_mlp.fused_potential.LAUNCHES == before + 1
    _close(ll, want_ll, 1e-4, 1e-4)
    _close(grad, want_grad, 1e-3, 1e-4)


@pytest.mark.cuda
def test_k3_packed_and_split_match_twin(device):
    """K3's packed first layer (C d_out = 21 columns, one ragged tile) and
    its row sums split into uneven slices of 3,001 rows (every weight
    gradient and the slope pass), against the twin, to the tolerances of
    tests/test_fused_mlp.py:33-36."""
    ops = (("dense", 50, 7), ("sqprelu", 7), ("dense", 7, 3), ("dense", 3, 1),
           ("sigmoid", 1))
    c, n = 3, 3001
    d0, _, d = fused_mlp._program_dims(ops)
    rng = np.random.default_rng(8)
    thetas, x, y, sd = (
        torch.tensor(a, dtype=torch.float32, device=device) for a in (
            0.3 * rng.normal(size=(c, d)), rng.normal(size=(n, d0)),
            (rng.random(n) > 0.5).astype(np.float32), np.ones(c)))
    vg = fused_mlp.make_fused_potential_vg(ops, n, "bernoulli")
    plan = vg.args[0].plan(c).layers
    assert plan[0][0] == 1 and all(row[1] > 1 for row in plan)
    assert plan[0][3] > 1 and n % plan[0][2] != 0
    before = fused_mlp.fused_potential.LAUNCHES
    ll, grad = vg(thetas, sd, x, y)
    want_ll, want_grad = fused_mlp.potential_plain(ops, thetas, sd, x, y,
                                                   "bernoulli")
    torch.cuda.synchronize()
    assert fused_mlp.fused_potential.LAUNCHES == before + 1
    _close(ll, want_ll, 1e-4, 1e-4)
    _close(grad, want_grad, 1e-3, 1e-4)


@pytest.mark.cuda
def test_k3_two_calls_bit_equal_at_tutorial_shape(device):
    """The split row sums add their slices in a fixed order (no atomics):
    two K3 calls on the same inputs at the tutorial shape (784-20-20-1,
    9,585 rows, 64 chains) give bit-equal ll and grad."""
    import chip_smoke as cs

    net, lik = cs.tutorial_network(device)
    ops, tail = fused_mlp._model_program(net.model, lik)
    _, _, d = fused_mlp._program_dims(ops)
    vg = fused_mlp.make_fused_potential_vg(ops, cs.TUTORIAL_ROWS, tail)
    assert any(row[1] > 1 for row in vg.args[0].plan(64).layers)
    g = torch.Generator(device=device).manual_seed(0)
    thetas = 0.3 * torch.randn((64, d), generator=g, device=device)
    first = vg(thetas, 1.0, net.train_x, net.train_y)
    second = vg(thetas, 1.0, net.train_x, net.train_y)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("record", [False, True])
def test_k1_fused_paths_match_twin(device, record):
    """K1 at chip_smoke.fused_paths_network's stack, which takes every path
    of the layer table (an elu with its pre-activation plane, a relu after
    it as a layer of its own, a sigmoid and an exp fused into their dense
    layers), at per-chain L in {1, 2, 3, 40}, with and without U-turn
    recording, to the tolerances of tests/test_fused_trajectory.py:72-79.
    The U-turn steps equal the twin's at L = 1 and 2, and elsewhere but at
    a near-zero projection (chip_smoke.UTURN_NEAR_ZERO)."""
    import chip_smoke as cs

    net, lik = cs.fused_paths_network(device)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, {})
    program = fused_mlp.build_trajectory_program(
        net.model, lik, flat.unravel_theta, flat.unravel_eta,
        flat.eta.numel(), n_rows=net.train_x.shape[0], record_uturn=record)
    assert program is not None and program.barriers_per_step == 10
    c, d = 64, flat.theta.numel()
    g = torch.Generator(device=device).manual_seed(4)
    args = (0.3 * torch.randn((c, d), generator=g, device=device),
            flat.eta.to(device).expand(c, -1).contiguous(),
            torch.randn((c, d), generator=g, device=device),
            net.train_x, net.train_y)
    eps = torch.tensor(np.repeat([1e-3, 2e-3, 5e-3, 1e-2], c // 4),
                       dtype=torch.float32, device=device)
    steps = torch.tensor(np.repeat([1, 2, 3, 40], c // 4), dtype=torch.int32,
                         device=device)
    before = fused_mlp.fused_trajectory.LAUNCHES
    got = fused_mlp.fused_trajectory(program, *args, eps, steps)
    want = fused_mlp.trajectory_plain(program, *args, eps, steps)
    torch.cuda.synchronize()
    assert fused_mlp.fused_trajectory.LAUNCHES == before + 1
    assert len(got) == 4 + record
    for g_, w, (rtol, atol) in zip(got, want, cs.K1_TOL):
        _close(g_, w, rtol, atol)
    if record:
        ut, ut_want = got[4].cpu(), want[4].cpu()
        short = steps.cpu() <= 2
        assert torch.equal(ut[short], ut_want[short])
        for i in (ut != ut_want).nonzero()[:, 0].tolist():
            step = min(s for s in (int(ut[i]), int(ut_want[i])) if s > 0)
            proj, scale = cs.uturn_projection(program, args, eps, i, step)
            assert abs(proj) < cs.UTURN_NEAR_ZERO * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flagship_c64", "uturn_c512"])
def test_k1_two_calls_bit_equal(device, shape):
    """Two K1 calls on the same inputs give bit-equal q, v, lp0, lp1 (and
    U-turn steps): the flagship at 64 chains, (eps, L) = (1e-3, 100), and
    the U-turn-recording program at 512 chains, (5e-4, 200)."""
    import chip_smoke as cs

    lik = FixedGaussianLikelihood(sd=0.1)
    model, flat = _flagship(lik)
    record = shape == "uturn_c512"
    c, n = (512, 11) if record else (64, 11)
    program = fused_mlp.build_trajectory_program(
        model, lik, flat.unravel_theta, flat.unravel_eta, flat.eta.numel(),
        n_rows=n, record_uturn=record)
    g = torch.Generator(device=device).manual_seed(6)
    x = torch.linspace(-2, 2, n, device=device)[:, None]
    y = torch.randn(n, generator=g, device=device)
    flat_dev = flat._replace(eta=flat.eta.to(device))
    if record:
        args = cs.uturn_inputs(program, flat_dev, c, x, y, g)
    else:
        d = flat.theta.numel()
        args = (0.3 * torch.randn((c, d), generator=g, device=device),
                flat_dev.eta.expand(c, -1).contiguous(),
                torch.randn((c, d), generator=g, device=device), x, y)
    eps, steps = (5e-4, 200) if record else (1e-3, 100)
    first = fused_mlp.fused_trajectory(program, *args, eps, steps)
    second = fused_mlp.fused_trajectory(program, *args, eps, steps)
    torch.cuda.synchronize()
    assert len(first) == 4 + record
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deriv_without_act", "deriv_before_op",
                                  "merge_recording_wide_layer0"])
def test_k1_entry_point_refuses_flags_that_cannot_hold(device, case):
    """The wrapper decides each layer's ``deriv`` and the update's
    ``merge``; the C entry point refuses a flag the kernel cannot run: a
    derivative fused where there is no elementwise activation or where no
    dense layer takes the output's gradient, and an update merged into
    layer 0's phase by a recording program whose layer 0 has more rows
    than the value threads."""
    import chip_smoke as cs

    build = {"deriv_without_act": cs.flagship_network,
             "deriv_before_op": cs.fused_paths_network,
             "merge_recording_wide_layer0": cs.classification_network}[case]
    net, lik = build(device)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=device))
    program = fused_mlp.build_trajectory_program(
        net.model, lik, flat.unravel_theta, flat.unravel_eta,
        flat.eta.numel(), n_rows=net.train_x.shape[0],
        record_uturn=case == "merge_recording_wide_layer0")
    layers = [list(row) for row in program.layers]
    if case == "merge_recording_wide_layer0":
        assert not program.update_merged
        program.__dict__["update_merged"] = True
    else:
        # the last layer has no activation; the fused-paths elu is
        # followed by a relu, a layer of its own
        l = (len(layers) - 1 if case == "deriv_without_act" else
             next(i for i in range(len(layers) - 1)
                  if layers[i + 1][0] == 0))
        assert layers[l][6] == 0
        layers[l][6] = 1
        program.__dict__["layers"] = tuple(map(tuple, layers))
        program.__dict__["table"] = np.asarray(layers, np.int32).reshape(-1)
    c, d = 4, flat.theta.numel()
    args = (torch.zeros((c, d), device=device),
            flat.eta.to(device).expand(c, -1).contiguous(),
            torch.zeros((c, d), device=device), net.train_x, net.train_y)
    with pytest.raises(RuntimeError, match="fused_trajectory launch failed"):
        fused_mlp.fused_trajectory(program, *args, 1e-3, 3)


def _dense_stack(**kw):
    return Sequential([GaussianDenseLayer(8, 64, **kw), Tanh(),
                       GaussianDenseLayer(64, 64, **kw), Tanh(),
                       GaussianDenseLayer(64, 1, **kw)])


def _stack_value_and_grad(model, params, x, dev):
    """The stack's output sum and its gradient with respect to every
    parameter, on ``dev``."""
    leaves = [{k: v.to(dev).requires_grad_() for k, v in p.items()}
              for p in params]
    out = model.apply(tuple(leaves), x.to(dev)).sum()
    grads = torch.autograd.grad(out, [t for p in leaves for t in p.values()])
    return [out.detach()] + [g.detach() for g in grads]


@pytest.mark.cuda
def test_highest_precision_gives_float32_bits_with_tf32_on(device):
    """``matmul_precision="highest"`` with the process's TF32 switched on
    gives the float32 products' bits (TF32 off) in the value and in every
    gradient; ``"high"`` differs from them within TF32's tolerance (rtol
    1e-2 of the largest entry: 10-bit operands over 64-wide sums)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(4096, 8)), dtype=torch.float32)
    params, _ = _dense_stack().init(torch.Generator().manual_seed(0))
    want = _stack_value_and_grad(_dense_stack(), params, x, device)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = _stack_value_and_grad(_dense_stack(matmul_precision="highest"),
                                    params, x, device)
        high = _stack_value_and_grad(_dense_stack(matmul_precision="high"),
                                     params, x, device)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert any(not torch.equal(h, w) for h, w in zip(high, want))
    for h, w in zip(high, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(h, w, rtol=0, atol=1e-2 * scale)


@pytest.mark.cuda
def test_chunked_value_and_grad_match_the_cpu_in_float64(device):
    """The chunked likelihood's value and gradient (8 chunks of 512 rows,
    8 chains, a learned sd, "highest" products) on the card against the
    same oracle on the CPU in float64, at the same float32 states: relative
    1e-5 on the value, 1e-5 of the largest entry on the gradient."""
    v32, g32 = _chunked_main_vg(device, torch.float32)
    v64, g64 = _chunked_main_vg("cpu", torch.float64)
    torch.testing.assert_close(v32.double(), v64, rtol=1e-5, atol=0)
    torch.testing.assert_close(g32.double(), g64, rtol=0,
                               atol=1e-5 * float(g64.abs().max()))


def _chunked_main_vg(dev, dt):
    """``main_vg`` of the chunked surrogate-shaped potential at 8 float32
    states, evaluated on ``dev`` in ``dt``; returned on the CPU."""
    from tensorbnn_tpu_torch.sampler.potential import make_potentials
    lik = GaussianLikelihood(sd=0.1)
    model = _dense_stack(matmul_precision="highest")
    params, hypers = model.init(torch.Generator().manual_seed(1))
    flat = flatten_state(params, hypers, lik.init_hypers())
    rng = np.random.default_rng(1)
    thetas = flat.theta + 0.01 * torch.tensor(
        rng.normal(size=(8, flat.theta.numel())), dtype=torch.float32)
    x = rng.normal(size=(4096, 8))
    y = np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=4096)
    pots = make_potentials(
        model, lik, torch.tensor(x, dtype=torch.float32).to(dev, dt),
        torch.tensor(y, dtype=torch.float32).to(dev, dt),
        flat.unravel_theta, flat.unravel_eta, data_chunk=512)
    v, g = pots.main_vg(thetas.to(dev, dt),
                        flat.eta.expand(8, -1).to(dev, dt))
    return v.cpu(), g.cpu()


# -- the (chains, data) mesh on the card: a virtual mesh whose entries are
# all this card (a device may repeat in a port mesh), or distinct cards ----

MESH_LAYOUTS = ["repeated", "distinct"]


def _mesh(device, n_chain, n_data, layout):
    """An ``n_chain x n_data`` mesh of this card repeated, or of as many
    distinct cards (skips where the machine has fewer)."""
    from tensorbnn_tpu_torch.parallel.mesh import make_mesh
    n = n_chain * n_data
    if layout == "repeated":
        return make_mesh(n_chain, n_data, devices=[device] * n)
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards for a mesh of distinct cards")
    return make_mesh(n_chain, n_data,
                     devices=[torch.device("cuda", i) for i in range(n)])


def _moves(samples):
    """The MH decisions between recorded samples: True where a chain's
    state moved."""
    return (samples[1:] != samples[:-1]).any(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_chains_mesh_on_k1_and_k2_matches_the_meshless_run(device, layout):
    """The flagship at 64 chains through ``Network.train`` on a 4x1 mesh:
    K1 and K2 run on each chain shard (4 launches each an epoch), and the
    samples equal the mesh-less run's from the same seed within 1e-6 of
    their largest entry (a shard's 16 chains run K1's and K2's per-chain
    arithmetic as the fleet's 64 do; only the glue's row sums may take
    another order for a smaller batch)."""
    from tensorbnn_tpu_torch import Network
    x = np.linspace(-2, 2, 11)
    y = np.sin(x * np.pi * 2) * x - np.cos(x * np.pi)
    res, launches = [], []
    for mesh in (None, _mesh(device, 4, 1, layout)):
        net = Network(torch.float32, 1, x, y, x, y, seed=0, device=device)
        for layer in _flagship(FixedGaussianLikelihood(sd=0.1))[0].layers:
            net.add(layer)
        net.setup_mcmc(burnin=0, leapfrog_start=20, step_size_start=1e-3,
                       hyper_leapfrog=30, averaging_steps=10)
        k1, k2 = (fused_mlp.fused_trajectory.LAUNCHES,
                  fused_hyper.fused_hyper_trajectory.LAUNCHES)
        res.append(net.train(3, 1, FixedGaussianLikelihood(sd=0.1),
                             n_chains=64, chain_jitter=0.01, mesh=mesh,
                             verbose=False))
        torch.cuda.synchronize()
        launches.append((fused_mlp.fused_trajectory.LAUNCHES - k1,
                         fused_hyper.fused_hyper_trajectory.LAUNCHES - k2))
    assert res[1].main_path == "K1" and res[1].fused_hyper
    assert [r.chunk_runner for r in res] == ["graph", "graph"]
    assert launches == [(3, 3), (12, 12)]
    want = res[0].theta_samples
    np.testing.assert_array_equal(_moves(res[1].theta_samples),
                                  _moves(want))
    np.testing.assert_allclose(res[1].theta_samples, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_data_mesh_train_on_k3_and_k2_matches_the_meshless_run(device,
                                                                layout):
    """A learned-sd 4-32-1 tanh network over 600 rows (K1 declines: its
    planes need more than the card's shared memory) at 64 chains through
    ``Network.train`` on a 2x2 mesh: K3 on each of 4 shards of 300 rows
    and the coupled K2 on each chain shard, against the mesh-less K3
    run from the same seed over 3 epochs: the same main and hyper MH
    decisions, samples within 1e-5 of their largest entry (the likelihood
    summed in two halves), the main block's move 10 times that."""
    from tensorbnn_tpu_torch import Network
    rng = np.random.default_rng(4)
    x = rng.normal(size=(600, 4)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    res, launches = [], []
    for mesh in (None, _mesh(device, 2, 2, layout)):
        net = Network(torch.float32, 4, x, y, x, y, seed=0, device=device)
        net.add(GaussianDenseLayer(4, 32)).add(Tanh())
        net.add(GaussianDenseLayer(32, 1))
        net.setup_mcmc(burnin=0, step_size_start=1e-3, leapfrog_start=10,
                       leapfrog_min=10, leapfrog_max=10, hyper_leapfrog=5,
                       hyper_step_size=1e-4, averaging_steps=10)
        k3, k2 = (fused_mlp.fused_potential.LAUNCHES,
                  fused_hyper.fused_hyper_trajectory.LAUNCHES)
        res.append(net.train(3, 1, GaussianLikelihood(sd=0.3), n_chains=64,
                             chain_jitter=0.01, mesh=mesh, verbose=False))
        torch.cuda.synchronize()
        launches.append((fused_mlp.fused_potential.LAUNCHES - k3,
                         fused_hyper.fused_hyper_trajectory.LAUNCHES - k2))
    assert [r.main_path for r in res] == ["K3", "K3"]
    assert res[1].fused_hyper
    assert launches == [(3 * 11, 3), (4 * 3 * 11, 2 * 3)]
    want = res[0].theta_samples
    scale = np.abs(want).max()
    assert np.abs(want[-1] - want[0]).max() > 10 * 1e-5 * scale
    for field in ("theta_samples", "eta_samples"):
        np.testing.assert_array_equal(_moves(getattr(res[1], field)),
                                      _moves(getattr(res[0], field)))
    np.testing.assert_allclose(res[1].theta_samples, want, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_data_mesh_k3_matches_the_meshless_k3(device, layout):
    """K3 built for 16 rows, run on each of 4 data peers and summed on
    the first before the priors, against K3 over all 64 rows: value and
    gradient within rtol 1e-5 (atol 1e-5 of the largest gradient entry)."""
    from tensorbnn_tpu_torch.parallel.mesh import DataPeers
    lik = GaussianLikelihood(sd=0.1)
    model, flat = _flagship(lik)
    rng = np.random.default_rng(3)
    x = torch.tensor(np.linspace(-2, 2, 64)[:, None], dtype=torch.float32,
                     device=device)
    y = torch.sin(2 * x[:, 0])
    thetas = (0.3 * torch.randn((32, flat.theta.numel()),
                                generator=torch.Generator().manual_seed(3))
              ).to(device)
    etas = torch.tensor(np.tile(flat.eta.numpy(), (32, 1)) + 0.01
                        * rng.normal(size=(32, flat.eta.numel())),
                        dtype=torch.float32, device=device)
    h = flat.eta.numel()
    peers = DataPeers.split(_mesh(device, 1, 4, layout).devices[0], x, y)
    sharded = fused_mlp.try_build_fused_main_vg(
        model, lik, flat.unravel_theta, flat.unravel_eta, *peers.shards[0],
        h, n_rows=16)
    whole = fused_mlp.try_build_fused_main_vg(
        model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h)
    before = fused_mlp.fused_potential.LAUNCHES
    got = sharded(thetas, etas, *peers.shards[0], peers=peers)
    torch.cuda.synchronize()
    assert fused_mlp.fused_potential.LAUNCHES - before == 4
    want = whole(thetas, etas, x, y)
    _close(got[0], want[0], 1e-5, 0)
    _close(got[1], want[1], 1e-5, 1e-5 * float(want[1].abs().max()))


def _flagship_predictor(device, tmp_path, n_nets):
    """A ``Predictor`` on ``device`` over an npz store of ``n_nets``
    flagship networks around its seed-0 init (sd 0.1, numpy seed 2), and
    that numpy generator."""
    from tensorbnn_tpu_torch import Predictor
    from tensorbnn_tpu_torch.io import checkpoint
    from tensorbnn_tpu_torch.sampler.potential import host_unraveler
    lik = FixedGaussianLikelihood(sd=0.1)
    model, flat = _flagship(lik)
    rng = np.random.default_rng(2)
    thetas = (flat.theta.numpy()[None] + 0.1 * rng.normal(
        size=(n_nets, flat.theta.numel()))).astype(np.float32)
    params, hypers = model.init(torch.Generator().manual_seed(0))
    hyper_samples = tuple({k: np.broadcast_to(v.numpy(), (n_nets,))
                           for k, v in hp.items()} for hp in hypers)
    d = str(tmp_path / "run")
    checkpoint.save_samples(d, host_unraveler(params)(thetas),
                            hyper_samples, {})
    return Predictor(d, likelihood=lik, layers=model.layers,
                     device=device), rng


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_sharded_predictor_on_the_card(device, tmp_path, layout):
    """11 flagship networks over 13 rows on a 2x2 mesh (both padded)
    against the unsharded ``predict``, within 1e-6: the blocks run batched
    products of other shapes, which may sum in another order."""
    pred, rng = _flagship_predictor(device, tmp_path, 11)
    x = rng.normal(size=(13, 1)).astype(np.float32)
    want = pred.predict(x)
    got = pred.predict(x, mesh=_mesh(device, 2, 2, layout))
    assert got.shape == want.shape == (11, 13, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- the Predictor's graph route (parallel/graphs.py::ForwardGraph) against
# its eager route ----------------------------------------------------------

PREDICT_MESHES = ["none"] + MESH_LAYOUTS


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", PREDICT_MESHES)
def test_predictor_graph_route_matches_eager_on_the_card(device, tmp_path,
                                                         mesh):
    """301 flagship networks at n = 1 and 2 over 64 and 203 rows, three
    calls a key with new inputs: the graph route (a key's first call its
    warm-up, then replays) equal to the eager route bit for bit, without a
    mesh and on 2x2 (padded on both axes); one warm-up and one capture a
    key (an entry and key on the mesh), replays after."""
    from tensorbnn_tpu_torch.parallel import graphs
    pred, rng = _flagship_predictor(device, tmp_path, 301)
    m = None if mesh == "none" else _mesh(device, 2, 2, mesh)
    entries = 1 if m is None else 4
    graphs.COUNTS.reset()
    calls = 0
    for n in (1, 2):
        for rows in (64, 203):
            for _ in range(3):
                x = rng.normal(size=(rows, 1)).astype(np.float32)
                pred._eager = True
                want = pred.predict(x, n, mesh=m)
                pred._eager = False
                got = pred.predict(x, n, mesh=m)
                assert got.shape == (-(-301 // n), rows, 1)
                np.testing.assert_array_equal(got.view(np.int32),
                                              want.view(np.int32))
                calls += 1
    keys = 4 * entries
    assert (graphs.COUNTS.warmups, graphs.COUNTS.captures,
            graphs.COUNTS.replays) == (keys, keys, calls * entries - keys)


@pytest.mark.cuda
def test_predictor_graph_results_are_not_aliased(device, tmp_path):
    """Three ``predict`` and three ``predict_tensor`` calls of one key with
    new inputs: each earlier result keeps its values, and no tensor result
    shares memory with the graph's output."""
    pred, rng = _flagship_predictor(device, tmp_path, 300)
    got, want = [], []
    for method in ("predict", "predict_tensor", "predict_tensor",
                   "predict", "predict_tensor", "predict"):
        x = rng.normal(size=(100, 1)).astype(np.float32)
        got.append(getattr(pred, method)(x))
        pred._eager = True
        want.append(pred.predict(x))
        pred._eager = False
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g if isinstance(g, np.ndarray) else g.cpu().numpy(), w)
    static = pred._graphs[(1, 100, 1)].out
    assert all(g.data_ptr() != static.data_ptr() for g in got
               if torch.is_tensor(g))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", PREDICT_MESHES)
def test_predictor_capture_failure_raises(device, tmp_path, mesh):
    """A forward that copies from pageable host memory cannot be captured:
    ``predict`` raises at every call (it never carries on eagerly) and
    keeps no graph."""
    pred, rng = _flagship_predictor(device, tmp_path, 20)
    m = None if mesh == "none" else _mesh(device, 2, 2, mesh)
    apply = pred._apply_ens

    def copying(ens, x):
        torch.as_tensor(np.zeros(4, np.float32), device=x.device)
        return apply(ens, x)

    pred._apply_ens = copying
    x = rng.normal(size=(16, 1)).astype(np.float32)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            pred.predict(x, mesh=m)
    torch.cuda.synchronize()
    assert not pred._graphs
    assert m is None or not pred._mesh_cache[2]


@pytest.mark.cuda
def test_the_collector_is_off_while_a_capture_is_open(device):
    """A collection inside a capture could destroy an unreachable graph (a
    graph runner's, in a reference cycle), which a capture in "global"
    mode refuses: the Predictor's first capture after the graph runners'
    tests failed so. ``CudaGraph.open`` turns the collector off until
    ``close``, which turns it back on, after a failed capture too."""
    import gc
    from tensorbnn_tpu_torch.parallel import graphs
    pool = graphs.CudaGraph.new_pool()
    seen = []

    def body():
        seen.append(gc.isenabled())
        return torch.ones(4, device=device) * 2

    graphs.CudaGraph.segment(body, device, pool).replay()
    assert seen == [False] and gc.isenabled()
    with pytest.raises(RuntimeError):
        graphs.CudaGraph.segment(lambda: torch.as_tensor(
            np.zeros(4, np.float32), device=device), device, pool)
    torch.cuda.synchronize()
    assert gc.isenabled()


# -- the graph chunk runner (parallel/graphs.py) against the eager runner,
# and the driver's runs on it --------------------------------------------

def _bits(t):
    """A tensor's bits, NaNs included, for comparisons bit for bit."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _same_bits(got, want, what):
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), (what, field)
        if g is not None:
            assert torch.equal(_bits(g), _bits(w)), (what, field)


def _graph_cell(device, cell):
    """The runner pieces of one K1 cell: ``(model, lik, flat, x, y, c,
    hyper_steps, tempering_beta, uturn, chunks)``, ``chunks`` two chunks'
    ``(eps, L, n_epochs)`` whose (eps, L) differ."""
    from tensorbnn_tpu_torch import BernoulliLikelihood, \
        CategoricalLikelihood, Sigmoid, Softmax, SquarePrelu
    from tensorbnn_tpu_torch.sampler.tempering import make_ladder
    rng = np.random.default_rng(0)
    tempering_beta, uturn, hyper_steps = None, False, 30
    if cell in ("classification", "multiclass"):
        if cell == "classification":
            model = Sequential([GaussianDenseLayer(10, 16), SquarePrelu(16),
                                GaussianDenseLayer(16, 16), SquarePrelu(16),
                                GaussianDenseLayer(16, 1), Sigmoid()])
            lik = BernoulliLikelihood()
            x = rng.normal(size=(64, 10))
            y = (x.sum(1) > 0).astype(np.float64)
            chunks = ((5e-4, 50, 3), (1e-3, 40, 2))
            hyper_steps = 10
        else:
            model = Sequential([GaussianDenseLayer(2, 8), Tanh(),
                                GaussianDenseLayer(8, 3), Softmax()])
            lik = CategoricalLikelihood()
            x = rng.normal(size=(64, 2))
            y = rng.integers(0, 3, size=64).astype(np.float64)
            chunks = ((5e-3, 20, 3), (2e-3, 30, 3))
            hyper_steps = 5
        c = 128
    else:
        lik = FixedGaussianLikelihood(sd=0.1)
        model = _flagship(lik)[0]
        x = np.linspace(-2, 2, 11)[:, None]
        y = np.sin(x[:, 0] * np.pi * 2) * x[:, 0] - np.cos(x[:, 0] * np.pi)
        c = {"flagship": 64, "g4": 512, "tempered": 512, "uturn": 64}[cell]
        chunks = ((2e-3, 20, 3), (1e-3, 30, 3))
        if cell in ("g4", "tempered"):
            groups = ((2e-3, 20), (1e-3, 30), (3e-3, 13), (5e-4, 40))
            a = np.repeat(np.asarray(groups), c // 4, axis=0)
            b = a[::-1].copy()
            chunks = tuple((g[:, 0].astype(np.float32), g[:, 1].astype(
                np.int64), 3) for g in (a, b))
        if cell == "tempered":
            tempering_beta = (4, np.repeat(make_ladder(4, 0.5), c // 4))
        if cell == "uturn":
            uturn = True
            chunks = ((2e-3, np.asarray([40, 20, 60]), 3),
                      (3e-3, np.asarray([30, 50, 10]), 3))
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = flatten_state(params, hypers, lik.init_hypers())
    x = torch.tensor(x, dtype=torch.float32, device=device)
    y = torch.tensor(y, dtype=torch.float32, device=device)
    return (model, lik, flat, x, y, c, hyper_steps, tempering_beta, uturn,
            chunks)


def _runner(device, pieces, eager, mesh=None):
    from tensorbnn_tpu_torch.parallel.chains import \
        make_multichain_chunk_runner
    model, lik, flat, x, y, c, hyper_steps, tempering_beta, uturn, _ = \
        pieces
    h = flat.eta.numel()
    traj = fused_mlp.try_build_fused_trajectory(
        model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h,
        tempered=tempering_beta is not None, record_uturn=uturn)
    hyper = fused_hyper.try_build_fused_hyper_trajectory(
        model, lik, flat.unravel_eta, h, hyper_steps)
    assert traj is not None
    return make_multichain_chunk_runner(
        model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
        adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
        hyper_step_size_init=1e-3, eta_dim=h, batched_main_traj=traj,
        batched_hyper_traj=hyper, tempering_beta=tempering_beta,
        record_uturn=uturn, per_epoch_leapfrog=uturn, eager=eager,
        mesh=mesh)


GRAPH_CELLS = ["flagship", "g4", "tempered", "uturn", "classification",
               "multiclass"]


def _graph_against_eager(device, cell, mesh=None):
    """Two chunks whose (eps, L) differ through the graph runner and the
    eager runner of ``cell`` on ``mesh`` (None: no mesh), from one carry
    and one generator seed: the carry, every trace (samples, acceptances,
    SJD, swap flags, U-turn steps) and the generator's state bit for bit,
    and the kernels' launch counters equal; one capture a chunk key and
    chain shard (classification's one-epoch graph serves both chunks) and
    one warm-up epoch a shard."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    pieces = _graph_cell(device, cell)
    flat, c, chunks = pieces[2], pieces[5], pieces[9]
    carry0 = init_multichain_state(
        flat.theta.to(device), flat.eta.to(device), 1e-3, c,
        torch.Generator(device=device).manual_seed(2), jitter=0.01)
    out = {}
    for eager in (True, False):
        run = _runner(device, pieces, eager, mesh)
        assert run.runner == ("eager" if eager else "graph")
        graphs.COUNTS.reset()
        gen = torch.Generator(device=device).manual_seed(5)
        counters = graphs.COUNTED
        before = [fn.LAUNCHES for fn in counters]
        carry, got = carry0, []
        for eps, leap, n in chunks:
            carry, trace = run(carry, eps, leap, n, gen)
            got.append((carry, trace))
        torch.cuda.synchronize()
        out[eager] = (got, gen.get_state(),
                      [fn.LAUNCHES - b for fn, b in zip(counters, before)],
                      graphs.COUNTS.as_dict())
    for (cg, tg), (ce, te) in zip(out[False][0], out[True][0]):
        _same_bits(cg, ce, "carry")
        _same_bits(tg, te, "trace")
    assert torch.equal(out[False][1], out[True][1])
    assert out[False][2] == out[True][2] and out[True][2][0] > 0
    counts = out[False][3]
    shards = 1 if mesh is None else len(mesh.devices)
    keys = 1 if cell == "classification" else len({n for *_, n in chunks})
    assert (counts["captures"], counts["warmups"]) == (keys * shards,
                                                       shards), counts
    assert out[True][3]["captures"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", GRAPH_CELLS)
def test_graph_runner_matches_eager_runner_on_the_card(device, cell):
    """``_graph_against_eager`` without a mesh."""
    _graph_against_eager(device, cell)


#: the mesh graph runner's cells: each a chains-only mesh
MESH_GRAPH_CELLS = [("flagship", 4), ("g4", 4), ("uturn", 2),
                    ("multiclass", 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
@pytest.mark.parametrize("cell,n_chain", MESH_GRAPH_CELLS)
def test_mesh_graph_runner_matches_eager_mesh_runner_on_the_card(
        device, cell, n_chain, layout):
    """``_graph_against_eager`` on an ``n_chain`` x 1 mesh (a graph a chain
    shard on its home card; the G = 4 cell one adapter group a shard)."""
    _graph_against_eager(device, cell, _mesh(device, n_chain, 1, layout))


def _resume_net(device, seed=5):
    from tensorbnn_tpu_torch import Network
    x = np.linspace(-1, 1, 9).astype(np.float32)
    y = np.sin(x * np.pi).astype(np.float32)
    net = Network(torch.float32, 1, x, y, x, y, seed=seed, device=device)
    net.add(GaussianDenseLayer(1, 5)).add(Tanh())
    net.add(GaussianDenseLayer(5, 1))
    net.setup_mcmc(step_size_start=1e-3, leapfrog_start=6, leapfrog_min=4,
                   leapfrog_max=10, burnin=10, averaging_steps=5,
                   hyper_leapfrog=5, random_steps=2, adapter_seed=0)
    return net, FixedGaussianLikelihood(sd=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["buffered", "tempered", "uturn"])
def test_graph_run_resumed_is_bit_equal_on_the_card(device, tmp_path, case,
                                                    monkeypatch):
    """A run on the graph runner stopped at a checkpoint (epoch 15) and
    resumed equals the uninterrupted run bit for bit (samples, acceptance,
    SJD), and the uninterrupted run equals the same run on the eager
    runner: the checkpoint's generator state stands where the eager
    run's does after the replays."""
    from tensorbnn_tpu_torch.parallel import chains, graphs
    kw = {"buffered": dict(n_chains=4),
          "tempered": dict(n_chains=4, tempering=2,
                           tempering_beta_min=0.5),
          "uturn": dict(n_chains=4, trajectory="uturn")}[case]
    kw |= dict(verbose=False, chain_jitter=0.05)

    def train(epochs, ckpt=None):
        net, lik = _resume_net(device)
        return net.train(epochs, 2, lik, checkpoint_dir=ckpt,
                         checkpoint_every=1, **kw)

    full = train(30)
    assert full.main_path == "K1" and full.chunk_runner == "graph"
    ckpt = str(tmp_path / "ckpt")
    first = train(15, ckpt)
    assert first.n_epochs == 15
    res = train(30, ckpt)
    assert res.resume_epoch == 15 and res.chunk_runner == "graph"
    np.testing.assert_array_equal(res.theta_samples, full.theta_samples)
    np.testing.assert_array_equal(res.eta_samples, full.eta_samples)
    for name in ("main_accept", "hyper_accept", "sjd", "leapfrog"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(full, name)[15:])
    # the same run on the eager runner
    monkeypatch.setattr(chains, "chunk_runner_kind", lambda *a: "eager")
    eager = train(30)
    assert eager.chunk_runner == "eager"
    np.testing.assert_array_equal(eager.theta_samples, full.theta_samples)
    for name in ("main_accept", "hyper_accept", "sjd"):
        np.testing.assert_array_equal(getattr(eager, name),
                                      getattr(full, name))
    assert graphs.COUNTS.replays > 0


def _capture_failure_raises(device, mesh=None):
    """An epoch that copies from pageable host memory cannot be captured:
    the graph runner (on ``mesh``, None: no mesh) raises (it never carries
    on eagerly), and the kernels' launch counters read as they did
    before."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state, \
        make_multichain_chunk_runner
    model, lik, flat, x, y, c, hyper_steps, _, _, chunks = _graph_cell(
        device, "flagship")
    h = flat.eta.numel()
    traj = fused_mlp.try_build_fused_trajectory(
        model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h)

    def copying_traj(*args):
        torch.as_tensor(np.zeros(4, np.float32), device=args[0].device)
        return traj(*args)

    run = make_multichain_chunk_runner(
        model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
        adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
        hyper_step_size_init=1e-3, eta_dim=h,
        batched_main_traj=copying_traj, mesh=mesh)
    assert run.runner == "graph"
    carry = init_multichain_state(flat.theta.to(device), flat.eta.to(device),
                                  1e-3, c)
    before = [fn.LAUNCHES for fn in graphs.COUNTED]
    captures = graphs.COUNTS.captures
    eps, leap, n = chunks[0]
    with pytest.raises(RuntimeError, match="capture"):
        run(carry, eps, leap, n, torch.Generator(device=device))
    torch.cuda.synchronize()
    assert [fn.LAUNCHES for fn in graphs.COUNTED] == before
    assert graphs.COUNTS.captures == captures


@pytest.mark.cuda
def test_graph_capture_failure_raises(device):
    """``_capture_failure_raises`` without a mesh."""
    _capture_failure_raises(device)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_mesh_graph_capture_failure_raises(device, layout):
    """``_capture_failure_raises`` on a 2x1 mesh."""
    _capture_failure_raises(device, _mesh(device, 2, 1, layout))


@pytest.mark.cuda
def test_driver_takes_the_graph_runner_for_k1_alone(device):
    """``Network.train`` on the card: K1 cells run on graphs of the chunk,
    a K3 cell (a 256-wide layer) on the stepped runner's graphs."""
    from tensorbnn_tpu_torch import Network
    net, lik = _resume_net(device)
    assert net.train(4, 1, lik, n_chains=4,
                     verbose=False).chunk_runner == "graph"
    x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    wide = Network(torch.float32, 4, x, x[:, 0], x, x[:, 0], seed=0,
                   device=device)
    wide.add(GaussianDenseLayer(4, 256)).add(Tanh())
    wide.add(GaussianDenseLayer(256, 256)).add(Tanh())
    wide.add(GaussianDenseLayer(256, 1))
    wide.setup_mcmc(leapfrog_start=5, leapfrog_min=5, leapfrog_max=5,
                    hyper_leapfrog=5, step_size_start=1e-4)
    res = wide.train(2, 1, GaussianLikelihood(sd=0.1), n_chains=4,
                     verbose=False)
    assert res.main_path == "K3" and res.chunk_runner == "stepped"


@pytest.mark.cuda
def test_graph_runs_leave_no_memory_behind(device):
    """Tempered runs (cuBLAS inside the graph) on the graph runner: after
    the first (which gives the side stream its cuBLAS workspace), each run
    leaves the card's allocated memory where it found it."""
    import gc
    held = []
    for _ in range(3):
        net, lik = _resume_net(device)
        res = net.train(12, 2, lik, n_chains=8, tempering=2,
                        tempering_beta_min=0.5, chain_jitter=0.05,
                        verbose=False)
        assert res.chunk_runner == "graph"
        del net, res
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[1] == held[0] and held[2] == held[0], held


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_mesh_graph_runs_leave_no_memory_behind(device, layout):
    """Runs on a 2x1 mesh through ``Network.train`` take the graph runner,
    and after the first (which gives each card's side stream what it
    keeps) each run leaves every card's allocated memory where it found
    it."""
    import gc
    mesh = _mesh(device, 2, 1, layout)
    cards = sorted({row[0].index for row in mesh.devices})
    held = []
    for _ in range(3):
        net, lik = _resume_net(device)
        res = net.train(12, 2, lik, n_chains=8, chain_jitter=0.05,
                        mesh=mesh, verbose=False)
        assert res.chunk_runner == "graph"
        del net, res
        gc.collect()
        torch.cuda.synchronize()
        held.append([torch.cuda.memory_allocated(i) for i in cards])
    assert held[1] == held[0] and held[2] == held[0], held


# -- the stepped runner (parallel/graphs.py::SteppedChunkRunner): K3 and
# the plain main block as a head, a step and a tail graph ------------------

def _stepped_cell(device, cell, n_data=1):
    """The runner pieces of a stepped cell: ``(model, lik, flat, x, y, c,
    hyper_steps, tempering_beta, main_vg, hyper, chunks)``, ``chunks`` two
    chunks' ``(eps, L, n_epochs)`` whose (eps, L) and lengths differ:
    ``wide_deep`` (K3, K2's coupled block) at 64 chains, or a tempered
    flagship (the plain main block, K2) at 4 rungs x 16 chains with
    per-rung counts. For a data axis ``n_data`` above 1, K3 is built for
    a peer's rows and the tempered flagship takes 12 rows (its 11 divide
    no data axis)."""
    from tensorbnn_tpu_torch.sampler.tempering import make_ladder
    tempering_beta = None
    if cell == "wide_deep":
        rng = np.random.default_rng(0)
        layers = []
        for _ in range(9):
            layers += [GaussianDenseLayer(256, 256), Tanh()]
        model = Sequential(layers + [GaussianDenseLayer(256, 1)])
        lik = GaussianLikelihood(sd=0.1)
        x = rng.normal(size=(128, 256))
        y = rng.normal(size=(128, 1))
        c, hyper_steps = 64, 5
        chunks = ((1e-5, 20, 3), (1e-5, 25, 2))
    else:
        lik = FixedGaussianLikelihood(sd=0.1)
        model = _flagship(lik)[0]
        x = np.linspace(-2, 2, 11 if n_data == 1 else 12)[:, None]
        y = np.sin(x[:, 0] * np.pi * 2) * x[:, 0] - np.cos(x[:, 0] * np.pi)
        c, hyper_steps = 64, 30
        tempering_beta = (4, np.repeat(make_ladder(4, 0.5), c // 4))
        groups = np.asarray(((2e-3, 20), (1e-3, 30), (3e-3, 13), (5e-4, 40)))
        a = np.repeat(groups, c // 4, axis=0)
        chunks = tuple((g[:, 0].astype(np.float32), g[:, 1].astype(np.int64),
                        n) for g, n in ((a, 3), (a[::-1].copy(), 2)))
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = flatten_state(params, hypers, lik.init_hypers())
    x = torch.tensor(x, dtype=torch.float32, device=device)
    y = torch.tensor(y, dtype=torch.float32, device=device)
    h = flat.eta.numel()
    main_vg = None
    if tempering_beta is None:
        main_vg = fused_mlp.try_build_fused_main_vg(
            model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h,
            n_rows=x.shape[0] // n_data)
        assert main_vg is not None
    hyper = fused_hyper.try_build_fused_hyper_trajectory(
        model, lik, flat.unravel_eta, h, hyper_steps)
    assert hyper is not None
    return (model, lik, flat, x, y, c, hyper_steps, tempering_beta, main_vg,
            hyper, chunks)


def _stepped_runner(pieces, eager, main_vg=None, mesh=None):
    from tensorbnn_tpu_torch.parallel.chains import \
        make_multichain_chunk_runner
    model, lik, flat, x, y, c, hyper_steps, tempering_beta, vg, hyper, _ = \
        pieces
    return make_multichain_chunk_runner(
        model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
        adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
        hyper_step_size_init=1e-4, eta_dim=flat.eta.numel(),
        batched_main_vg=vg if main_vg is None else main_vg,
        batched_hyper_traj=hyper, tempering_beta=tempering_beta,
        eager=eager, mesh=mesh, n_chains=c)


STEPPED_CELLS = ["wide_deep", "tempered_plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", STEPPED_CELLS)
def test_stepped_runner_matches_eager_runner_on_the_card(device, cell):
    """Two chunks whose (eps, L) and lengths differ through the stepped
    runner and the eager runner from one carry and one generator seed: the
    carry, every trace and the generator's state bit for bit, the kernels'
    launch counters equal (K3 L + 1 an epoch, K2 one); three captures
    (head, step, tail) serve both chunks after one warm-up epoch."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    pieces = _stepped_cell(device, cell)
    flat, c, chunks = pieces[2], pieces[5], pieces[10]
    carry0 = init_multichain_state(
        flat.theta.to(device), flat.eta.to(device), 1e-4, c,
        torch.Generator(device=device).manual_seed(2), jitter=0.01)
    out = {}
    for eager in (True, False):
        run = _stepped_runner(pieces, eager)
        assert run.runner == ("eager" if eager else "stepped")
        graphs.COUNTS.reset()
        gen = torch.Generator(device=device).manual_seed(5)
        before = [fn.LAUNCHES for fn in graphs.COUNTED]
        carry, got = carry0, []
        for eps, leap, n in chunks:
            carry, trace = run(carry, eps, leap, n, gen)
            got.append((carry, trace))
        torch.cuda.synchronize()
        out[eager] = (got, gen.get_state(),
                      [fn.LAUNCHES - b for fn, b in
                       zip(graphs.COUNTED, before)],
                      graphs.COUNTS.as_dict())
    for (cg, tg), (ce, te) in zip(out[False][0], out[True][0]):
        _same_bits(cg, ce, "carry")
        _same_bits(tg, te, "trace")
    assert torch.equal(out[False][1], out[True][1])
    assert out[False][2] == out[True][2] and out[True][2][1] > 0
    counts = out[False][3]
    assert (counts["captures"], counts["warmups"]) == (3, 1), counts
    assert out[True][3]["captures"] == 0


@pytest.mark.cuda
def test_stepped_capture_failure_raises(device):
    """A main block that copies from pageable host memory cannot be
    captured: the stepped runner raises (it never carries on eagerly), and
    the kernels' launch counters and the capture count read as before."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    pieces = _stepped_cell(device, "wide_deep")
    vg = pieces[8]

    def copying_vg(thetas, *args, **kwargs):
        torch.as_tensor(np.zeros(4, np.float32), device=thetas.device)
        return vg(thetas, *args, **kwargs)

    copying_vg.workspace_bytes = vg.workspace_bytes
    run = _stepped_runner(pieces, False, main_vg=copying_vg)
    assert run.runner == "stepped"
    flat, c = pieces[2], pieces[5]
    carry = init_multichain_state(flat.theta.to(device), flat.eta.to(device),
                                  1e-4, c)
    before = [fn.LAUNCHES for fn in graphs.COUNTED]
    captures = graphs.COUNTS.captures
    eps, leap, n = pieces[10][0]
    with pytest.raises(RuntimeError, match="capture"):
        run(carry, eps, leap, n, torch.Generator(device=device))
    torch.cuda.synchronize()
    assert [fn.LAUNCHES for fn in graphs.COUNTED] == before
    assert graphs.COUNTS.captures == captures


@pytest.mark.cuda
def test_stepped_gate_declines_a_workspace_that_cannot_fit_twice(device):
    """K3 at 1M rows of an 8-64-64-1 model: 8 chains' workspace (8.2 GB)
    fits the card twice and takes the stepped runner; 64 chains' (65.8 GB)
    does not, and the factory builds the eager loop, decided from the
    configuration before any chunk runs."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import \
        make_multichain_chunk_runner
    model = Sequential([GaussianDenseLayer(8, 64), Tanh(),
                        GaussianDenseLayer(64, 64), Tanh(),
                        GaussianDenseLayer(64, 1)])
    lik = GaussianLikelihood(sd=0.1)
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = flatten_state(params, hypers, lik.init_hypers())
    x = torch.zeros(1_000_000, 8, device=device)
    y = torch.zeros(1_000_000, device=device)
    h = flat.eta.numel()
    vg = fused_mlp.try_build_fused_main_vg(
        model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h)
    memory = torch.cuda.get_device_properties(device).total_memory
    kinds = []
    for c in (8, 64):
        assert (2 * vg.workspace_bytes(c) <= memory) == (c == 8)
        kinds.append(make_multichain_chunk_runner(
            model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
            adjust_hypers=True, hyper_leapfrog=5, burnin=100.0,
            hyper_step_size_init=1e-6, eta_dim=h, batched_main_vg=vg,
            n_chains=c).runner)
    assert kinds == ["stepped", "eager"]
    assert graphs.stepped_fits(0, {device.index})


# -- K3 over row chunks (``try_build_fused_main_vg(..., data_chunk=)``) ----

def _chunked_k3_problem(device):
    """The surrogate's widths (8-64-64-1 tanh, a learned sd) over 4,096
    rows at 8 float32 states, as ``_chunked_main_vg`` draws them, on the
    card: ``(model, lik, flat, x, y, thetas, etas)``."""
    lik = GaussianLikelihood(sd=0.1)
    model = _dense_stack()
    params, hypers = model.init(torch.Generator().manual_seed(1))
    flat = flatten_state(params, hypers, lik.init_hypers())
    rng = np.random.default_rng(1)
    thetas = flat.theta + 0.01 * torch.tensor(
        rng.normal(size=(8, flat.theta.numel())), dtype=torch.float32)
    x = rng.normal(size=(4096, 8))
    y = np.sin(x.sum(axis=1)) + 0.1 * rng.normal(size=4096)
    return (model, lik, flat,
            torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(y, dtype=torch.float32, device=device),
            thetas.to(device), flat.eta.expand(8, -1).to(device))


@pytest.mark.cuda
def test_chunked_k3_matches_unchunked_k3_and_the_plain_path(device):
    """K3 over chunks of 512 rows (eight calls an evaluation, counted) at
    the surrogate's widths against the unchunked K3 call and the chunked
    plain path: relative 1e-5 on the values, 1e-5 of the largest entry on
    the gradients; a call's workspace is a chunk's."""
    from tensorbnn_tpu_torch.sampler.potential import make_potentials
    model, lik, flat, x, y, thetas, etas = _chunked_k3_problem(device)
    h = flat.eta.numel()
    chunked, whole = (fused_mlp.try_build_fused_main_vg(
        model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h,
        data_chunk=chunk) for chunk in (512, None))
    before = fused_mlp.fused_potential.LAUNCHES
    got = chunked(thetas, etas, x, y)
    torch.cuda.synchronize()
    assert fused_mlp.fused_potential.LAUNCHES - before == 8
    assert 8 * chunked.workspace_bytes(8) <= whole.workspace_bytes(8)
    plain = make_potentials(model, lik, x, y, flat.unravel_theta,
                            flat.unravel_eta, data_chunk=512)
    for want in (whole(thetas, etas, x, y), plain.main_vg(thetas, etas)):
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0,
                                   atol=1e-5 * float(want[1].abs().max()))


@pytest.mark.cuda
def test_stepped_runner_on_chunked_k3_matches_eager(device):
    """Two chunks through the stepped runner and the eager runner on K3
    over chunks of 512 rows (K2's coupled block) from one carry and one
    generator seed: the carry, every trace and the generator's state bit
    for bit, K3's launches equal (eight a main-block evaluation)."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state, \
        make_multichain_chunk_runner
    model, lik, flat, x, y, _, _ = _chunked_k3_problem(device)
    h = flat.eta.numel()
    vg = fused_mlp.try_build_fused_main_vg(
        model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h,
        data_chunk=512)
    hyper = fused_hyper.try_build_fused_hyper_trajectory(
        model, lik, flat.unravel_eta, h, 5)
    carry0 = init_multichain_state(
        flat.theta.to(device), flat.eta.to(device), 1e-4, 8,
        torch.Generator(device=device).manual_seed(2), jitter=0.01)
    out = {}
    for eager in (True, False):
        run = make_multichain_chunk_runner(
            model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
            adjust_hypers=True, hyper_leapfrog=5, burnin=100.0,
            hyper_step_size_init=1e-4, eta_dim=h, batched_main_vg=vg,
            batched_hyper_traj=hyper, data_chunk=512, eager=eager,
            n_chains=8)
        assert run.runner == ("eager" if eager else "stepped")
        graphs.COUNTS.reset()
        gen = torch.Generator(device=device).manual_seed(5)
        before = fused_mlp.fused_potential.LAUNCHES
        carry, got = carry0, []
        for eps, leap, n in ((1e-4, 10, 3), (5e-5, 15, 2)):
            carry, trace = run(carry, eps, leap, n, gen)
            got.append((carry, trace))
        torch.cuda.synchronize()
        out[eager] = (got, gen.get_state(),
                      fused_mlp.fused_potential.LAUNCHES - before,
                      graphs.COUNTS.as_dict())
    for (cg, tg), (ce, te) in zip(out[False][0], out[True][0]):
        _same_bits(cg, ce, "carry")
        _same_bits(tg, te, "trace")
    assert torch.equal(out[False][1], out[True][1])
    assert out[False][2] == out[True][2] == 8 * (3 * 11 + 2 * 16)
    counts = out[False][3]
    assert (counts["captures"], counts["warmups"]) == (3, 1), counts


# -- the stepped runner over data meshes: each part split at its sums over
# the data peers (parallel/graphs.py::SegmentedPart) ------------------------

#: the data-mesh cells: (cell, mesh shape), and the sums over the data
#: peers an epoch's head, step and tail reach (the main block's evaluation
#: in the head and in each step; the stats' (R, K) of wide_deep's coupled
#: K2 block, the tempered swap's log-likelihood)
DATA_MESH_CELLS = [("wide_deep", (2, 2)), ("wide_deep", (1, 4)),
                   ("tempered_plain", (1, 2))]
DATA_MESH_SUMS = 3


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
@pytest.mark.parametrize("cell,shape", DATA_MESH_CELLS)
def test_data_mesh_stepped_runner_matches_eager_mesh_runner_on_the_card(
        device, cell, shape, layout):
    """Two chunks whose (eps, L) and lengths differ through the stepped
    runner and the eager mesh runner over a data mesh, from one carry and
    one generator seed: the carry, every trace and the generator's state
    bit for bit, the kernels' launch counters equal; three parts a chain
    shard, each split at its sums (a home segment and a graph a peer a
    sum), captured once after one warm-up epoch a shard."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    mesh = _mesh(device, *shape, layout)
    pieces = _stepped_cell(device, cell, n_data=shape[1])
    flat, c, chunks = pieces[2], pieces[5], pieces[10]
    carry0 = init_multichain_state(
        flat.theta.to(device), flat.eta.to(device), 1e-4, c,
        torch.Generator(device=device).manual_seed(2), jitter=0.01)
    out = {}
    for eager in (True, False):
        run = _stepped_runner(pieces, eager, mesh=mesh)
        assert run.runner == ("eager" if eager else "stepped")
        graphs.COUNTS.reset()
        gen = torch.Generator(device=device).manual_seed(5)
        before = [fn.LAUNCHES for fn in graphs.COUNTED]
        carry, got = carry0, []
        for eps, leap, n in chunks:
            carry, trace = run(carry, eps, leap, n, gen)
            got.append((carry, trace))
        torch.cuda.synchronize()
        out[eager] = (got, gen.get_state(),
                      [fn.LAUNCHES - b for fn, b in
                       zip(graphs.COUNTED, before)],
                      graphs.COUNTS.as_dict())
    for (cg, tg), (ce, te) in zip(out[False][0], out[True][0]):
        _same_bits(cg, ce, "carry")
        _same_bits(tg, te, "trace")
    assert torch.equal(out[False][1], out[True][1])
    assert out[False][2] == out[True][2] and out[True][2][1] > 0
    counts = out[False][3]
    k, n_data = shape
    assert counts["warmups"] == k, counts
    assert counts["captures"] == k * (3 + DATA_MESH_SUMS * (n_data + 1)), \
        counts


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_data_mesh_peer_capture_failure_raises(device, layout):
    """A likelihood that copies from pageable host memory cannot be
    captured in a peer's graph: the stepped runner over a 1x2 mesh raises
    (it never carries on eagerly), and the capture count and the peers'
    sum read as before (eager again)."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state, \
        make_multichain_chunk_runner

    class CopyingLikelihood(FixedGaussianLikelihood):
        def log_likelihood(self, preds, y, hypers):
            torch.as_tensor(np.zeros(4, np.float32), device=preds.device)
            return super().log_likelihood(preds, y, hypers)

    lik = CopyingLikelihood(sd=0.1)
    model, flat = _flagship(lik)
    x = torch.linspace(-2, 2, 12, device=device)[:, None]
    y = torch.sin(x[:, 0])
    run = make_multichain_chunk_runner(
        model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
        adjust_hypers=True, hyper_leapfrog=5, burnin=100.0,
        hyper_step_size_init=1e-3, eta_dim=flat.eta.numel(),
        mesh=_mesh(device, 1, 2, layout), n_chains=8)
    assert run.runner == "stepped"
    carry = init_multichain_state(flat.theta.to(device), flat.eta.to(device),
                                  1e-3, 8)
    captures = graphs.COUNTS.captures
    with pytest.raises(RuntimeError, match="capture"):
        run(carry, 1e-3, 5, 2, torch.Generator(device=device))
    torch.cuda.synchronize()
    assert graphs.COUNTS.captures == captures
    assert all(p is None or p.mode is None for p in run.peers)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MESH_LAYOUTS)
def test_data_mesh_runs_leave_no_memory_behind(device, layout):
    """Runs of a K3 model on a 1x2 mesh through ``Network.train`` take the
    stepped runner, and after the first (which gives each card's side
    stream what it keeps) each run leaves every card's allocated memory
    where it found it."""
    import gc
    from tensorbnn_tpu_torch import Network
    mesh = _mesh(device, 1, 2, layout)
    cards = sorted({d.index for row in mesh.devices for d in row})
    x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    held = []
    for _ in range(3):
        net = Network(torch.float32, 4, x, x[:, 0], x, x[:, 0], seed=0,
                      device=device)
        net.add(GaussianDenseLayer(4, 256)).add(Tanh())
        net.add(GaussianDenseLayer(256, 256)).add(Tanh())
        net.add(GaussianDenseLayer(256, 1))
        net.setup_mcmc(leapfrog_start=5, leapfrog_min=5, leapfrog_max=5,
                       hyper_leapfrog=5, step_size_start=1e-4)
        res = net.train(6, 1, GaussianLikelihood(sd=0.1), n_chains=4,
                        mesh=mesh, verbose=False)
        assert res.main_path == "K3" and res.chunk_runner == "stepped"
        del net, res
        gc.collect()
        torch.cuda.synchronize()
        held.append([torch.cuda.memory_allocated(i) for i in cards])
    assert held[1] == held[0] and held[2] == held[0], held


@pytest.mark.cuda
def test_data_mesh_gate_declines_a_workspace_that_cannot_fit_twice(device):
    """K3 at 1M rows of an 8-64-64-1 model over a 1x2 mesh of this card:
    a peer's 500,000 rows at 64 chains (32.9 GB of workspace) fit the card
    twice and take the stepped runner; 128 chains (65.8 GB) do not, and
    the factory builds the eager loop, decided from the configuration."""
    from tensorbnn_tpu_torch.parallel.chains import \
        make_multichain_chunk_runner
    model = Sequential([GaussianDenseLayer(8, 64), Tanh(),
                        GaussianDenseLayer(64, 64), Tanh(),
                        GaussianDenseLayer(64, 1)])
    lik = GaussianLikelihood(sd=0.1)
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = flatten_state(params, hypers, lik.init_hypers())
    x = torch.zeros(1_000_000, 8, device=device)
    y = torch.zeros(1_000_000, device=device)
    h = flat.eta.numel()
    vg = fused_mlp.try_build_fused_main_vg(
        model, lik, flat.unravel_theta, flat.unravel_eta, x[:500_000],
        y[:500_000], h, n_rows=500_000)
    memory = torch.cuda.get_device_properties(device).total_memory
    kinds = []
    for c in (64, 128):
        assert (2 * vg.workspace_bytes(c) <= memory) == (c == 64)
        kinds.append(make_multichain_chunk_runner(
            model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
            adjust_hypers=True, hyper_leapfrog=5, burnin=100.0,
            hyper_step_size_init=1e-6, eta_dim=h, batched_main_vg=vg,
            mesh=_mesh(device, 1, 2, "repeated"), n_chains=c).runner)
    assert kinds == ["stepped", "eager"]


# MAP pretraining: an epoch a replay of one captured graph ----------------

def _pretrain_case(case):
    """``_train_mlp``'s positional and keyword arguments: a regression
    whose validation curve is the training curve mirrored (its loss
    rises, so patience 2 stops both cycles early), or a classification
    with trained slopes."""
    rng = np.random.default_rng(4)
    if case == "regression":
        x = np.linspace(-2, 2, 256)
        y = np.sin(np.pi * x) * x
        return ((2, 1, 1, 16, 2, 12, 0.1, x, y, x, -y),
                dict(classification=False, base_lr=0.01, patience=2,
                     batch_size=16))
    x = rng.normal(size=(320, 4)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] + x[:, 2] > 0).astype(np.float32)
    return ((2, 4, 1, 12, 2, 5, 0.1, x[:256], y[:256], x[256:], y[256:]),
            dict(classification=True, base_lr=0.001, train_slopes=True,
                 batch_size=32))


def _host_launches_per_epoch(run) -> float:
    """The host's calls that put work on the card (kernel and graph
    launches, copies and fills) an epoch, from ``torch.profiler`` over
    epochs 2 and 3 of ``run(epoch_hook)``, a 4-epoch call: after the
    graph path's warm-up epoch and capture, which are not profiled."""
    names = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    seen = []

    def hook(val):
        seen.append(val)
        if len(seen) in (2, 4):
            torch.cuda.synchronize()
            (prof.start if len(seen) == 2 else prof.stop)()

    run(hook)
    assert len(seen) == 4
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and any(k in e.name for k in names)) / 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["regression", "classification_slopes"])
def test_pretraining_graph_matches_eager_on_the_card(device, case):
    """Two cycles through the graph path (every optimizer step after the
    first epoch a replay of one captured graph of a step) and the eager
    path: every returned array bit for bit, every epoch's validation loss
    and the epochs run (the regression stops both cycles early); one
    capture a call, a replay a step; the graph path's host launches an
    epoch at most its steps and 40 (the eager path's over 5 times as
    many)."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.training.pretrain import _train_mlp
    args, kw = _pretrain_case(case)
    out = {}
    for eager in (True, False):
        graphs.COUNTS.reset()
        vals = []
        res = _train_mlp(*args, seed=1, device=device, eager=eager,
                         epoch_hook=vals.append, **kw)
        out[eager] = (res, vals, graphs.COUNTS.as_dict())
    (g_res, g_vals, g_counts), (e_res, e_vals, e_counts) = (out[False],
                                                            out[True])
    assert g_vals == e_vals and all(np.isfinite(g_vals))
    if case == "regression":
        assert len(g_vals) < 2 * args[5], len(g_vals)   # stopped early
    for g_part, e_part in zip(g_res, e_res):
        for g, e in zip(g_part, e_part):
            np.testing.assert_array_equal(
                np.asarray(g, np.float32).view(np.uint32),
                np.asarray(e, np.float32).view(np.uint32))
    n_batches = len(args[7]) // kw["batch_size"]
    assert (g_counts["warmups"], g_counts["captures"],
            g_counts["replays"]) == (1, 1, (len(g_vals) - 1) * n_batches), \
        g_counts
    assert e_counts["captures"] == 0
    one = dict(kw, patience=100)

    def run(eager):
        return lambda hook: _train_mlp(*args[:4], 1, 4, *args[6:], seed=1,
                                       device=device, eager=eager,
                                       epoch_hook=hook, **one)

    graph_launches = _host_launches_per_epoch(run(False))
    eager_launches = _host_launches_per_epoch(run(True))
    assert graph_launches <= n_batches + 40, graph_launches
    assert eager_launches > 5 * graph_launches, (eager_launches,
                                                 graph_launches)
