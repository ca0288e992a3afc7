"""K2's item table (``HyperProgram.items``, ``lanes``, ``table``), which
``csrc/fused_hyper.cu`` checks and runs, at the K2 models of
``chip_smoke.py``; and a torch emulation of the kernel's schedule (each
item's trajectory on its own, the gradient alone between the ends, the
value gathered at i = 0 and i = n in the table's order) against the twin
and against the Pallas K2 in interpret mode.

The table is pure Python: one row per (loc, scale) pair of a dense block's
weights or biases, then the coupled term, covering each eta row and each
stats column once. The kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import tensorbnn_tpu as J
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.ops.fused_hyper import \
    try_build_fused_hyper_trajectory as j_hyper_build
from tensorbnn_tpu.sampler.hyper_stats import make_stats_hyper as j_stats
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten
import tensorbnn_tpu_torch as T
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops import fused_hyper
from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper
from tensorbnn_tpu_torch.sampler.potential import flatten_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: chip_smoke.py's K2 models, with their items and lanes a chain
MODELS = {
    "flagship": (lambda: cs.flagship_network(CPU), 8, 8),
    "learned_sd": (lambda: cs.flagship_network(CPU, learned_sd=True), 9,
                   16),
    "wide_deep": (lambda: cs.wide_network(CPU), 21, 32),
    "multiclass": (lambda: cs.multiclass_network(CPU), 4, 4),
    "stack16": (lambda: cs.stack_network(CPU, 16), 32, 32),
    "stack15_learned_sd": (
        lambda: cs.stack_network(CPU, 15, learned_sd=True), 31, 32),
}


def _program(name, n_steps=7):
    net, lik = MODELS[name][0]()
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=CPU))
    program = fused_hyper.build_hyper_program(
        net.model, lik, flat.unravel_eta, flat.eta.numel(), n_steps)
    assert program is not None, f"K2 declined {name}"
    return program, net, lik, flat


def _entry_point_accepts(program):
    """The C entry point's checks of the table (``tbnn_fused_hyper``)."""
    items, h, s = program.items, program.eta_dim, program.n_stats
    n = len(items)
    if not 1 <= n <= 32 or program.lanes < n or program.lanes > 32:
        return False
    if program.lanes & (program.lanes - 1) or (program.lanes > 1
                                               and program.lanes // 2 >= n):
        return False
    if program.threads % 32 or not 32 <= program.threads <= 1024:
        return False
    rows, cols = [], []
    for m, (row_a, row_b, col_a, col_b, k) in enumerate(items):
        pair = row_b >= 0
        if not pair and (not program.coupled or m != n - 1 or row_b != -1
                         or k != 0):
            return False
        if col_b != col_a + 1 or (pair and k < 0):
            return False
        rows += [row_a, row_b] if pair else [row_a]
        cols += [col_a, col_b]
    if program.coupled and items[-1][1] != -1:
        return False
    return sorted(rows) == list(range(h)) and sorted(cols) == list(range(s))


@pytest.mark.parametrize("name", list(MODELS))
def test_k2_item_table(name):
    """Per dense block its weights' and then its biases' (loc_row,
    scale_row, S1's column, S2's column, k), then the coupled term (sd_idx,
    -1, R's column, K's column, 0): each eta row and each stats column
    once, in the value's order; lanes the least power of two at or above
    the items; the host table the rows flattened as int32; the entry
    point's checks pass."""
    program, net, lik, flat = _program(name)
    _, n_items, lanes = MODELS[name]
    items = program.items
    assert len(items) == n_items and program.lanes == lanes
    assert program.table.dtype == np.int32
    assert program.table.tolist() == [v for row in items for v in row]
    dense = [layer for layer in net.model.layers
             if isinstance(layer, T.GaussianDenseLayer)]
    assert len(program.blocks) == len(dense)
    for j, (wl, ws, bl, bs, k_w, k_b) in enumerate(program.blocks):
        assert items[2 * j] == (wl, ws, 4 * j, 4 * j + 1, k_w)
        assert items[2 * j + 1] == (bl, bs, 4 * j + 2, 4 * j + 3, k_b)
        assert (k_w, k_b) == (dense[j].in_dim * dense[j].out_dim,
                              dense[j].out_dim)
    assert program.coupled == isinstance(lik, T.GaussianLikelihood)
    if program.coupled:
        n = 4 * len(program.blocks)
        assert items[-1] == (program.sd_idx, -1, n, n + 1, 0)
        assert program.sd_idx == flat.eta.numel() - 1
    rows = [r for it in items for r in it[:2] if r >= 0]
    assert sorted(rows) == list(range(flat.eta.numel()))
    assert _entry_point_accepts(program)
    assert program.threads % program.lanes == 0


def _lik(kind):
    return {"fixed": T.FixedGaussianLikelihood(sd=0.1),
            "learned": T.GaussianLikelihood(sd=0.2),
            "bernoulli": T.BernoulliLikelihood(),
            "categorical": T.CategoricalLikelihood()}[kind]


@pytest.mark.parametrize("lik", ["fixed", "learned", "bernoulli",
                                 "categorical"])
def test_k2_table_refuses_nothing_build_accepts(lik):
    """Every stack ``build_hyper_program`` accepts, 1 to 16 dense blocks of
    random widths under each in-scope likelihood, gets a table the entry
    point accepts; the stacks it refuses are those past 64 hypers."""
    rng = np.random.default_rng(4)
    for n_blocks in range(1, 17):
        widths = rng.integers(1, 6, size=n_blocks + 1).tolist()
        widths[-1] = 3 if lik == "categorical" else 1
        layers = []
        for i in range(n_blocks):
            layers.append(T.GaussianDenseLayer(widths[i], widths[i + 1]))
            if i < n_blocks - 1:
                layers.append(T.Tanh())
        model = TSequential(layers)
        likelihood = _lik(lik)
        params, hypers = model.init(torch.Generator().manual_seed(n_blocks))
        flat = flatten_state(params, hypers, likelihood.init_hypers())
        program = fused_hyper.build_hyper_program(
            model, likelihood, flat.unravel_eta, flat.eta.numel(), 5)
        if flat.eta.numel() > fused_hyper.MAX_H:
            assert program is None
            continue
        assert program is not None
        assert _entry_point_accepts(program), (lik, n_blocks)


def emulate(program, etas, stats, momenta, eps_c):
    """K2's schedule in torch: each item's trajectory on its own, the
    gradient alone between the ends, and at i = 0 and i = n each item's
    value terms added in the table's order (per pair the hyperprior term,
    then the conditional prior's; the coupled term last). Each term is the
    twin's float operations on the item's columns."""
    n = program.n_steps
    hyper_const = -2.0 * (math.log(0.1) + 0.5 * fused_hyper.LOG_2PI)
    q, v = etas.clone(), momenta.clone()
    lp0 = lp1 = None
    for i in range(n + 1):
        end = i in (0, n)
        lp = torch.zeros(etas.shape[0]) if end else None
        for row_a, row_b, col_a, col_b, k in program.items:
            if row_b >= 0:     # a (loc, scale) pair
                loc, s = q[:, row_a], q[:, row_b]
                s1, s2, k = stats[:, col_a], stats[:, col_b], float(k)
                u = s * s
                g_loc = torch.zeros_like(loc) + -loc / 0.01
                g_scale = (-(u - 1.0) / 0.01) * (2.0 * s)
                in_range = (u >= fused_hyper.SD_LO) & (u <= fused_hyper.SD_HI)
                sd = u.clamp(fused_hyper.SD_LO, fused_hyper.SD_HI)
                quad_num = s2 - 2.0 * loc * s1 + k * loc * loc
                inv_sd2 = 1.0 / (sd * sd)
                g_loc = g_loc + (s1 - k * loc) * inv_sd2
                d_sd = -1.0 / sd + quad_num * inv_sd2 / sd
                g_scale = g_scale + torch.where(in_range, d_sd * 2.0 * s,
                                                0.0)
                grads = ((row_a, g_loc),
                         (row_b, torch.zeros_like(s) + g_scale))
                if end:
                    z_loc, z_u = loc / 0.1, (u - 1.0) / 0.1
                    lp = lp + (-0.5 * (z_loc * z_loc + z_u * z_u)
                               + hyper_const)
                    lp = lp - 0.5 * (2.0 * torch.log(sd) + quad_num * inv_sd2
                                     + fused_hyper.LOG_2PI)
            else:              # the coupled (R, K) term
                e = q[:, row_a]
                r, k = stats[:, col_a], stats[:, col_b]
                u = e * e
                in_range = (u >= fused_hyper.SD_LO) & (u <= fused_hyper.SD_HI)
                sd = u.clamp(fused_hyper.SD_LO, fused_hyper.SD_HI)
                inv_sd2 = 1.0 / (sd * sd)
                d_sd = -k / sd + r * inv_sd2 / sd
                grads = ((row_a, torch.zeros_like(e)
                          + torch.where(in_range, d_sd * 2.0 * e, 0.0)),)
                if end:
                    lp = lp - 0.5 * (2.0 * k * torch.log(sd) + r * inv_sd2
                                     + k * fused_hyper.LOG_2PI)
            kick = 0.5 * eps_c if end else eps_c
            for row, g in grads:
                v[:, row] = v[:, row] + kick * g
                if i < n:
                    q[:, row] = q[:, row] + eps_c * v[:, row]
        if i == 0:
            lp0 = lp
        if end:
            lp1 = lp
    return q, v, lp0, lp1


def _inputs(program, net, lik, flat, c, seed):
    rng = np.random.default_rng(seed)
    h, d = flat.eta.numel(), flat.theta.numel()
    stats_fn, _, _ = make_stats_hyper(net.model, lik, net.train_x,
                                      net.train_y, flat.unravel_theta,
                                      flat.unravel_eta, h)
    thetas = flat.theta + torch.tensor(0.1 * rng.normal(size=(c, d)),
                                       dtype=torch.float32)
    etas = flat.eta + torch.tensor(0.05 * rng.normal(size=(c, h)),
                                   dtype=torch.float32)
    momenta = torch.tensor(rng.normal(size=(c, h)), dtype=torch.float32)
    eps = torch.tensor(1e-3 * (1.0 + rng.random(c)), dtype=torch.float32)
    return etas, stats_fn(thetas), momenta, eps


@pytest.mark.parametrize("n_steps", [0, 1, 7])
@pytest.mark.parametrize("name", list(MODELS))
def test_k2_emulation_matches_twin(name, n_steps):
    """The emulated schedule's q and v equal the twin's bit for bit in
    float32 (each item's operations are the twin's on the item's columns);
    its lp0 and lp1, added in the kernel's order, are within K2_TOL of the
    twin's."""
    program, net, lik, flat = _program(name, n_steps)
    args = _inputs(program, net, lik, flat, c=5, seed=n_steps)
    got = emulate(program, *args)
    want = fused_hyper.hyper_trajectory_plain(program, *args)
    for label, g, w in zip(("q", "v"), got[:2], want[:2]):
        assert torch.equal(g, w), (label, (g - w).abs().max())
    for g, w, (rtol, atol) in zip(got[2:], want[2:], cs.K2_TOL[2:]):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("lik", [("FixedGaussianLikelihood", 0.1),
                                 ("GaussianLikelihood", 0.2)])
def test_k2_emulation_matches_pallas(lik):
    """The emulated schedule against the JAX package's K2 in interpret mode
    on the same inputs, with the tolerances of tests/test_fused_hyper.py
    (as tests/test_torch_kernels.py holds the twin)."""
    c, n_steps = 4, 7
    widths = [(2, 5), (5, 3), (3, 1)]
    j_layers, t_layers = [], []
    for i, (a, b) in enumerate(widths):
        j_layers.append(J.GaussianDenseLayer(a, b))
        t_layers.append(T.GaussianDenseLayer(a, b))
        if i < len(widths) - 1:
            j_layers.append(J.Tanh())
            t_layers.append(T.Tanh())
    name, sd = lik
    j_model, j_lik = JSequential(j_layers), getattr(J, name)(sd=sd)
    t_model, t_lik = TSequential(t_layers), getattr(T, name)(sd=sd)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(9, 2)).astype(np.float32)
    y = rng.normal(size=(9,)).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(8))
    lik_h = j_lik.init_hypers()
    j_flat = j_flatten(params, hypers, lik_h)
    t_flat = flatten_state(*convert.from_jax(params, hypers, lik_h))
    h = j_flat.eta.size
    thetas = (0.3 * rng.normal(size=(c, j_flat.theta.size))).astype(
        np.float32)
    etas = (np.asarray(j_flat.eta)[None]
            + 0.05 * rng.normal(size=(c, h))).astype(np.float32)
    j_stats_fn, _, _ = j_stats(j_model, j_lik, jnp.asarray(x),
                               jnp.asarray(y), j_flat.unravel_eta, h)
    stats = np.asarray(j_stats_fn(jax.vmap(j_flat.unravel_theta)(thetas)))
    momenta = rng.normal(size=(c, h)).astype(np.float32)
    eps = (0.01 + 0.01 * rng.random(c)).astype(np.float32)

    j_traj = j_hyper_build(j_model, j_lik, j_flat.unravel_eta, h,
                           n_steps=n_steps, block_c=c, interpret=True)
    program = fused_hyper.build_hyper_program(
        t_model, t_lik, t_flat.unravel_eta, t_flat.eta.numel(), n_steps)
    assert j_traj is not None and program is not None
    assert program.coupled == (name == "GaussianLikelihood")
    jq, jv, jlp0, jlp1 = j_traj(etas, stats, momenta, eps)
    tq, tv, tlp0, tlp1 = emulate(program, torch.tensor(etas),
                                 torch.tensor(stats), torch.tensor(momenta),
                                 torch.tensor(eps))
    for got, want, (rtol, atol) in (
            (tlp0, jlp0, (1e-4, 1e-3)), (tq, jq, (1e-4, 1e-5)),
            (tv, jv, (1e-4, 1e-4)), (tlp1, jlp1, (1e-4, 1e-3))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol)
