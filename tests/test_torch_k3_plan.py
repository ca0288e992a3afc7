"""K3's launch plan (``PotentialProgram.plan``) at the shapes the port
runs, and K3's twin in float64 against the JAX package's ``make_potentials``
under the Bernoulli likelihood at a He-init start.

The plan is pure Python: the packed first layer, the slices of rows of each
split row sum and the workspace the C entry point checks. The kernels
themselves run only on a card (tests/test_torch_cuda.py).
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
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops import fused_mlp

TUTORIAL = (("dense", 784, 20), ("sqprelu", 20), ("dense", 20, 20),
            ("sqprelu", 20), ("dense", 20, 1), ("sigmoid", 1))
WIDE = (("dense", 256, 256), ("tanh", 256)) * 9 + (("dense", 256, 1),)
FLAGSHIP = (("dense", 1, 10), ("tanh", 10), ("dense", 10, 10), ("tanh", 10),
            ("dense", 10, 10), ("tanh", 10), ("dense", 10, 1))
RAGGED = (("dense", 3, 37), ("relu", 37), ("dense", 37, 70), ("elu", 70),
          ("dense", 70, 1))
DIGITS = (("dense", 64, 20), ("tanh", 20), ("dense", 20, 10))
SPLIT = (("dense", 50, 7), ("sqprelu", 7), ("dense", 7, 3), ("dense", 3, 1),
         ("sigmoid", 1))


@pytest.mark.parametrize("ops,n,c,lik,split", [
    # the deep weight gradients and both slope passes split; the packed
    # first layer's 260 blocks are more than half of the 396 the card
    # holds at once, so it stays unsplit
    (TUTORIAL, 9585, 64, "bernoulli", {(1, "wg"), (2, "wg"), (0, "slope"),
                                       (1, "slope")}),
    (WIDE, 128, 64, "gaussian", set()),
    (FLAGSHIP, 11, 64, "gaussian", set()),
    (RAGGED, 13, 5, "gaussian", set()),
    (DIGITS, 1437, 64, "categorical", {(0, "wg"), (1, "wg")}),
    (SPLIT, 3001, 3, "bernoulli", {(0, "wg"), (1, "wg"), (2, "wg"),
                                   (0, "slope")}),
], ids=["tutorial", "wide_deep", "flagship", "ragged", "digits", "split"])
def test_k3_plan(ops, n, c, lik, split):
    program = fused_mlp.make_fused_potential_vg(ops, n, lik).args[0]
    plan = program.plan(c)
    assert plan is program.plan(c)
    assert len(plan.layers) == len(program.layers)
    assert plan.table.dtype == np.int32
    assert plan.table.tolist() == [v for row in plan.layers for v in row]
    got, partials = set(), 0
    for i, ((packed, wg, wg_rows, sp, sp_rows),
            (d_in, d_out, _, _, slope_off, _)) in enumerate(
                zip(plan.layers, program.layers)):
        assert packed == (i == 0)
        if slope_off < 0:
            assert sp == 1
        for kind, slices, per, width in (
                ("wg", wg, wg_rows, d_out + d_in * d_out),
                ("slope", sp, sp_rows, d_out)):
            ranges = [range(i * per, min(n, (i + 1) * per))
                      for i in range(slices)]
            # contiguous, ordered, non-empty slices that cover [0, N)
            assert ranges[0].start == 0 and ranges[-1].stop == n
            assert all(r.stop == s.start for r, s in zip(ranges, ranges[1:]))
            assert all(len(r) > 0 for r in ranges)
            if slices > 1:
                got.add((i, kind))
                assert per % fused_mlp.TILE_K == 0
                assert per >= fused_mlp.MIN_SLICE_ROWS
                partials = max(partials, slices * c * width)
    assert got == split
    assert plan.partial_floats == partials
    widths = [row[1] for row in program.layers]
    pre = [row[1] for row in program.layers if row[4] >= 0]
    planes = c * n * (sum(widths) + sum(pre) + 2 * max(widths))
    assert program.workspace_floats(c) == planes + partials


def test_k3_twin_float64_matches_make_potentials_bernoulli():
    """``potential_plain`` in float64 against the Bernoulli likelihood's
    value and gradient through the JAX package's ``make_potentials``,
    also in float64, at a narrow tutorial-like stack (30-6-6-1, SquarePrelu,
    sigmoid) from the layers' He-init state, 3 chains jittered by 0.01.
    Both sides run in float64, so they agree to summation order: rtol and
    atol 1e-10."""
    specs = [("GaussianDenseLayer", (30, 6)), ("SquarePrelu", (6,)),
             ("GaussianDenseLayer", (6, 6)), ("SquarePrelu", (6,)),
             ("GaussianDenseLayer", (6, 1)), ("Sigmoid", ())]
    j_model = JSequential([getattr(J, name)(*a) for name, a in specs])
    t_model = TSequential([getattr(T, name)(*a) for name, a in specs])
    j_lik = J.BernoulliLikelihood()
    rng = np.random.default_rng(7)
    n, c = 257, 3
    x = rng.normal(size=(n, 30))
    y = (rng.random(n) > 0.5).astype(np.float64)
    params, hypers = j_model.init(jax.random.key(0))
    j_flat = j_flatten(params, hypers, j_lik.init_hypers())
    thetas = (np.asarray(j_flat.theta, np.float64)[None]
              + 0.01 * rng.normal(size=(c, j_flat.theta.size)))
    etas = np.tile(np.asarray(j_flat.eta, np.float64)[None], (c, 1))
    ops, lik = fused_mlp._model_program(t_model, T.BernoulliLikelihood())
    assert lik == "bernoulli" and ops[1][0] == "sqprelu"
    tl, tg = fused_mlp.potential_plain(
        ops, torch.tensor(thetas), torch.ones(c, dtype=torch.float64),
        torch.tensor(x), torch.tensor(y), lik)
    assert tl.dtype == torch.float64
    with jax.enable_x64(True):
        jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                          j_flat.unravel_theta, j_flat.unravel_eta)
        jl, jg = jax.vmap(jax.value_and_grad(jp.loglik))(
            jnp.asarray(thetas), jnp.asarray(etas))
        jl, jg = np.asarray(jl), np.asarray(jg)
    assert jl.dtype == np.float64
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-10, atol=1e-10)
