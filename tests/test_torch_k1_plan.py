"""K1's layer table (``TrajectoryProgram.layers``, built by
``fused_mlp._layer_table``), which ``csrc/fused_trajectory.cu`` checks and
runs, at the models of ``chip_smoke.py``; K3's table from the same function;
and K1's twin against the Pallas K1 at a stack through every path of the
table.

The table is pure Python: each activation fused into the dense layer before
it, an op that does not follow a dense layer a row of its own (``d_in``
0), theta rows covered in order. The kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import tensorbnn_tpu as J
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.ops.fused_mlp import try_build_fused_trajectory as \
    j_traj_build
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.ops import fused_mlp
from tensorbnn_tpu_torch.sampler.potential import flatten_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: chip_smoke.py's K1 models, and the barriers of one leapfrog step that
#: computes no value (0 < i < L) under the table, without and with U-turn
#: recording; the first design ran one barrier per op each way, one for
#: the tail, three for the value's reduction and one for the update (19
#: for the flagship, 21 recording)
MODELS = {
    "flagship": (lambda: cs.flagship_network(CPU), 8, 8),
    "learned_sd": (lambda: cs.flagship_network(CPU, learned_sd=True), 8, 8),
    "cauchy": (lambda: cs.flagship_network(CPU, cauchy=True), 8, 8),
    # the prelu's slope pass keeps its barrier; the leakyrelu is fused
    "prelu_leakyrelu": (lambda: cs.prelu_network(CPU), 7, 7),
    # two slope passes; the sigmoid's derivative in the Bernoulli tail;
    # recording, the update keeps its barrier (176 rows in layer 0)
    "classification": (lambda: cs.classification_network(CPU), 8, 9),
    # the categorical tail keeps its pass
    "multiclass": (lambda: cs.multiclass_network(CPU), 5, 5),
    # the elu before a relu keeps its derivative pass; the relu (its own
    # layer), sigmoid and exp derivatives are fused
    "fused_paths": (lambda: cs.fused_paths_network(CPU), 10, 10),
}


def _program(name, **kw):
    net, lik = MODELS[name][0]()
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=CPU))
    program = fused_mlp.build_trajectory_program(
        net.model, lik, flat.unravel_theta, flat.unravel_eta,
        flat.eta.numel(), n_rows=net.train_x.shape[0], **kw)
    assert program is not None, f"K1 declined {name}"
    return program, flat


@pytest.mark.parametrize("name", list(MODELS))
def test_k1_layer_table(name):
    """Rows cover the theta rows in order (each dense layer's bias and
    weights, then a prelu's slopes); each op is fused into the dense layer
    right before it, or is a row of its own when it follows another op;
    each activation's derivative is fused (``deriv``) exactly where a dense
    layer or a Gaussian or Bernoulli tail takes its output's gradient; the
    host table is the rows flattened as int32; and the barriers a step are
    counted from the table."""
    program, flat = _program(name)
    layers, ops = program.layers, program.ops
    assert program.table.dtype == np.int32
    assert program.table.tolist() == [v for row in layers for v in row]
    rows, width, k = 0, ops[0][1], 0
    for l, (d_in, d_out, act, row_off, slope_off, alpha_bits,
            deriv) in enumerate(layers):
        assert row_off == rows
        if d_in:
            assert ops[k] == ("dense", d_in, d_out) and d_in == width
            rows += d_out + d_in * d_out
            k += 1
        else:
            # an op that follows another op, not a dense layer
            assert act and k > 0 and ops[k - 1][0] != "dense"
            assert d_out == width
        if act:
            op = ops[k]
            assert fused_mlp.OP_CODES[op[0]] == act and op[1] == d_out
            k += 1
            if op[0] in ("prelu", "sqprelu"):
                assert slope_off == rows
                rows += d_out
            if op[0] == "leakyrelu":
                assert alpha_bits == fused_mlp._alpha_bits(op[2])
        if act not in fused_mlp.SLOPE_CODES:
            assert slope_off == -1
        if act != fused_mlp.OP_CODES["leakyrelu"]:
            assert alpha_bits == 0
        takes_gradient = (layers[l + 1][0] > 0 if l + 1 < len(layers)
                          else program.lik != "categorical")
        assert deriv == int(act not in (0,) + fused_mlp.SLOPE_CODES
                            and takes_gradient)
        width = d_out
    assert k == len(ops) and rows == flat.theta.numel()
    # one row per dense layer and per op that follows another op
    assert len(layers) == sum(
        op[0] == "dense" or ops[i - 1][0] != "dense"
        for i, op in enumerate(ops))
    assert program.update_merged
    assert program.barriers_per_step == MODELS[name][1]
    for kw, want in (({"record_uturn": True}, MODELS[name][2]),
                     ({"tempered": True}, MODELS[name][1])):
        other, _ = _program(name, **kw)
        assert other.layers == layers
        assert other.barriers_per_step == want
        d_in, d_out = layers[0][:2]
        assert other.update_merged == (
            "record_uturn" not in kw or (d_in + 1) * d_out <= 128)


@pytest.mark.parametrize("name", ["flagship", "classification",
                                  "multiclass"])
def test_k1_threads_per_block(name):
    """Blocks of 256 threads for a fleet whose blocks fit the card at once
    (4 an SM on 132 SMs) where a phase has more items than 128, else 128;
    the U-turn-recording and tempered programs choose the same."""
    for kw in ({}, {"record_uturn": True}, {"tempered": True}):
        program, _ = _program(name, **kw)
        for c, want in ((64, 256), (512, 256), (528, 256), (529, 128),
                        (2048, 128)):
            assert program.threads(c) == want


def _smem_floats_from_table(program):
    """The floats of shared memory the kernel lays out from the table, as
    its set-up does: q, v and g, the data's plane and per layer its
    product's plane (a dense layer) and its activation's plane (a layer
    with an activation), then two backward planes of the widest width."""
    d0, _, d = program.dims
    n = program.n_rows
    planes, widths = n * d0, [d0]
    for d_in, d_out, act, *_ in program.layers:
        planes += n * d_out * ((d_in > 0) + (d_in > 0 and act > 0)
                               + (d_in == 0))
        widths.append(d_out)
    return 3 * d + planes + 2 * n * max(widths)


@pytest.mark.parametrize("name", list(MODELS))
def test_k1_scope_and_shared_memory(name):
    """``build_trajectory_program`` takes every model it took before (the
    tempered and U-turn-recording programs too), ``smem_bytes`` is the
    layout of one plane per op (q, v, g, every op's output plane and two
    backward planes), and the planes the kernel lays out from the table
    fill exactly that."""
    program, flat = _program(name)
    d0, _, d = program.dims
    widths = [d0] + [fused_mlp._op_width(op) for op in program.ops]
    n = program.n_rows
    assert program.smem_bytes == 4 * (3 * d + n * sum(widths)
                                      + 2 * n * max(widths))
    assert 4 * _smem_floats_from_table(program) == program.smem_bytes
    assert program.smem_bytes <= fused_mlp.SMEM_BUDGET_BYTES
    for kw in ({"record_uturn": True}, {"tempered": True}):
        assert _program(name, **kw)[0].smem_bytes == program.smem_bytes


def _k3_layers_before(ops):
    """K3's table as ``make_fused_potential_vg`` built it before
    ``_layer_table`` was shared with K1."""
    layers, off = [], 0
    for op in ops:
        if op[0] == "dense":
            layers.append([op[1], op[2], 0, off, -1, 0])
        elif not layers or layers[-1][2]:
            return None
        else:
            layers[-1][2] = fused_mlp.OP_CODES[op[0]]
            if op[0] in ("prelu", "sqprelu"):
                layers[-1][4] = off
            elif op[0] == "leakyrelu":
                layers[-1][5] = fused_mlp._alpha_bits(op[2])
        off += fused_mlp._op_rows(op)
    return tuple(map(tuple, layers))


K3_OPS = {
    "tutorial": (("dense", 784, 20), ("sqprelu", 20), ("dense", 20, 20),
                 ("sqprelu", 20), ("dense", 20, 1), ("sigmoid", 1)),
    "wide_deep": (("dense", 256, 256), ("tanh", 256)) * 9
    + (("dense", 256, 1),),
    "ragged": (("dense", 3, 37), ("relu", 37), ("dense", 37, 70),
               ("elu", 70), ("dense", 70, 1)),
    "prelu_leakyrelu": (("dense", 3, 37), ("prelu", 37), ("dense", 37, 70),
                        ("leakyrelu", 70, 0.3), ("dense", 70, 1)),
    "digits": (("dense", 64, 20), ("tanh", 20), ("dense", 20, 10)),
    "prelu_last": (("dense", 3, 8), ("tanh", 8), ("dense", 8, 2),
                   ("prelu", 2)),
    "two_activations": (("dense", 2, 3), ("tanh", 3), ("relu", 3),
                        ("dense", 3, 1)),
}


@pytest.mark.parametrize("name", list(K3_OPS) + ["k1_models"])
def test_k3_layers_unchanged(name):
    """``make_fused_potential_vg`` gives the same ``layers`` as before
    ``_layer_table`` was shared, and still declines two activations in a
    row."""
    cases = ([K3_OPS[name]] if name != "k1_models" else
             [_program(m)[0].ops for m in MODELS])
    for ops in cases:
        want = _k3_layers_before(ops)
        vg = fused_mlp.make_fused_potential_vg(ops, 13)
        if want is None:
            assert vg is None
        else:
            assert vg.args[0].layers == want
            assert fused_mlp._layer_table(ops, standalone=True) == want


def test_k1_twin_matches_pallas_on_fused_paths():
    """K1's twin against the Pallas K1 in interpret mode at
    ``chip_smoke.fused_paths_network``'s stack (an elu, a relu after it,
    a sigmoid and an exp), per-chain (eps, L) with L in {1, 2, 3, 13}, to
    the tolerances of tests/test_fused_trajectory.py:72-79."""
    specs = [("GaussianDenseLayer", (1, 6)), ("Elu", ()), ("Relu", ()),
             ("GaussianDenseLayer", (6, 5)), ("Sigmoid", ()),
             ("GaussianDenseLayer", (5, 4)), ("Exp", ()),
             ("GaussianDenseLayer", (4, 1))]
    j_model = JSequential([getattr(J, name)(*a) for name, a in specs])
    j_lik = J.FixedGaussianLikelihood(sd=0.1)
    net, t_lik = cs.fused_paths_network(CPU)
    t_model = net.model
    assert [type(a).__name__ for a in t_model.layers] == \
        [type(a).__name__ for a in j_model.layers]
    c, n = 4, 11
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 1)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    params, hypers = j_model.init(jax.random.key(0))
    j_flat = j_flatten(params, hypers, {})
    t_flat = flatten_state(*convert.from_jax(params, hypers, {}))
    thetas = (0.3 * rng.normal(size=(c, j_flat.theta.size))).astype(
        np.float32)
    etas = np.tile(np.asarray(j_flat.eta)[None], (c, 1)).astype(np.float32)
    momenta = rng.normal(size=thetas.shape).astype(np.float32)
    eps = np.asarray([1e-2, 5e-3, 2e-3, 1e-2], np.float32)
    steps = np.asarray([1, 2, 3, 13], np.int32)
    j_traj = j_traj_build(j_model, j_lik, j_flat.unravel_theta,
                          j_flat.unravel_eta, x, y,
                          eta_dim=j_flat.eta.size, block_c=c,
                          interpret=True)
    t_traj = fused_mlp.try_build_fused_trajectory(
        t_model, t_lik, t_flat.unravel_theta, t_flat.unravel_eta,
        torch.tensor(x), torch.tensor(y), eta_dim=t_flat.eta.numel())
    assert j_traj is not None and t_traj is not None
    assert t_traj.args[0].barriers_per_step == MODELS["fused_paths"][1]
    jq, jv, jlp0, jlp1 = j_traj(jnp.asarray(thetas), jnp.asarray(etas),
                                jnp.asarray(momenta), x, y,
                                jnp.asarray(eps), jnp.asarray(steps))
    tq, tv, tlp0, tlp1 = t_traj(torch.tensor(thetas), torch.tensor(etas),
                                torch.tensor(momenta), torch.tensor(x),
                                torch.tensor(y), torch.tensor(eps),
                                torch.tensor(steps))
    for got, want, rtol, atol in ((tlp0, jlp0, 1e-4, 1e-3),
                                  (tq, jq, 1e-3, 1e-4), (tv, jv, 1e-3, 1e-3),
                                  (tlp1, jlp1, 1e-4, 1e-2)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=atol)
