"""The port's dense-layer ``matmul_precision`` and ``compute_dtype`` against
the JAX package's (``tensorbnn_tpu/models/layers.py:118-170``).

On the CPU every float32 product is exact whatever the precision, so
"highest" and "high" must leave values and gradients bit-equal to the
default here (the card-only tests in tests/test_torch_cuda.py hold "highest"
to the float32 bits with TF32 switched on). ``compute_dtype="bfloat16"`` is
held against the JAX layer at bf16 tolerance (rtol 1e-2 on the value,
5e-2 of the largest entry on the gradient), K1's and K3's scope
decline a bf16 layer and not a precision, and the resume fingerprint marks
both as the JAX driver's does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import tensorbnn_tpu as J
import tensorbnn_tpu_torch as T
from tensorbnn_tpu.models.sequential import Sequential as JSequential
from tensorbnn_tpu.ops.fused_mlp import _model_program as j_program
from tensorbnn_tpu.sampler.potential import flatten_state as j_flatten, \
    make_potentials as j_potentials
from tensorbnn_tpu_torch import convert
from tensorbnn_tpu_torch.models.sequential import Sequential as TSequential
from tensorbnn_tpu_torch.ops.fused_mlp import _model_program as t_program
from tensorbnn_tpu_torch.sampler.potential import flatten_state as \
    t_flatten, make_potentials as t_potentials

torch.set_num_threads(1)


def _stack(pkg, **kw):
    return [pkg.GaussianDenseLayer(3, 8, **kw), pkg.Tanh(),
            pkg.CauchyDenseLayer(8, 8, **kw), pkg.Tanh(),
            pkg.GaussianDenseLayer(8, 1, **kw)]


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_precision_is_exact_float32_on_the_cpu(precision):
    """Values and the gradients of a batched ``grad_and_value`` (the plain
    path's oracle) bit-equal to the default layers'."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(7, 3)).astype(np.float32))
    models = [TSequential(_stack(T)),
              TSequential(_stack(T, matmul_precision=precision))]
    params, _ = models[0].init(torch.Generator().manual_seed(0))
    flat = t_flatten(params, tuple({} for _ in params), {})
    thetas = flat.theta + 0.1 * torch.tensor(
        rng.normal(size=(4, flat.theta.numel())).astype(np.float32))
    out = []
    for m in models:
        def f(th, m=m):
            return (m.apply(flat.unravel_theta(th), x) ** 2).sum()
        out.append(vmap(grad_and_value(f))(thetas))
    for a, b in zip(out[0], out[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[0][0].abs().sum() > 0


def test_precision_and_compute_dtype_are_mutually_exclusive():
    for layer in (T.GaussianDenseLayer, T.CauchyDenseLayer):
        with pytest.raises(ValueError, match="mutually exclusive"):
            layer(3, 4, compute_dtype="bfloat16", matmul_precision="highest")
    with pytest.raises(ValueError, match="matmul_precision"):
        T.GaussianDenseLayer(3, 4, matmul_precision="fastest")


def _potentials(kw, lik_name="FixedGaussianLikelihood"):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    y = np.sin(x.sum(axis=1)).astype(np.float32)
    j_model, t_model = JSequential(_stack(J, **kw)), TSequential(
        _stack(T, **kw))
    j_lik = getattr(J, lik_name)(sd=0.1)
    t_lik = getattr(T, lik_name)(sd=0.1)
    params, hypers = j_model.init(jax.random.key(2))
    lik_h = j_lik.init_hypers()
    j_flat = j_flatten(params, hypers, lik_h)
    t_flat = t_flatten(*convert.from_jax(params, hypers, lik_h))
    jp = j_potentials(j_model, j_lik, jnp.asarray(x), jnp.asarray(y),
                      j_flat.unravel_theta, j_flat.unravel_eta)
    tp = t_potentials(t_model, t_lik, torch.tensor(x), torch.tensor(y),
                      t_flat.unravel_theta, t_flat.unravel_eta)
    thetas = (np.asarray(j_flat.theta) + 0.05 * rng.normal(
        size=(3, j_flat.theta.size))).astype(np.float32)
    etas = np.tile(np.asarray(j_flat.eta), (3, 1))
    return jp, tp, thetas, etas


@pytest.mark.parametrize("lik_name", ["FixedGaussianLikelihood",
                                      "GaussianLikelihood"])
def test_bfloat16_layers_match_jax(lik_name):
    """The main and hyper oracles of a stack of bf16 layers against the JAX
    package's: values to rtol 1e-2 (bf16 activations over 32 rows),
    gradients to rtol 5e-2 / atol 5e-2 times their largest entry (bf16
    rounds each activation to 3 significant digits)."""
    jp, tp, thetas, etas = _potentials({"compute_dtype": "bfloat16"},
                                       lik_name)
    th, et = torch.tensor(thetas), torch.tensor(etas)
    for want, got in ((jax.vmap(jp.main_vg)(thetas, etas),
                       tp.main_vg(th, et)),
                      (jax.vmap(jp.hyper_vg)(etas, thetas),
                       tp.hyper_vg(et, th))):
        (wv, wg), (gv, gg) = want, got
        assert gv.dtype == torch.float32
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-2)
        scale = float(np.abs(np.asarray(wg)).max())
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=5e-2,
                                   atol=5e-2 * scale)
    # and it is not the float32 density: bf16 moves the value
    _, tp32, _, _ = _potentials({}, lik_name)
    assert not torch.equal(tp32.main_vg(th, et)[0], tp.main_vg(th, et)[0])


def test_kernel_scope_declines_bf16_layers_not_precision():
    """K1's and K3's pattern match (the port's ``_model_program``, the JAX
    package's likewise) declines a stack with a bf16 layer and takes one
    with a precision."""
    lik_t, lik_j = T.FixedGaussianLikelihood(sd=0.1), \
        J.FixedGaussianLikelihood(sd=0.1)
    for kw, in_scope in (({}, True), ({"matmul_precision": "highest"}, True),
                         ({"compute_dtype": "bfloat16"}, False)):
        got = t_program(TSequential(_stack(T, **kw)), lik_t)
        want = j_program(JSequential(_stack(J, **kw)), lik_j)
        assert (got is not None) == (want is not None) == in_scope, kw


def test_fingerprints_mark_compute_settings_as_jax(tmp_path):
    """A run's fingerprint marks "@prec=highest" and "@bfloat16" on its
    layers as the JAX driver's does (the same dict for the same run), and
    a resume across a precision is refused."""
    x = np.linspace(-1, 1, 8)
    y = np.sin(3 * x)

    def run(pkg, name, epochs=4, **kw):
        if pkg is J:
            from tensorbnn_tpu.network import Network
            net = Network(jnp.float32, 1, x, y, x, y, seed=1)
        else:
            net = T.Network(np.float32, 1, x, y, x, y, seed=1, device="cpu")
        net.add(pkg.GaussianDenseLayer(1, 4, **kw)).add(pkg.Tanh())
        net.add(pkg.GaussianDenseLayer(4, 1, **kw))
        net.setup_mcmc(leapfrog_start=4, leapfrog_min=2, leapfrog_max=8,
                       burnin=4, averaging_steps=2, hyper_leapfrog=3)
        net.train(epochs, 2, pkg.FixedGaussianLikelihood(sd=0.1),
                  use_fused=False, verbose=False,
                  checkpoint_dir=str(tmp_path / name))
        return json.load(open(tmp_path / name / "resume.json"))[
            "fingerprint"]

    for kw, mark in (({"matmul_precision": "highest"}, "@prec=highest"),
                     ({"compute_dtype": "bfloat16"}, "@bfloat16")):
        got, want = (run(pkg, f"{pkg.__name__}{mark}", **kw)
                     for pkg in (T, J))
        assert got == want
        assert got["layers"][0] == f"GaussianDenseLayer(1,4){mark}"
    with pytest.raises(ValueError, match="layers"):
        run(T, "tensorbnn_tpu_torch@prec=highest", epochs=8)
