"""MAP pretraining for warm-starting the HMC chain.

Counterpart of ``tensorbnn_tpu/training/pretrain.py``: a leaky-ReLU (or
tanh) MLP trained by amsgrad over ``cycles`` rounds with the learning rate
decaying 10x per cycle, minibatches of ``batch_size`` rows, and early
stopping that restores the best validation weights. Returns dense-layer
parameters in the reference layout for warm starts of
:class:`tensorbnn_tpu_torch.models.layers.GaussianDenseLayer` and friends
through ``Network.add(layer, parameters=...)``.

The JAX package runs an epoch as one jitted ``lax.scan``; here an epoch is
eager torch on ``device`` (the CUDA card unless the caller names another):
the data stays on the device, each epoch's permutation is moved there once
and the batches gathered from it, and the one host read an epoch is the
validation loss that early stopping needs. The update is optax's amsgrad
written out (:func:`amsgrad_update`), which ``torch.optim.Adam(amsgrad=
True)`` is not: optax keeps the running max of the bias-corrected second
moment, torch the max of the raw one. The initial weights come from a
``torch.Generator`` seeded by ``seed`` (the JAX package draws them from
``jax.random``, which torch cannot reproduce); ``_train_mlp``'s
``init_params`` takes given ones instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: optax.amsgrad's defaults: b1, b2, eps (eps_root is 0)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
#: the classification loss clips its predictions to [_CLIP, 1 - _CLIP]
_CLIP = 1e-7


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"pretraining: device {device!r} needs a CUDA card, and torch "
            f"sees none here; pass device='cpu' to run on the CPU")
    return dev


def _mlp_init(generator: torch.Generator, dims: Sequence[int],
              dtype=torch.float32) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Glorot-uniform weights in the JAX package's ``(in, out)`` layout and
    zero biases, drawn on the CPU from ``generator``."""
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        limit = float(np.sqrt(6.0 / (a + b)))
        w = torch.empty((a, b), dtype=dtype).uniform_(-limit, limit,
                                                      generator=generator)
        params.append((w, torch.zeros((b,), dtype=dtype)))
    return params


def _mlp_apply(dense, slopes, x, alpha: float, final_sigmoid: bool,
               hidden_activation: str = "leakyrelu"):
    for i, (w, b) in enumerate(dense):
        x = torch.addmm(b, x, w)
        if i < len(dense) - 1:
            if hidden_activation == "tanh":
                x = torch.tanh(x)
            else:
                s = slopes[i] if slopes is not None else alpha
                x = torch.where(x < 0, s * x, x)
    if final_sigmoid:
        x = torch.sigmoid(x)
    return x


def amsgrad_init(params: Sequence[torch.Tensor]) -> dict:
    """Zero moments for :func:`amsgrad_update`."""
    return {"count": 0,
            **{k: [torch.zeros_like(p) for p in params]
               for k in ("mu", "nu", "nu_max")}}


@torch.no_grad()
def amsgrad_update(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor], state: dict,
                   lr: float) -> None:
    """One ``optax.amsgrad(lr)`` step, in place, in optax's order of
    operations: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    bias-corrected ``mu_hat`` and ``nu_hat``, ``nu_max = max(nu_max,
    nu_hat)``, ``p += -lr * mu_hat / (sqrt(nu_max) + eps)``. Multi-tensor
    (``torch._foreach_*``) ops, so a step is a fixed ~15 launches whatever
    the number of parameter tensors."""
    state["count"] += 1
    t = np.float32(state["count"])
    # the bias corrections in float32, as optax computes 1 - decay**count
    bc1 = float(np.float32(1) - np.float32(_B1) ** t)
    bc2 = float(np.float32(1) - np.float32(_B2) ** t)
    mu, nu, nu_max = state["mu"], state["nu"], state["nu_max"]
    torch._foreach_mul_(mu, _B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - _B1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - _B2)
    torch._foreach_mul_(nu, _B2)
    torch._foreach_add_(nu, sq)
    torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
    denom = torch._foreach_sqrt(nu_max)
    torch._foreach_add_(denom, _EPS)
    update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    torch._foreach_mul_(update, -lr)
    torch._foreach_add_(params, update)


def _epoch(params: List[torch.Tensor], state: dict, bx: torch.Tensor,
           by: torch.Tensor, lr: float, loss_fn) -> List[torch.Tensor]:
    """One pass over the batches ``bx (B, rows, in)``, ``by (B, rows,
    out)``: a gradient and an amsgrad step each. Returns the batch losses
    as device scalars (nothing is read back)."""
    losses = []
    for i in range(bx.shape[0]):
        loss = loss_fn(params, bx[i], by[i])
        # slopes a tanh stack never reads get zero gradients, as in JAX
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        amsgrad_update(params, grads, state, lr)
        losses.append(loss.detach())
    return losses


def _train_mlp(hidden: int, input_dims: int, output_dims: int, width: int,
               cycles: int, epochs: int, alpha: float,
               train_in, train_out, val_in, val_out, *,
               classification: bool, base_lr: float,
               patience: int = 10, batch_size: int = 32, seed: int = 1000,
               callbacks: bool = True, verbose: bool = False,
               train_slopes: bool = False,
               hidden_activation: str = "leakyrelu", device="cuda",
               init_params: Optional[Sequence] = None):
    """The trainer behind both public entry points (JAX ``_train_mlp``).
    ``init_params``, a sequence of ``(w (in, out), b (out,))`` array
    pairs, replaces the glorot draw (slopes still start at ``alpha``)."""
    dev = _device(device)
    dtype = torch.float32

    def put(a, cols):
        a = np.asarray(a, np.float32)
        return torch.tensor(a.reshape(len(a), cols), device=dev)

    x, y = put(train_in, input_dims), put(train_out, output_dims)
    xv, yv = put(val_in, input_dims), put(val_out, output_dims)

    dims = [input_dims] + [width] * hidden + [output_dims]
    if init_params is None:
        init_params = _mlp_init(torch.Generator().manual_seed(seed), dims,
                                dtype)
    params = [torch.tensor(np.asarray(a), dtype=dtype, device=dev)
              for pair in init_params for a in pair]
    n_dense = len(params)
    if train_slopes:
        # PReLU-style per-feature slopes, trained jointly (the JAX
        # package's option: the vectors Prelu/SquarePrelu warm-start from)
        params += [torch.full((width,), alpha, dtype=dtype, device=dev)
                   for _ in range(hidden)]
    for p in params:
        p.requires_grad_(True)
    clip_lo = torch.tensor(_CLIP, dtype=dtype, device=dev)
    clip_hi = torch.tensor(1 - _CLIP, dtype=dtype, device=dev)

    def loss_fn(p, bx, by):
        dense = list(zip(p[0:n_dense:2], p[1:n_dense:2]))
        slopes = p[n_dense:] if train_slopes else None
        preds = _mlp_apply(dense, slopes, bx, alpha, classification,
                           hidden_activation)
        if classification:
            # max then min, as jnp.clip (its gradient at a tie)
            preds = torch.minimum(torch.maximum(preds, clip_lo), clip_hi)
            return -torch.mean(by * torch.log(preds)
                               + (1 - by) * torch.log1p(-preds))
        return torch.mean((preds - by) ** 2)

    n = x.shape[0]
    n_batches = max(n // batch_size, 1)

    for cycle in range(cycles):
        lr = base_lr * (10.0 ** (-cycle))
        state = amsgrad_init(params)
        best_val = float("inf")
        best = [p.detach().clone() for p in params] if callbacks else None
        strikes = 0
        rng = np.random.default_rng(seed + cycle)
        for epoch in range(epochs):
            perm = torch.as_tensor(
                rng.permutation(n)[: n_batches * batch_size]).to(dev)
            bx = x[perm].reshape(n_batches, -1, input_dims)
            by = y[perm].reshape(n_batches, -1, output_dims)
            losses = _epoch(params, state, bx, by, lr, loss_fn)
            with torch.no_grad():
                val_loss = float(loss_fn(params, xv, yv))
            if val_loss < best_val:
                best_val, strikes = val_loss, 0
                if callbacks:
                    best = [p.detach().clone() for p in params]
            else:
                strikes += 1
            if verbose and epoch % 20 == 0:
                train_loss = float(torch.stack(losses).mean())
                print(f"cycle {cycle} epoch {epoch}: "
                      f"train {train_loss:.5f} val {val_loss:.5f}")
            if callbacks and strikes >= patience:
                break
        if callbacks:
            with torch.no_grad():
                torch._foreach_copy_(params, best)  # restore_best_weights

    host = [p.detach().cpu().numpy() for p in params]
    weights = [w.T for w in host[0:n_dense:2]]                  # (out, in)
    biases = [b.reshape(-1, 1) for b in host[1:n_dense:2]]
    if train_slopes:
        activations: List = host[n_dense:]
    else:
        # fixed leaky-relu: the constant per-feature slope vectors
        activations = [np.full((width,), alpha, np.float32)
                       for _ in range(hidden)]
    return weights, biases, activations


def train_basic_regression(hidden: int, input_dims: int, output_dims: int,
                           width: int, cycles: int, epochs: int, alpha: float,
                           train_in, train_out, val_in, val_out,
                           name: str = None, callbacks: bool = True,
                           patience: int = 10, seed: int = 1000,
                           verbose: bool = False,
                           train_slopes: bool = False,
                           batch_size: int = 32,
                           hidden_activation: str = "leakyrelu",
                           device="cuda") -> Tuple[list, list, list]:
    """MAP-pretrains a regression MLP; returns (weights, biases, activations)
    in the reference layout (W: (out, in), b: (out, 1), one slope vector per
    hidden activation) for warm starts.

    amsgrad at lr 0.01 decaying 10x per cycle, MSE loss, early stopping on
    validation loss with best-weight restore. With ``train_slopes=True``
    the activations are PReLU-style trainable slope vectors, ready for
    ``prelu_warm_start`` / ``squareprelu_warm_start``. Runs on ``device``,
    the CUDA card unless the caller names another.
    """
    del name  # the reference saves a Keras model backup
    return _train_mlp(hidden, input_dims, output_dims, width, cycles, epochs,
                      alpha, train_in, train_out, val_in, val_out,
                      classification=False, base_lr=0.01,
                      patience=patience, seed=seed, callbacks=callbacks,
                      verbose=verbose, train_slopes=train_slopes,
                      batch_size=batch_size,
                      hidden_activation=hidden_activation, device=device)


def train_basic_classification(hidden: int, input_dims: int,
                               output_dims: int, width: int, cycles: int,
                               epochs: int, alpha: float,
                               train_in, train_out, val_in, val_out,
                               name: str = None, callbacks: bool = True,
                               patience: int = 10, seed: int = 1000,
                               verbose: bool = False,
                               train_slopes: bool = False, device="cuda"):
    """Binary-classification variant with a sigmoid head, binary
    cross-entropy and lr 0.001."""
    del name
    return _train_mlp(hidden, input_dims, output_dims, width, cycles, epochs,
                      alpha, train_in, train_out, val_in, val_out,
                      classification=True, base_lr=0.001,
                      patience=patience, seed=seed, callbacks=callbacks,
                      verbose=verbose, train_slopes=train_slopes,
                      device=device)


def dense_warm_start(weights: list, biases: list, index: int) -> dict:
    """Converts pretrained (W, b) in reference layout into a params override
    dict for ``Network.add(layer, parameters=...)``."""
    return {"w": np.asarray(weights[index]).T,
            "b": np.asarray(biases[index]).reshape(-1)}


def prelu_warm_start(activations: list, index: int) -> dict:
    """Pretrained slope vector -> Prelu params override (slopes used
    as-is)."""
    return {"slopes": np.asarray(activations[index]).reshape(-1)}


def squareprelu_warm_start(activations: list, index: int,
                           floor: float = 1e-4) -> dict:
    """Pretrained slope vector -> SquarePrelu params override.

    SquarePrelu's sampled parameter is the square root of the effective
    slope; negative learned slopes are floored since the squared
    parameterization cannot represent them.
    """
    s = np.asarray(activations[index], np.float64).reshape(-1)
    return {"slopes": np.sqrt(np.maximum(s, floor))}
