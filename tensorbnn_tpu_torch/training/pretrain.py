"""MAP pretraining for warm-starting the HMC chain.

Counterpart of ``tensorbnn_tpu/training/pretrain.py``: a leaky-ReLU (or
tanh) MLP trained by amsgrad over ``cycles`` rounds with the learning rate
decaying 10x per cycle, minibatches of ``batch_size`` rows, and early
stopping that restores the best validation weights. Returns dense-layer
parameters in the reference layout for warm starts of
:class:`tensorbnn_tpu_torch.models.layers.GaussianDenseLayer` and friends
through ``Network.add(layer, parameters=...)``.

The JAX package runs an epoch as one jitted ``lax.scan`` over the batches;
here an epoch is one body (``_EpochBody``) over static buffers on
``device`` (the CUDA card unless the caller names another): the data stays
on the device, each epoch's permutation is copied into a device buffer
(from pinned memory on the card) and the batches gathered from it, the
optimizer step reads its batch through a device index, the amsgrad state
(moments, step count, learning rate) lives in device tensors that each
cycle refills in place, and the epoch ends with the validation loss, the
one host read an epoch, which early stopping needs. On a CUDA device the
first epoch of a call runs eagerly and every step after it replays one
captured CUDA graph of the step (``parallel/graphs.py::StepGraph``; a
graph of a step captures in milliseconds where one of a whole epoch took
seconds, and replays as fast); on the CPU every epoch runs eagerly. Both
run the same operations on the same buffers, so they give the same bits.
The update is optax's amsgrad written out (:func:`amsgrad_update`), which
``torch.optim.Adam(amsgrad=True)`` is not: optax keeps the running max of
the bias-corrected second moment, torch the max of the raw one. The
initial weights come from a ``torch.Generator`` seeded by ``seed`` (the
JAX package draws them from ``jax.random``, which torch cannot
reproduce); ``_train_mlp``'s ``init_params`` takes given ones instead.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorbnn_tpu_torch.parallel import graphs

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


def amsgrad_init(params: Sequence[torch.Tensor], lr: float = 0.0,
                 state: Optional[dict] = None) -> dict:
    """Zero moments and step count for :func:`amsgrad_update` at learning
    rate ``lr``; the count and ``lr`` are float32 scalars on the
    parameters' device. Given ``state`` (of the same parameters), fills it
    in place and returns it: a captured graph keeps the addresses it
    read."""
    if state is None:
        dev = params[0].device
        return {"count": torch.zeros((), dtype=torch.float32, device=dev),
                "lr": torch.full((), lr, dtype=torch.float32, device=dev),
                **{k: [torch.zeros_like(p) for p in params]
                   for k in ("mu", "nu", "nu_max")}}
    state["count"].zero_()
    state["lr"].fill_(lr)
    for k in ("mu", "nu", "nu_max"):
        torch._foreach_zero_(state[k])
    return state


@torch.no_grad()
def amsgrad_update(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor], state: dict) -> None:
    """One ``optax.amsgrad(lr)`` step, in place, in optax's order of
    operations: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    bias-corrected ``mu_hat`` and ``nu_hat``, ``nu_max = max(nu_max,
    nu_hat)``, ``p += -lr * mu_hat / (sqrt(nu_max) + eps)``. Multi-tensor
    (``torch._foreach_*``) ops, so a step is a fixed ~20 launches whatever
    the number of parameter tensors. The count, the bias corrections and
    ``lr`` are device scalars, so the step reads nothing from the host and
    a graph of it runs at any count and rate."""
    count = state["count"]
    count.add_(1)
    # the bias corrections 1 - decay**count in float32, as optax's
    bc1 = 1 - torch.pow(_B1, count)
    bc2 = 1 - torch.pow(_B2, count)
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
    # p - lr u: the bits of p + (-lr) u
    torch._foreach_mul_(update, state["lr"])
    torch._foreach_sub_(params, update)


class _EpochBody:
    """One epoch of the JAX ``run_epoch`` over static buffers on the data's
    device: ``fill`` writes an epoch's permutation, ``run(step)`` gathers
    the batches into ``bx (B, rows, in)`` and ``by (B, rows, out)``, calls
    ``step`` once a batch and ends with the validation loss in ``val``.
    ``step`` (the body's own, or a replay of a graph of it) takes batch
    ``i`` (a device index, which it advances), its gradient and an amsgrad
    step (``state``), and keeps its loss in ``losses (B,)``; it reads
    nothing from the host, so one graph of it replays every step of every
    epoch and cycle (each cycle refills ``state`` in place:
    ``amsgrad_init(..., state=)``)."""

    def __init__(self, params: List[torch.Tensor], loss_fn, x, y, xv, yv,
                 n_batches: int, batch_size: int):
        dev = x.device
        self.params, self.loss_fn = params, loss_fn
        self.x, self.y, self.xv, self.yv = x, y, xv, yv
        self.n_batches = n_batches
        # n_batches * batch_size rows, or all of them if there are fewer
        n = min(x.shape[0], n_batches * batch_size)
        self.perm = torch.empty(n, dtype=torch.int64, device=dev)
        # pinned on the card: the copy is asynchronous, ordered after the
        # epoch that read the last permutation
        self.host_perm = torch.empty(n, dtype=torch.int64,
                                     pin_memory=dev.type == "cuda")
        self.bx, self.by = (torch.empty((n_batches, n // n_batches,
                                         a.shape[1]), dtype=a.dtype,
                                        device=dev) for a in (x, y))
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        self.losses = torch.empty(n_batches, dtype=torch.float32, device=dev)
        self.val = torch.empty((), dtype=torch.float32, device=dev)
        self.state = amsgrad_init(params)

    def fill(self, perm: np.ndarray) -> None:
        """Copies an epoch's permutation into the device buffer. The
        caller reads the last epoch's ``val`` first, which orders this
        write after the copy that read the pinned buffer before."""
        self.host_perm.numpy()[:] = perm
        self.perm.copy_(self.host_perm, non_blocking=True)

    def run(self, step) -> None:
        for a, out in ((self.x, self.bx), (self.y, self.by)):
            torch.index_select(a, 0, self.perm, out=out.view(-1, a.shape[1]))
        self.i.zero_()
        for _ in range(self.n_batches):
            step()
        with torch.no_grad():
            self.val.copy_(self.loss_fn(self.params, self.xv, self.yv))

    def step(self) -> None:
        bx = torch.index_select(self.bx, 0, self.i)[0]
        by = torch.index_select(self.by, 0, self.i)[0]
        loss = self.loss_fn(self.params, bx, by)
        # slopes a tanh stack never reads get zero gradients, as in JAX
        grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                    materialize_grads=True)
        amsgrad_update(self.params, grads, self.state)
        with torch.no_grad():
            self.losses.index_copy_(0, self.i, loss.reshape(1))
            self.i.add_(1)


def _train_mlp(hidden: int, input_dims: int, output_dims: int, width: int,
               cycles: int, epochs: int, alpha: float,
               train_in, train_out, val_in, val_out, *,
               classification: bool, base_lr: float,
               patience: int = 10, batch_size: int = 32, seed: int = 1000,
               callbacks: bool = True, verbose: bool = False,
               train_slopes: bool = False,
               hidden_activation: str = "leakyrelu", device="cuda",
               init_params: Optional[Sequence] = None, graph_type=None,
               eager: bool = False,
               epoch_hook: Optional[Callable[[float], None]] = None):
    """The trainer behind both public entry points (JAX ``_train_mlp``).
    ``init_params``, a sequence of ``(w (in, out), b (out,))`` array
    pairs, replaces the glorot draw (slopes still start at ``alpha``).
    Every epoch after a call's first runs its steps as replays of one
    graph of a step captured by ``graph_type`` (None: ``graphs.CudaGraph``
    on a CUDA device; on the CPU every epoch runs eagerly; the CPU tests
    give a stand-in); ``eager=True`` runs every epoch eagerly on any
    device.
    ``epoch_hook`` is called after each epoch with its validation loss
    (read on the host, so the epoch's work on the device is done)."""
    dev = _device(device)
    if eager:
        graph_type = None
    elif graph_type is None and dev.type == "cuda":
        graph_type = graphs.CudaGraph
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
    body = _EpochBody(params, loss_fn, x, y, xv, yv, n_batches, batch_size)
    run_epoch = (functools.partial(body.run, body.step)
                 if graph_type is None
                 else graphs.StepGraph(body.run, body.step, dev, graph_type))
    best = [p.detach().clone() for p in params] if callbacks else None

    for cycle in range(cycles):
        amsgrad_init(params, base_lr * (10.0 ** (-cycle)), body.state)
        best_val = float("inf")
        if callbacks:
            torch._foreach_copy_(best, [p.detach() for p in params])
        strikes = 0
        rng = np.random.default_rng(seed + cycle)
        perm = None
        for epoch in range(epochs):
            if perm is None:
                perm = rng.permutation(n)
            body.fill(perm[: n_batches * batch_size])
            run_epoch()
            # one permutation an epoch, as the JAX trainer draws: the next
            # epoch's is drawn while the card runs this one where this one
            # cannot end the cycle, else after its validation loss
            go_on = epoch + 1 < epochs and (not callbacks
                                            or strikes + 1 < patience)
            perm = rng.permutation(n) if go_on else None
            val_loss = float(body.val)
            if epoch_hook is not None:
                epoch_hook(val_loss)
            if val_loss < best_val:
                best_val, strikes = val_loss, 0
                if callbacks:
                    torch._foreach_copy_(best, [p.detach() for p in params])
            else:
                strikes += 1
            if verbose and epoch % 20 == 0:
                train_loss = float(body.losses.mean())
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
