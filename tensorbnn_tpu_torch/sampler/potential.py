"""Log-posterior assembly: flat-vector targets for the two HMC blocks.

Counterpart of ``tensorbnn_tpu/sampler/potential.py``. The model state is
flattened once into ``theta`` (params) and ``eta`` (hypers, then the
likelihood's hypers) in the JAX package's ``ravel_pytree`` order: leaves
in tree order with dict keys sorted, so per dense layer the bias rows come
first, then the row-major ``(in, out)`` weights, and per layer the hypers
go ``b_loc, b_scale, w_loc, w_scale``. States therefore pass between the
two packages as plain arrays.

``make_potentials`` returns single-chain targets plus value-and-grad
oracles batched over chains (``torch.func.vmap`` of
``torch.func.grad_and_value``), and the tempered variants that parallel
tempering runs (the power posterior ``prior + beta * loglik``, priors
untempered). With ``data_chunk`` the likelihood's value and gradient
accumulate over row chunks (``_chunked_loglik``), which bounds the
activations a call holds to ``chains x data_chunk x width``. With
``peers`` (a chain shard's data peers on a mesh, parallel/mesh.py) the
likelihood's value and gradient are taken on each peer's rows and summed
over the peers, the priors added once (the JAX package's ``_combine``
around its ``axis_name`` psum).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from tensorbnn_tpu_torch.likelihoods import Likelihood
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.sampler.hmc import _kahan_add


def tree_leaves(tree) -> list:
    """Leaves of nested tuples/lists/dicts in tree order (dict keys
    sorted, as ``jax.tree.flatten`` orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves: Iterator):
    """Rebuilds ``template``'s structure from an iterator of leaves."""
    if isinstance(template, dict):
        return {k: tree_unflatten(template[k], leaves)
                for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        return type(template)(tree_unflatten(t, leaves) for t in template)
    return next(leaves)


def _make_unravel(example) -> Callable:
    """``unravel(vec (..., D)) -> tree`` whose leaves keep the leading
    axes of ``vec``; works on torch tensors and numpy arrays alike."""
    shapes = [tuple(np.shape(leaf)) for leaf in tree_leaves(example)]
    sizes = [int(np.prod(s, dtype=int)) for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)

    def unravel(vec):
        lead = tuple(vec.shape[:-1])
        parts = [vec[..., offsets[i]:offsets[i + 1]].reshape(lead + shapes[i])
                 for i in range(len(shapes))]
        return tree_unflatten(example, iter(parts))

    unravel.size = int(offsets[-1])
    return unravel


class FlatModelState(NamedTuple):
    """Flat vectors plus their unflatten closures."""
    theta: torch.Tensor
    eta: torch.Tensor
    unravel_theta: Callable
    unravel_eta: Callable


def _ravel(tree, example_leaf=None) -> torch.Tensor:
    leaves = [torch.as_tensor(leaf).reshape(-1) for leaf in tree_leaves(tree)]
    if not leaves:
        return torch.zeros(0, dtype=getattr(example_leaf, "dtype",
                                            torch.float32))
    return torch.cat(leaves)


def flatten_state(params, hypers, lik_hypers) -> FlatModelState:
    """Flattens ``params -> theta`` and ``(hypers, lik_hypers) -> eta``."""
    theta = _ravel(params)
    eta = _ravel((hypers, lik_hypers), theta)
    return FlatModelState(theta, eta, _make_unravel(params),
                          _make_unravel((hypers, lik_hypers)))


def host_unraveler(example_pytree) -> Callable:
    """Numpy unravel of one flat vector (or a stack of them) into the
    example's structure, for host-side consumers."""
    unravel = _make_unravel(example_pytree)
    return lambda vec: unravel(np.asarray(vec))


def eta_index_probe(unravel_eta, eta_dim: int):
    """``(hypers, lik_hypers)`` with every leaf replaced by its flat eta
    index (as numpy ints)."""
    return unravel_eta(np.arange(eta_dim))


class Potentials(NamedTuple):
    #: main(theta (D,), eta (H,)) -> scalar: prior + likelihood
    main: Callable
    #: hyper(eta (H,), theta (D,)) -> scalar: hyperpriors + conditional
    #: priors (+ likelihood when its hypers couple in)
    hyper: Callable
    #: main_vg(thetas (C, D), etas (C, H)) -> ((C,), (C, D))
    main_vg: Callable
    #: hyper_vg(etas (C, H), thetas (C, D)) -> ((C,), (C, H))
    hyper_vg: Callable
    #: main_vg_t(thetas, etas, betas (C,)): prior + beta * loglik
    main_vg_t: Callable
    #: hyper_vg_t(etas, thetas, betas (C,)): beta scales only the coupled
    #: likelihood term
    hyper_vg_t: Callable
    #: loglik(thetas (C, D), etas (C, H)) -> (C,), the data log-likelihood
    loglik: Callable


def _batched_value_and_grad(fn: Callable) -> Callable:
    vg = vmap(grad_and_value(fn))

    def value_and_grad(z, other):
        g, v = vg(z, other)
        return v, g

    return value_and_grad


def n_row_chunks(n_rows: int, data_chunk: Optional[int]) -> int:
    """The number of ``data_chunk``-row chunks of ``n_rows`` rows, 1 when
    chunking is off (no ``data_chunk``). Raises when ``data_chunk`` does
    not divide the rows, with the JAX package's message."""
    if not data_chunk:
        return 1
    if n_rows % data_chunk:
        raise ValueError(
            f"data_chunk ({data_chunk}) must divide the (local) training "
            f"rows ({n_rows}); pad the dataset or pick a divisor")
    return n_rows // data_chunk


def row_chunks(x, y, data_chunk: Optional[int]) -> Optional[list]:
    """``[(x_c, y_c), ...]``, views of ``data_chunk`` rows each, or None
    when chunking is off (no ``data_chunk``, or one chunk). Raises as
    ``n_row_chunks``."""
    n_rows = int(x.shape[0])
    if n_row_chunks(n_rows, data_chunk) == 1:
        return None
    return [(x[i:i + data_chunk], y[i:i + data_chunk])
            for i in range(0, n_rows, data_chunk)]


def _chunked_loglik(loglik_chunk: Callable, chunks: list,
                    argnums: int) -> Tuple[Callable, Callable]:
    """Batched ``(value, value_and_grad)`` of the row-additive likelihood
    ``sum_c loglik_chunk(theta, eta, x_c, y_c)`` over ``(C, ...)`` blocks;
    the gradient is taken with respect to argument ``argnums`` (0: theta,
    1: eta).

    Each chunk's value and gradient are computed in turn (the JAX package
    rematerializes each chunk under ``jax.checkpoint``; one autograd graph
    over every chunk would hold every chunk's activations at once). The
    values accumulate with the Kahan carry of ``_kahan_add``, as the JAX
    package's scan carry does: a plain float32 carry loses ``ulp(|total|) /
    2`` a chunk, nats at a 1M-row log-likelihood. The gradients sum
    plainly (their compensation's derivative cancels exactly in JAX)."""
    value_b = vmap(loglik_chunk, in_dims=(0, 0, None, None))
    vg_b = vmap(grad_and_value(loglik_chunk, argnums=argnums),
                in_dims=(0, 0, None, None))

    def value(thetas, etas):
        acc = comp = torch.zeros(thetas.shape[0], dtype=thetas.dtype,
                                 device=thetas.device)
        for xc, yc in chunks:
            acc, comp = _kahan_add(acc, comp, value_b(thetas, etas, xc, yc))
        return acc

    def value_and_grad(thetas, etas):
        acc = comp = torch.zeros(thetas.shape[0], dtype=thetas.dtype,
                                 device=thetas.device)
        grad = None
        for xc, yc in chunks:
            g, v = vg_b(thetas, etas, xc, yc)
            acc, comp = _kahan_add(acc, comp, v)
            grad = g if grad is None else grad + g
        return acc, grad

    return value, value_and_grad


def _lik_oracles(model: Sequential, likelihood: Likelihood, x, y,
                 unravel_theta: Callable, unravel_eta: Callable,
                 data_chunk: Optional[int]) -> Tuple[Callable, ...]:
    """``(value, vg in theta, vg in eta)`` of the likelihood of the rows
    ``x``, ``y``, batched over ``(C, ...)`` blocks: ``value(thetas,
    etas)``, ``vg(thetas, etas)``, ``vg_eta(etas, thetas)``; over row
    chunks (``_chunked_loglik``) when ``data_chunk`` makes more than one."""
    chunks = row_chunks(x, y, data_chunk)

    def loglik_main(theta, eta):
        _, lik_hypers = unravel_eta(eta)
        preds = model.apply(unravel_theta(theta), x)
        return likelihood.log_likelihood(preds, y, lik_hypers)

    if chunks is None:
        return (vmap(loglik_main), _batched_value_and_grad(loglik_main),
                _batched_value_and_grad(
                    lambda eta, theta: loglik_main(theta, eta)))

    def loglik_chunk(theta, eta, xc, yc):
        _, lik_hypers = unravel_eta(eta)
        preds = model.apply(unravel_theta(theta), xc)
        return likelihood.log_likelihood(preds, yc, lik_hypers)

    lik_value, lik_vg = _chunked_loglik(loglik_chunk, chunks, 0)
    _, lik_vg_eta = _chunked_loglik(loglik_chunk, chunks, 1)
    return lik_value, lik_vg, lambda etas, thetas: lik_vg_eta(thetas, etas)


def make_potentials(model: Sequential, likelihood: Likelihood,
                    x: torch.Tensor, y: torch.Tensor,
                    unravel_theta: Callable,
                    unravel_eta: Callable,
                    data_chunk: Optional[int] = None,
                    peers=None) -> Potentials:
    """Builds the two log-posterior targets over flat vectors, closing
    over the data ``x (N, d0)`` and ``y``. With ``data_chunk`` (a divisor
    of N, more than one chunk) the batched oracles take the likelihood's
    value and gradient chunk by chunk (``_chunked_loglik``), apart from the
    priors, as the JAX package's ``_combine`` does; the single-chain
    ``main`` and ``hyper`` sum the chunks' values likewise.

    ``peers`` (``parallel.mesh.DataPeers``, more than one peer): the
    likelihood's value and gradient are taken on each peer's rows (chunked
    there with ``data_chunk``, which must divide the local rows, each
    peer's Kahan carry its own) and summed over the peers before the
    priors, taken once, are added (``_combine``); ``x`` and ``y`` are not
    read. The tempered oracles sum the log-likelihood before beta scales
    it, as the JAX package's do."""
    sharded = peers is not None and len(peers) > 1

    def loglik(params, lik_hypers):
        preds = model.apply(params, x)
        return likelihood.log_likelihood(preds, y, lik_hypers)

    def main(theta, eta):
        params = unravel_theta(theta)
        hypers, lik_hypers = unravel_eta(eta)
        return loglik(params, lik_hypers) + model.log_prior(hypers, params)

    def hyper(eta, theta):
        params = unravel_theta(theta)
        hypers, lik_hypers = unravel_eta(eta)
        value = model.log_hyper_prior(hypers, params)
        if likelihood.main_probs_in_hypers:
            value = value + loglik(params, lik_hypers)
        return value

    # -- the priors apart from the likelihood (tempered, chunked and
    # sharded targets differentiate the two separately, as the JAX
    # package does, and beta scales only the likelihood's part)
    def prior_main(theta, eta):
        hypers, _ = unravel_eta(eta)
        return model.log_prior(hypers, unravel_theta(theta))

    def hyper_rep(eta, theta):
        hypers, _ = unravel_eta(eta)
        return model.log_hyper_prior(hypers, unravel_theta(theta))

    prior_vg = _batched_value_and_grad(prior_main)
    hyper_rep_vg = _batched_value_and_grad(hyper_rep)
    main_vg = _batched_value_and_grad(main)
    hyper_vg = _batched_value_and_grad(hyper)
    if sharded:
        oracles = [_lik_oracles(model, likelihood, xj, yj, unravel_theta,
                                unravel_eta, data_chunk)
                   for xj, yj in peers.shards]
        lik_value, lik_vg, hyper_lik_vg = (
            functools.partial(peers.sum, [o[i] for o in oracles])
            for i in range(3))
    else:
        lik_value, lik_vg, hyper_lik_vg = _lik_oracles(
            model, likelihood, x, y, unravel_theta, unravel_eta, data_chunk)
    if sharded or row_chunks(x, y, data_chunk) is not None:
        main_vg, hyper_vg = _combine(lik_vg, prior_vg), _combine(
            hyper_lik_vg if likelihood.main_probs_in_hypers else None,
            hyper_rep_vg)

        def main(theta, eta):
            return (lik_value(theta[None], eta[None])[0]
                    + prior_main(theta, eta))

        def hyper(eta, theta):
            value = hyper_rep(eta, theta)
            if likelihood.main_probs_in_hypers:
                value = value + lik_value(theta[None], eta[None])[0]
            return value

    def main_vg_t(thetas, etas, betas):
        lv, lg = lik_vg(thetas, etas)
        rv, rg = prior_vg(thetas, etas)
        return rv + betas * lv, rg + betas[:, None] * lg

    def hyper_vg_t(etas, thetas, betas):
        rv, rg = hyper_rep_vg(etas, thetas)
        if likelihood.main_probs_in_hypers:
            lv, lg = hyper_lik_vg(etas, thetas)
            rv, rg = rv + betas * lv, rg + betas[:, None] * lg
        return rv, rg

    return Potentials(main, hyper, main_vg, hyper_vg, main_vg_t, hyper_vg_t,
                      lik_value)


def _combine(local_vg: Optional[Callable], rep_vg: Callable) -> Callable:
    """``vg(z, other)`` of ``local + rep``: the likelihood's part
    ``local_vg`` (already summed over the data peers, or None when the
    target has none) and the replicated prior part ``rep_vg``, each
    differentiated on its own so that the prior is counted once (the JAX
    package's ``_combine``, ``tensorbnn_tpu/sampler/potential.py:170``)."""

    def value_and_grad(z, other):
        rv, rg = rep_vg(z, other)
        if local_vg is None:
            return rv, rg
        lv, lg = local_vg(z, other)
        return lv + rv, lg + rg

    return value_and_grad
