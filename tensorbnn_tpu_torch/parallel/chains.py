"""Multi-chain runs on one device: state construction and the chunk runner.

Counterpart of ``init_multichain_state`` and the mesh-less
``make_multichain_chunk_runner`` of ``tensorbnn_tpu/parallel/chains.py``.
Chains batch as ``(C, D)`` blocks on one device; the chunk runner is a
Python loop over epochs whose per-epoch outputs stay on the device, so a
chunk enqueues its work without a host synchronization. Meshes (chains or
data sharded over several devices) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tensorbnn_tpu_torch.likelihoods import Likelihood
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochTrace, \
    make_epoch_fn


def init_multichain_state(theta, eta, hyper_step_size: float,
                          n_chains: int,
                          generator: Optional[torch.Generator] = None,
                          jitter: float = 0.0) -> ChainState:
    """A ChainState of ``n_chains`` copies of ``(theta, eta)`` on their
    device; with ``jitter > 0`` each chain's theta moves by N(0, jitter)
    noise drawn from ``generator`` (overdispersed starts)."""
    theta = theta.expand(n_chains, -1).clone()
    if jitter > 0:
        theta = theta + jitter * torch.randn(
            theta.shape, generator=generator, dtype=theta.dtype,
            device=theta.device)
    zeros = torch.zeros(n_chains, dtype=theta.dtype, device=theta.device)
    return ChainState(
        theta=theta, eta=eta.expand(n_chains, -1).clone(),
        hyper_step=torch.full_like(zeros, hyper_step_size),
        log_eps_bar=zeros, h=zeros.clone(), epoch=zeros.clone())


def make_multichain_chunk_runner(model: Sequential, likelihood: Likelihood,
                                 x, y, unravel_theta, unravel_eta, *,
                                 adjust_hypers: bool,
                                 hyper_leapfrog: int,
                                 burnin: float,
                                 hyper_step_size_init: float,
                                 eta_dim: Optional[int] = None,
                                 batched_main_vg=None,
                                 batched_main_traj=None,
                                 batched_hyper_traj=None,
                                 tempering_beta=None,
                                 record_uturn: bool = False,
                                 per_epoch_leapfrog: bool = False,
                                 data_chunk: Optional[int] = None,
                                 compensated: bool = False):
    """Builds ``run_chunk(carry, step_size, leapfrog, n_epochs, generator,
    step_scale=None) -> (carry, trace)``, the trace's fields stacked
    ``(n_epochs, C, ...)`` (``swap_accept`` None unless
    ``tempering_beta``, which the epoch takes as ``(n_rungs, per-chain
    betas)``; each epoch's swap parity comes from
    the carry's epoch counter on the device; ``uturn`` None unless
    ``record_uturn``).

    ``step_size`` is a float or a ``(C,)`` array; ``leapfrog`` an int or a
    ``(C,)`` integer array (per-chain-group adaptation). Both are moved to
    the chains' device once per chunk. With ``per_epoch_leapfrog``
    (``trajectory="uturn"``) ``leapfrog`` is instead a host ``(n_epochs,)``
    vector and epoch j runs the shared count ``leapfrog[j]``.

    ``data_chunk`` and ``compensated`` go to the epoch (the chunked
    likelihood, the Kahan leapfrog). ``step_scale``, the ``(D,)``
    diagonal-metric step multiplier on the chains' device, is an argument
    of each chunk, so the driver's windowed re-estimates swap in from one
    chunk to the next (the JAX runner's ``traced_step_scale`` exists to
    avoid a retrace, which eager torch does not have).
    """
    mu = math.log(100.0 * hyper_step_size_init)
    epoch_fn = make_epoch_fn(
        model, likelihood, x, y, unravel_theta, unravel_eta,
        adjust_hypers=adjust_hypers, hyper_leapfrog=hyper_leapfrog,
        burnin=burnin, mu=mu, batched_main_vg=batched_main_vg,
        batched_main_traj=batched_main_traj,
        batched_hyper_traj=batched_hyper_traj, eta_dim=eta_dim,
        tempering_beta=tempering_beta, record_uturn=record_uturn,
        data_chunk=data_chunk, compensated=compensated)

    def run_chunk(carry: ChainState, step_size, leapfrog, n_epochs: int,
                  generator: torch.Generator,
                  step_scale: Optional[torch.Tensor] = None):
        device = carry.theta.device
        leapfrog_dev = None
        if np.ndim(step_size) > 0:
            step_size = torch.as_tensor(np.asarray(step_size),
                                        dtype=carry.theta.dtype,
                                        device=device)
        if per_epoch_leapfrog:
            leaps = [int(n) for n in np.asarray(leapfrog).reshape(n_epochs)]
        else:
            if np.ndim(leapfrog) > 0:
                leapfrog = np.asarray(leapfrog, np.int64)
                leapfrog_dev = torch.as_tensor(leapfrog, dtype=torch.int32,
                                               device=device)
            leaps = [leapfrog] * n_epochs
        traces = []
        for leap in leaps:
            carry, trace = epoch_fn(carry, step_size, leap, generator,
                                    leapfrog_dev=leapfrog_dev,
                                    step_scale=step_scale)
            traces.append(trace)
        return carry, EpochTrace(*(None if f[0] is None else torch.stack(f)
                                   for f in zip(*traces)))

    return run_chunk
