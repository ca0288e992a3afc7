"""Multi-chain runs: state construction and the chunk runner, on one
device or over a ``(chains, data)`` mesh.

Counterpart of ``init_multichain_state`` and
``make_multichain_chunk_runner`` of ``tensorbnn_tpu/parallel/chains.py``.
Chains batch as ``(C, D)`` blocks. On CUDA devices of one kind, without
a mesh or over any ``(chains, data)`` mesh of them, a chunk runs as
captured CUDA graphs on each chain shard's home card, the port of the JAX
package's compiled (``shard_map``) chunk (parallel/graphs.py): a graph of
the chunk where K1 runs the main block (a data axis of 1: K1 cannot sum
over data peers), a head, a step and a tail graph of the epoch where K3 or
the plain path does, each split at its sums over the data peers where the
data axis is above 1. Else (cards of two kinds, K3's workspace over the
gate, the CPU) the chunk runner is a Python loop over epochs (the eager
runner) whose per-epoch outputs stay on the device, so a chunk enqueues
its work without a host synchronization.

One runner serves every run: without a mesh it runs a 1x1 mesh of the
data's device. Over a ``(chains, data)`` mesh (parallel/mesh.py) the
chains split over the ``chains`` axis, a block a mesh row, and the rows
over the ``data`` axis; each chain shard runs its own epoch, whose
likelihood terms are summed over the row's data peers. The fleet's draws
are made once an epoch on the mesh's first device (``draw_epoch``, the
order every epoch draws in) and each shard takes its slice (the graph
runner draws the fleet's epoch on each shard's card from the same
generator state), so a chains-only mesh reproduces the mesh-less run from
the same generator. The carry and the traces are gathered in chain order
on the first device: the driver sees the arrays it sees without a mesh.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tensorbnn_tpu_torch.likelihoods import Likelihood
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.parallel.graphs import GraphChunkRunner, \
    SteppedChunkRunner, chunk_runner_kind, whole_chunk
from tensorbnn_tpu_torch.parallel.mesh import CHAIN_AXIS, DataPeers, Mesh, \
    gather
from tensorbnn_tpu_torch.sampler.gibbs import ChainState, EpochTrace, \
    draw_epoch, make_epoch_fn


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


def check_tempering_mesh(mesh) -> None:
    """Tempering needs a chains axis of 1 (the JAX driver's check and
    message): its swaps pair rung blocks across the chains axis."""
    if mesh is not None and mesh.shape[CHAIN_AXIS] > 1:
        raise ValueError(
            "tempering requires the mesh chains axis to be 1: "
            "replica swaps pair rung blocks across the chain "
            "axis and would straddle chain shards (ppermute "
            "extension path documented in parallel/chains.py). "
            "Data-parallel tempering (chains axis 1, data axis "
            "> 1) is supported — replicas are whole on every "
            "data shard and the psum'd log-likelihood makes "
            "swap decisions shard-consistent")


def _shard(value, homes: list) -> list:
    """A tensor's chains (or None) split in order, a block on each home;
    with one home, the tensor itself."""
    if value is None or len(homes) == 1:
        return [value] * len(homes)
    return [block.to(hd, non_blocking=True)
            for block, hd in zip(value.chunk(len(homes)), homes)]


def _shard_tuple(value, homes: list) -> list:
    """A NamedTuple of chain-major tensors split field by field."""
    return [type(value)(*fields)
            for fields in zip(*(_shard(f, homes) for f in value))]


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
                                 compensated: bool = False,
                                 mesh=None,
                                 eager: bool = False,
                                 n_chains: Optional[int] = None):
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

    ``mesh`` (parallel/mesh.py; None runs a 1x1 mesh of ``x``'s device):
    the rows split over each mesh row's data peers once, here.
    ``run_chunk`` takes and returns the whole fleet's carry on the first
    device. It splits the carry over the chain shards at the chunk's start
    (a block on each mesh row's first device), gives each shard its slice
    of per-chain ``step_size`` / ``leapfrog`` vectors (a U-turn run's
    per-epoch counts are shared) and of each epoch's draws, and gathers the
    carry and the traces in chain order at the chunk's end. Tempering needs
    a chains axis of 1 (``check_tempering_mesh``).

    ``chunk_runner_kind`` picks the runner from the configuration (CUDA
    devices of one kind for either graph runner, parallel/graphs.py):
    where K1 runs the main block a ``GraphChunkRunner`` (a graph a chain
    shard on its home; K1 takes no data mesh), where K3 or the plain path
    does a ``SteppedChunkRunner`` (a head, a step and a tail graph a chain
    shard, split at the sums over its data peers on a data axis above 1)
    unless K3's workspace at ``n_chains`` (the fleet; None: not gated) on
    a peer's rows fails ``stepped_fits``; else the eager loop.
    Both graph runners have the loop's signature and give its results bit
    for bit. The runner's ``runner`` attribute says which ("graph",
    "stepped" or "eager"). ``eager`` keeps the eager loop where a graph
    would apply (the runners' comparisons on the card; the driver never
    sets it).
    """
    if tempering_beta is not None:
        check_tempering_mesh(mesh)
    workspace = 0
    if n_chains is not None and batched_main_vg is not None:
        shards = 1 if mesh is None else mesh.shape[CHAIN_AXIS]
        workspace = batched_main_vg.workspace_bytes(n_chains // shards)
    kind = "eager" if eager else chunk_runner_kind(
        batched_main_traj, mesh, x.device, workspace)
    mu = math.log(100.0 * hyper_step_size_init)
    if mesh is None:
        mesh = Mesh([[x.device]])
    shards = [DataPeers.split(row, x, y) for row in mesh.devices]
    epoch_fns = [make_epoch_fn(
        model, likelihood, *p.shards[0], unravel_theta, unravel_eta,
        adjust_hypers=adjust_hypers, hyper_leapfrog=hyper_leapfrog,
        burnin=burnin, mu=mu, batched_main_vg=batched_main_vg,
        batched_main_traj=batched_main_traj,
        batched_hyper_traj=batched_hyper_traj, eta_dim=eta_dim,
        tempering_beta=tempering_beta, record_uturn=record_uturn,
        data_chunk=data_chunk, compensated=compensated, peers=p)
        for p in shards]
    homes = [p.home for p in shards]
    first = homes[0]
    h = eta_dim if adjust_hypers else None
    tempered = tempering_beta is not None
    if kind == "graph":
        return GraphChunkRunner(
            epoch_fns, homes, h=h, tempered=tempered,
            per_epoch_leapfrog=per_epoch_leapfrog,
            whole=whole_chunk(adjust_hypers, batched_hyper_traj))
    if kind == "stepped":
        return SteppedChunkRunner(
            epoch_fns, homes, h=h, tempered=tempered,
            per_epoch_leapfrog=per_epoch_leapfrog, n_chains=n_chains,
            peers=shards)

    def run_chunk(carry: ChainState, step_size, leapfrog, n_epochs: int,
                  generator: torch.Generator,
                  step_scale: Optional[torch.Tensor] = None):
        c, d = carry.theta.shape
        dtype = carry.theta.dtype
        # per-chain vectors reach the first device once a chunk, and each
        # shard its slice from there, so no shard waits on the host
        steps = [step_size] * len(homes)
        if np.ndim(step_size) > 0:
            steps = _shard(torch.as_tensor(np.asarray(step_size),
                                           dtype=dtype, device=first), homes)
        leap_devs = [None] * len(homes)
        if per_epoch_leapfrog:
            leaps = [[int(n) for n in np.asarray(leapfrog).reshape(
                n_epochs)]] * len(homes)
        elif np.ndim(leapfrog) > 0:
            leap_np = np.asarray(leapfrog, np.int64)
            leaps = [[block] * n_epochs
                     for block in np.split(leap_np, len(homes))]
            leap_devs = _shard(torch.as_tensor(leap_np, dtype=torch.int32,
                                               device=first), homes)
        else:
            leaps = [[leapfrog] * n_epochs] * len(homes)
        scales = [None if step_scale is None
                  else step_scale.to(hd, non_blocking=True) for hd in homes]
        states = _shard_tuple(carry, homes)
        traces = [[] for _ in homes]
        for j in range(n_epochs):
            draws = _shard_tuple(draw_epoch(generator, c, d, h, dtype, first,
                                            tempered), homes)
            for i, epoch_fn in enumerate(epoch_fns):
                states[i], trace = epoch_fn(
                    states[i], steps[i], leaps[i][j], generator,
                    draws=draws[i], leapfrog_dev=leap_devs[i],
                    step_scale=scales[i])
                traces[i].append(trace)
            # drop the epoch's draws with it: the last (C, D) momenta would
            # otherwise be alive while the traces are stacked (the peak)
            draws = None
        # the whole fleet on the first device, traces (n_epochs, C, ...)
        return ChainState(*(gather(list(f)) for f in zip(*states))), \
            EpochTrace(*(None if f[0][0] is None else
                         gather([torch.stack(t) for t in f], dim=1)
                         for f in zip(*(zip(*t) for t in traces))))

    run_chunk.runner = "eager"
    return run_chunk
