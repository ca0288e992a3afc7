"""Chain-batched HMC: leapfrog integrator and one HMC transition.

Counterpart of ``leapfrog_batched`` and ``hmc_step_batched`` in
``tensorbnn_tpu/sampler/hmc.py``, on ``(C, D)`` chain blocks with a
``vg_fn(positions) -> ((C,), (C, D))`` oracle. This is the plain path that
models outside the fused kernels' scope take, and the oracle the tests
hold the kernels' twins against.

Step size and leapfrog count are shared (a float and an int) or per chain
(a ``(C,)`` tensor and a ``(C,)`` host integer array). Per-chain counts run
the loop to the largest count with finished chains mask-frozen; the count
stays on the host so the loop bound costs no device sync. Momenta and the
Metropolis coins come from a ``torch.Generator``, or are passed in, which
lets a test feed the JAX package's own draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class HMCResult(NamedTuple):
    position: torch.Tensor     # (C, D)
    log_prob: torch.Tensor     # (C,)
    accept_prob: torch.Tensor  # (C,) min(1, exp(log_accept_ratio))
    accepted: torch.Tensor     # (C,) bool
    #: (C,) int32 first U-turn step (0 = censored) with ``record_uturn``
    uturn: Optional[torch.Tensor] = None


def _per_chain_steps(n_steps, device):
    """(host loop bound, device (C,) counts or None for a shared count)."""
    if np.ndim(n_steps) == 0:
        return int(n_steps), None
    n_host = np.asarray(n_steps, np.int64).reshape(-1)
    return int(n_host.max()), torch.as_tensor(n_host, device=device)


def leapfrog_batched(vg_fn: Callable, positions: torch.Tensor,
                     momenta: torch.Tensor, step_size, n_steps,
                     start: Optional[tuple] = None,
                     record_uturn: bool = False) -> tuple:
    """Half-kick / full-drift leapfrog on ``(C, D)`` blocks; ``n_steps + 1``
    value-and-grad evaluations, the first of them ``start`` when the caller
    has ``vg_fn(positions)`` already. ``step_size`` is a float, a scalar
    tensor or a ``(C, 1)`` column. Returns ``(q, v, log_prob, grad)`` at
    the endpoint.

    ``record_uturn`` appends each chain's first U-turn step, ``(C,)``
    int32: the 1-based loop iteration i where ``(q_i - q_0) . v_{i+1/2} <
    0`` after the iteration's full kick (the NUTS criterion on one forward
    trajectory), 0 when the chain never turned within its own count."""
    lp, g = vg_fn(positions) if start is None else start
    v = momenta + 0.5 * step_size * g
    q = positions
    cap, n_vec = _per_chain_steps(n_steps, positions.device)
    ut = torch.zeros(positions.shape[0], dtype=torch.int32,
                     device=positions.device)
    for i in range(cap):
        if n_vec is None:
            q = q + step_size * v
            lp, g = vg_fn(q)
            v = v + step_size * g
        else:
            # frozen chains drift and kick by zero; vg_fn re-evaluates at
            # the unchanged position, so their endpoint (lp, g) stays exact
            act = (i < n_vec)[:, None]
            q = q + torch.where(act, step_size * v, 0.0)
            lp, g = vg_fn(q)
            v = v + torch.where(act, step_size * g, 0.0)
        if record_uturn:
            turned = (ut == 0) & (((q - positions) * v).sum(-1) < 0)
            if n_vec is not None:
                turned &= act[:, 0]
            ut = torch.where(turned, i + 1, ut)
    v = v - 0.5 * step_size * g
    if record_uturn:
        return q, v, lp, g, ut
    return q, v, lp, g


def metropolis(lp0, lp1, kinetic0, kinetic1, log_u):
    """``(accept_prob, accepted)`` of the MH test; a NaN log-accept ratio
    (a diverged trajectory) always rejects."""
    lar = (lp1 - lp0) + (kinetic0 - kinetic1)
    lar = torch.where(torch.isnan(lar), -torch.inf, lar)
    return torch.clamp(torch.exp(lar), max=1.0), log_u < lar


def draw_log_u(n: int, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.log(torch.rand(n, generator=generator, dtype=like.dtype,
                                device=like.device))


def hmc_step_batched(generator: Optional[torch.Generator],
                     positions: torch.Tensor, vg_fn: Callable,
                     step_size, n_leapfrog,
                     momenta: Optional[torch.Tensor] = None,
                     log_u: Optional[torch.Tensor] = None,
                     record_uturn: bool = False) -> HMCResult:
    """One HMC transition over a ``(C, D)`` chain block.

    ``momenta`` (C, D) and ``log_u`` (C,) are drawn from ``generator``
    unless given. ``step_size`` may be a float, ``(C,)`` or ``(C, 1)``.
    ``record_uturn`` fills ``HMCResult.uturn`` (see ``leapfrog_batched``).
    """
    if torch.is_tensor(step_size) and step_size.ndim == 1:
        step_size = step_size[:, None]
    if momenta is None:
        momenta = torch.randn(positions.shape, generator=generator,
                              dtype=positions.dtype, device=positions.device)
    if log_u is None:
        log_u = draw_log_u(positions.shape[0], positions, generator)
    # one evaluation at the start serves both the MH test and the first
    # half kick (the JAX package's jit merges the two; eager torch would
    # run both)
    lp0, g0 = vg_fn(positions)
    q_new, v_new, lp1, _, *uturn = leapfrog_batched(
        vg_fn, positions, momenta, step_size, n_leapfrog, start=(lp0, g0),
        record_uturn=record_uturn)
    accept_prob, accepted = metropolis(
        lp0, lp1, 0.5 * (momenta * momenta).sum(-1),
        0.5 * (v_new * v_new).sum(-1), log_u)
    return HMCResult(torch.where(accepted[:, None], q_new, positions),
                     torch.where(accepted, lp1, lp0), accept_prob, accepted,
                     uturn[0] if uturn else None)
