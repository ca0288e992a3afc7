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

``compensated`` runs the drift and the kick as Kahan sums (``_kahan_add``),
for targets whose stable step size sits within a few ulps of the state
magnitude; ``step_scale`` is the diagonal-metric preconditioner. Eager
torch runs each operation of ``_kahan_add`` as its own IEEE kernel, which
keeps the compensation's order: nothing here may be ``torch.compile``d or
fused under fast-math, which would reassociate ``(t - s) - y`` to zero.
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


def _kahan_add(s, c, d):
    """One compensated accumulation step (Kahan 1965): the new rounded sum
    ``s + d`` and its carried rounding error, tracking the true sum to about
    twice the working precision. A plain float32 drift ``q + eps * v`` loses
    ``ulp(|q|)`` a step and freezes once ``|eps * v|`` falls below half an
    ulp; the 1M-point surrogate's posterior widths put eps there (the JAX
    package's ``sampler/hmc.py:_kahan_add``)."""
    y = d - c
    t = s + y
    return t, (t - s) - y


def _per_chain_steps(n_steps, device):
    """(host loop bound, device (C,) counts or None for a shared count)."""
    if np.ndim(n_steps) == 0:
        return int(n_steps), None
    n_host = np.asarray(n_steps, np.int64).reshape(-1)
    return int(n_host.max()), torch.as_tensor(n_host, device=device)


def leapfrog_batched(vg_fn: Callable, positions: torch.Tensor,
                     momenta: torch.Tensor, step_size, n_steps,
                     start: Optional[tuple] = None,
                     record_uturn: bool = False,
                     uturn_inv_scale: Optional[torch.Tensor] = None,
                     compensated: bool = False) -> tuple:
    """Half-kick / full-drift leapfrog on ``(C, D)`` blocks; ``n_steps + 1``
    value-and-grad evaluations, the first of them ``start`` when the caller
    has ``vg_fn(positions)`` already. ``step_size`` is a float, a scalar
    tensor, a ``(C, 1)`` column or a ``(C or 1, D)`` per-coordinate step.
    Returns ``(q, v, log_prob, grad)`` at the endpoint.

    ``record_uturn`` appends each chain's first U-turn step, ``(C,)``
    int32: the 1-based loop iteration i where ``(q_i - q_0) . v_{i+1/2} <
    0`` after the iteration's full kick (the NUTS criterion on one forward
    trajectory), 0 when the chain never turned within its own count. With
    ``uturn_inv_scale`` ``(D,)`` (``1 / step_scale``) the displacement is
    divided by the metric's scale first, so the check runs where the
    momenta are isotropic.

    ``compensated`` carries the rounding error of every drift and kick
    (``_kahan_add``); a chain past its own count keeps ``(q, cq, v, cv)``
    by gating the outputs, not the increment, so a pending compensation
    never leaks into a frozen chain."""
    lp, g = vg_fn(positions) if start is None else start
    v = momenta + 0.5 * step_size * g
    q = positions
    cap, n_vec = _per_chain_steps(n_steps, positions.device)
    ut = torch.zeros(positions.shape[0], dtype=torch.int32,
                     device=positions.device)
    if compensated:
        cq = torch.zeros_like(q)
        cv = torch.zeros_like(v)
    if uturn_inv_scale is not None:
        uturn_inv_scale = uturn_inv_scale.reshape(1, -1)
    for i in range(cap):
        act = None if n_vec is None else (i < n_vec)[:, None]
        if compensated:
            qn, cqn = _kahan_add(q, cq, step_size * v)
            q, cq = (qn, cqn) if act is None else (
                torch.where(act, qn, q), torch.where(act, cqn, cq))
            lp, g = vg_fn(q)
            vn, cvn = _kahan_add(v, cv, step_size * g)
            v, cv = (vn, cvn) if act is None else (
                torch.where(act, vn, v), torch.where(act, cvn, cv))
        elif act is None:
            q = q + step_size * v
            lp, g = vg_fn(q)
            v = v + step_size * g
        else:
            # frozen chains drift and kick by zero; vg_fn re-evaluates at
            # the unchanged position, so their endpoint (lp, g) stays exact
            q = q + torch.where(act, step_size * v, 0.0)
            lp, g = vg_fn(q)
            v = v + torch.where(act, step_size * g, 0.0)
        if record_uturn:
            d = q - positions
            if uturn_inv_scale is not None:
                d = d * uturn_inv_scale
            turned = (ut == 0) & ((d * v).sum(-1) < 0)
            if act is not None:
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
                     step_scale: Optional[torch.Tensor] = None,
                     record_uturn: bool = False,
                     compensated: bool = False) -> HMCResult:
    """One HMC transition over a ``(C, D)`` chain block.

    ``momenta`` (C, D) and ``log_u`` (C,) are drawn from ``generator``
    unless given. ``step_size`` may be a float, ``(C,)`` or ``(C, 1)``.
    ``step_scale`` ``(D,)`` multiplies the step per coordinate: leapfrog
    with ``eps_i = eps * s_i`` under unit-normal momenta is HMC with the
    diagonal mass ``1 / s_i ** 2`` (Stan's diag_e metric), so the MH test
    is unchanged; the U-turn check then takes ``1 / step_scale``.
    ``record_uturn`` fills ``HMCResult.uturn`` and ``compensated`` runs the
    Kahan leapfrog (see ``leapfrog_batched``).
    """
    if torch.is_tensor(step_size) and step_size.ndim == 1:
        step_size = step_size[:, None]
    inv_scale = None
    if step_scale is not None:
        step_size = step_size * step_scale.reshape(1, -1)
        if record_uturn:
            inv_scale = 1.0 / step_scale.reshape(-1)
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
        record_uturn=record_uturn, uturn_inv_scale=inv_scale,
        compensated=compensated)
    accept_prob, accepted = metropolis(
        lp0, lp1, 0.5 * (momenta * momenta).sum(-1),
        0.5 * (v_new * v_new).sum(-1), log_u)
    return HMCResult(torch.where(accepted[:, None], q_new, positions),
                     torch.where(accepted, lp1, lp0), accept_prob, accepted,
                     uturn[0] if uturn else None)
