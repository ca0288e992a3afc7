"""Chain-batched HMC: leapfrog integrator and one HMC transition.

Counterpart of ``leapfrog_batched`` and ``hmc_step_batched`` in
``tensorbnn_tpu/sampler/hmc.py``, on ``(C, D)`` chain blocks with a
``vg_fn(positions) -> ((C,), (C, D))`` oracle. This is the plain path that
models outside the fused kernels' scope take, and the oracle the tests
hold the kernels' twins against.

Step size and leapfrog count are shared (a float and an int) or per chain
(a ``(C,)`` tensor and a ``(C,)`` host integer array). Per-chain counts run
the loop to the largest count with finished chains mask-frozen; the count
stays on the host so the loop bound costs no device sync. A transition is
three parts, a start, a step and an end (``transition_start``,
``transition_step``, ``transition_end``), each reading from the host
nothing but its loop bound: a step takes its index from a device counter
that it advances. The eager loop runs them, and the stepped graph runner
(parallel/graphs.py) replays a captured graph of each. Momenta and the
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


class Leap(NamedTuple):
    """The leapfrog's state between two steps: position, momentum, the
    value and gradient at the position, the Kahan carries
    (``compensated``), each chain's first U-turn step (``record_uturn``)
    and the steps taken so far, a 0-d int32 device counter (kept where
    per-chain counts or ``record_uturn`` read it). A field a mode does not
    use is None. The start copies the position, so that a step may update
    ``q`` and ``v`` in place (its other fields are new tensors); a step
    reads neither ``lp`` nor ``g``."""
    q: torch.Tensor
    v: torch.Tensor
    lp: torch.Tensor
    g: torch.Tensor
    cq: Optional[torch.Tensor] = None
    cv: Optional[torch.Tensor] = None
    ut: Optional[torch.Tensor] = None
    i: Optional[torch.Tensor] = None


def leapfrog_start(positions, momenta, step_size, start: tuple, *,
                   counted: bool, record_uturn: bool,
                   compensated: bool) -> Leap:
    """The leapfrog's first half kick from ``start = (lp, g)`` at
    ``positions``, a copy of the positions, and zeroed carries, U-turn
    record and counter."""
    lp, g = start
    v = momenta + 0.5 * step_size * g
    ut = cq = cv = i = None
    if record_uturn:
        ut = torch.zeros(positions.shape[0], dtype=torch.int32,
                         device=positions.device)
    if compensated:
        cq = torch.zeros_like(positions)
        cv = torch.zeros_like(v)
    if counted:
        i = torch.zeros((), dtype=torch.int32, device=positions.device)
    return Leap(positions.clone(), v, lp, g, cq, cv, ut, i)


def leapfrog_step(vg_fn: Callable, positions, leap: Leap, step_size,
                  n_vec: Optional[torch.Tensor] = None,
                  uturn_inv_scale: Optional[torch.Tensor] = None,
                  record_uturn: bool = False,
                  compensated: bool = False) -> Leap:
    """One full drift and kick from ``leap``; with per-chain counts
    ``n_vec`` a chain past its own count stays where it is. Its index is
    the state's device counter, which it advances, so a step reads nothing
    from the host. The plain integrator adds the drift and the kick to
    ``q`` and ``v`` in place (the same roundings as ``q + d``); the Kahan
    one returns new tensors."""
    q, v, lp, g, cq, cv, ut, i = leap
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
        q.add_(step_size * v)
        lp, g = vg_fn(q)
        v.add_(step_size * g)
    else:
        # frozen chains drift and kick by zero; vg_fn re-evaluates at
        # the unchanged position, so their endpoint (lp, g) stays exact
        q.add_(torch.where(act, step_size * v, 0.0))
        lp, g = vg_fn(q)
        v.add_(torch.where(act, step_size * g, 0.0))
    if i is not None:
        i = i + 1
    if record_uturn:
        d = q - positions
        if uturn_inv_scale is not None:
            d = d * uturn_inv_scale
        turned = (ut == 0) & ((d * v).sum(-1) < 0)
        if act is not None:
            turned &= act[:, 0]
        ut = torch.where(turned, i, ut)
    return Leap(q, v, lp, g, cq, cv, ut, i)


def leapfrog_end(leap: Leap, step_size) -> torch.Tensor:
    """The closing half kick: the momentum at the endpoint."""
    return leap.v - 0.5 * step_size * leap.g


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
    Returns ``(q, v, log_prob, grad)`` at the endpoint. It runs
    ``leapfrog_start``, ``n_steps`` (the largest count) ``leapfrog_step``
    and ``leapfrog_end``, the parts a graph runner replays one by one.

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
    start = vg_fn(positions) if start is None else start
    cap, n_vec = _per_chain_steps(n_steps, positions.device)
    leap = leapfrog_start(positions, momenta, step_size, start,
                          counted=n_vec is not None or record_uturn,
                          record_uturn=record_uturn, compensated=compensated)
    if uturn_inv_scale is not None:
        uturn_inv_scale = uturn_inv_scale.reshape(1, -1)
    for _ in range(cap):
        leap = leapfrog_step(vg_fn, positions, leap, step_size, n_vec,
                             uturn_inv_scale, record_uturn, compensated)
    v = leapfrog_end(leap, step_size)
    if record_uturn:
        return leap.q, v, leap.lp, leap.g, leap.ut
    return leap.q, v, leap.lp, leap.g


def metropolis(lp0, lp1, kinetic0, kinetic1, log_u):
    """``(accept_prob, accepted)`` of the MH test; a NaN log-accept ratio
    (a diverged trajectory) always rejects."""
    lar = (lp1 - lp0) + (kinetic0 - kinetic1)
    lar = torch.where(torch.isnan(lar), -torch.inf, lar)
    return torch.clamp(torch.exp(lar), max=1.0), log_u < lar


def draw_log_u(n: int, like: torch.Tensor, generator) -> torch.Tensor:
    return torch.log(torch.rand(n, generator=generator, dtype=like.dtype,
                                device=like.device))


class Transition(NamedTuple):
    """What an HMC transition's leapfrog steps and its end read, fixed at
    its start (``transition_start``): the start position, momenta and MH
    coin, the step (a float, a ``(C, 1)`` column or ``(C or 1, D)`` with a
    step scale), the start's value, per-chain counts (None: shared) and the
    U-turn check's inverse scale ``(1, D)`` (None: unscaled)."""
    positions: torch.Tensor
    momenta: torch.Tensor
    log_u: torch.Tensor
    step_size: object
    lp0: torch.Tensor
    n_vec: Optional[torch.Tensor]
    inv_scale: Optional[torch.Tensor]
    record_uturn: bool
    compensated: bool


def transition_start(generator: Optional[torch.Generator],
                     positions: torch.Tensor, vg_fn: Callable, step_size,
                     momenta: Optional[torch.Tensor] = None,
                     log_u: Optional[torch.Tensor] = None,
                     step_scale: Optional[torch.Tensor] = None,
                     n_vec: Optional[torch.Tensor] = None,
                     record_uturn: bool = False,
                     compensated: bool = False) -> tuple:
    """An HMC transition's head: its draws (unless given), the evaluation
    at the start and the first half kick. Returns ``(Transition, Leap)``;
    ``n_vec`` is the device copy of per-chain counts (None: shared)."""
    if torch.is_tensor(step_size) and step_size.ndim == 1:
        step_size = step_size[:, None]
    inv_scale = None
    if step_scale is not None:
        step_size = step_size * step_scale.reshape(1, -1)
        if record_uturn:
            inv_scale = (1.0 / step_scale.reshape(-1)).reshape(1, -1)
    if momenta is None:
        momenta = torch.randn(positions.shape, generator=generator,
                              dtype=positions.dtype, device=positions.device)
    if log_u is None:
        log_u = draw_log_u(positions.shape[0], positions, generator)
    # one evaluation at the start serves both the MH test and the first
    # half kick (the JAX package's jit merges the two; eager torch would
    # run both)
    lp0, g0 = vg_fn(positions)
    leap = leapfrog_start(positions, momenta, step_size, (lp0, g0),
                          counted=n_vec is not None or record_uturn,
                          record_uturn=record_uturn, compensated=compensated)
    return (Transition(positions, momenta, log_u, step_size, lp0, n_vec,
                       inv_scale, record_uturn, compensated), leap)


def transition_step(vg_fn: Callable, tr: Transition, leap: Leap) -> Leap:
    """One leapfrog step of the transition ``tr``."""
    return leapfrog_step(vg_fn, tr.positions, leap, tr.step_size, tr.n_vec,
                         tr.inv_scale, tr.record_uturn, tr.compensated)


def transition_end(tr: Transition, leap: Leap) -> HMCResult:
    """The closing half kick and the MH test."""
    v_new = leapfrog_end(leap, tr.step_size)
    accept_prob, accepted = metropolis(
        tr.lp0, leap.lp, 0.5 * (tr.momenta * tr.momenta).sum(-1),
        0.5 * (v_new * v_new).sum(-1), tr.log_u)
    return HMCResult(torch.where(accepted[:, None], leap.q, tr.positions),
                     torch.where(accepted, leap.lp, tr.lp0), accept_prob,
                     accepted, leap.ut)


def hmc_step_batched(generator: Optional[torch.Generator],
                     positions: torch.Tensor, vg_fn: Callable,
                     step_size, n_leapfrog,
                     momenta: Optional[torch.Tensor] = None,
                     log_u: Optional[torch.Tensor] = None,
                     step_scale: Optional[torch.Tensor] = None,
                     record_uturn: bool = False,
                     compensated: bool = False) -> HMCResult:
    """One HMC transition over a ``(C, D)`` chain block:
    ``transition_start``, one ``transition_step`` a leapfrog step (to the
    largest count) and ``transition_end``.

    ``momenta`` (C, D) and ``log_u`` (C,) are drawn from ``generator``
    unless given. ``step_size`` may be a float, ``(C,)`` or ``(C, 1)``.
    ``n_leapfrog`` is an int or a ``(C,)`` host array. ``step_scale``
    ``(D,)`` multiplies the step per coordinate: leapfrog with ``eps_i =
    eps * s_i`` under unit-normal momenta is HMC with the diagonal mass
    ``1 / s_i ** 2`` (Stan's diag_e metric), so the MH test is unchanged;
    the U-turn check then takes ``1 / step_scale``. ``record_uturn`` fills
    ``HMCResult.uturn`` and ``compensated`` runs the Kahan leapfrog (see
    ``leapfrog_batched``).
    """
    cap, n_vec = _per_chain_steps(n_leapfrog, positions.device)
    tr, leap = transition_start(generator, positions, vg_fn, step_size,
                                momenta, log_u, step_scale, n_vec,
                                record_uturn, compensated)
    for _ in range(cap):
        leap = transition_step(vg_fn, tr, leap)
    return transition_end(tr, leap)
