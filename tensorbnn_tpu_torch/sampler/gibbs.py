"""Two-block Gibbs-within-HMC epoch step over a chain-batched state.

Counterpart of ``make_epoch_fn`` in ``tensorbnn_tpu/sampler/gibbs.py``
(flat layout). One epoch is a main HMC block over the weights given the
hypers, the squared jumping distance scaled by ``L ** -0.5`` for the GP-UCB
adapter, a hyper HMC block over the hypers given the new weights, and a
per-chain dual-averaging update of the hyper step size (target 0.95, gamma
0.4, t0 10, kappa 0.75, frozen from 80% of burn-in). Under parallel
tempering (``tempering_beta``) both blocks target the power posterior and
the epoch ends with a replica swap (sampler/tempering.py).

The main block runs through K1 (``batched_main_traj``) when the driver
built it, else through ``hmc_step_batched`` on K3's value and gradient
(``batched_main_vg``) or on the plain ``torch.func`` potential; the hyper
block runs through K2 (``batched_hyper_traj``) on the
sufficient-statistics potential when it applies. Randomness comes from one
``torch.Generator`` per run, drawn by ``draw_epoch`` at the epoch's start
in this order: main momenta, main MH coins, hyper momenta, hyper MH coins
and, only under tempering, the swap coins. An epoch can instead be handed
its draws (``EpochDraws``): the chunk runner hands each chain shard its
slice of the fleet's, and the tests feed it the JAX package's own.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tensorbnn_tpu_torch.likelihoods import Likelihood
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.sampler.hmc import Leap, Transition, draw_log_u, \
    hmc_step_batched, metropolis, transition_end, transition_start, \
    transition_step
from tensorbnn_tpu_torch.sampler.potential import make_potentials
from tensorbnn_tpu_torch.sampler.tempering import make_swap_fn

# Dual-averaging constants (reference network.py:241-248)
DA_TARGET = 0.95
DA_GAMMA = 0.4
DA_T0 = 10.0
DA_KAPPA = 0.75


class ChainState(NamedTuple):
    """Chain-batched sampler state; every field has a leading chain axis C.
    (The JAX package's per-chain PRNG keys are replaced by the run's
    ``torch.Generator``, which lives outside the state.)"""
    theta: torch.Tensor        # (C, D)
    eta: torch.Tensor          # (C, H)
    hyper_step: torch.Tensor   # (C,)
    log_eps_bar: torch.Tensor  # (C,) dual-averaging log step average
    h: torch.Tensor            # (C,) dual-averaging error accumulator
    epoch: torch.Tensor        # (C,) epoch counter (float)


class EpochTrace(NamedTuple):
    """Per-epoch outputs, per chain (stacked over epochs by the runner)."""
    theta: torch.Tensor        # (C, D)
    eta: torch.Tensor          # (C, H)
    sjd: torch.Tensor          # (C,)
    main_accept: torch.Tensor  # (C,)
    hyper_accept: torch.Tensor  # (C,)
    #: replica-swap indicator (1.0 where a chain exchanged state); None
    #: when tempering is off
    swap_accept: Optional[torch.Tensor] = None  # (C,)
    #: first U-turn step of the main trajectory, int32, 0 = censored; None
    #: unless ``record_uturn``
    uturn: Optional[torch.Tensor] = None  # (C,)


class EpochDraws(NamedTuple):
    """Injected randomness for one epoch."""
    main_momenta: torch.Tensor   # (C, D)
    main_log_u: torch.Tensor     # (C,)
    hyper_momenta: torch.Tensor  # (C, H)
    hyper_log_u: torch.Tensor    # (C,)
    swap_log_u: Optional[torch.Tensor] = None  # (C,), tempered runs only


def draw_epoch(generator: torch.Generator, c: int, d: int,
               h: Optional[int], dtype, device,
               tempered: bool) -> EpochDraws:
    """One epoch's draws for ``c`` chains from ``generator``, in the
    order above: main momenta ``(c, d)`` and coins, hyper momenta ``(c,
    h)`` and coins (``h`` None: the hyper block does not run), swap coins
    (``tempered``)."""
    like = torch.empty(0, dtype=dtype, device=device)
    main_mom = torch.randn((c, d), generator=generator, dtype=dtype,
                           device=device)
    main_log_u = draw_log_u(c, like, generator)
    h_mom = h_log_u = None
    if h is not None:
        h_mom = torch.randn((c, h), generator=generator, dtype=dtype,
                            device=device)
        h_log_u = draw_log_u(c, like, generator)
    swap_log_u = draw_log_u(c, like, generator) if tempered else None
    return EpochDraws(main_mom, main_log_u, h_mom, h_log_u, swap_log_u)


class Flight(NamedTuple):
    """An epoch between its head and its tail where K3 or the plain path
    runs the main block: the epoch's draws, the main transition's
    constants and its leapfrog state."""
    draws: EpochDraws
    main: Transition
    leap: Leap


class EpochParts(NamedTuple):
    """An epoch of the K3 or plain main block in three parts, which
    ``epoch_fn`` runs in turn and the stepped graph runner replays as one
    captured graph each:

    * ``head(carry, step_size, generator, draws=None, leapfrog_dev=None,
      step_scale=None) -> Flight``: the epoch's draws (unless given), the
      main block's first evaluation and half kick; ``leapfrog_dev`` the
      per-chain counts on the device (None: shared);
    * ``step(carry, flight) -> Leap``: one leapfrog step;
    * ``tail(carry, flight, sjd_steps) -> (carry, trace)``: the closing
      half kick and MH, the SJD (divided by ``sjd_steps``' square root, a
      count or a device ``(C,)`` tensor; None leaves it unscaled), the
      hyper block, dual averaging and the replica swap."""
    head: Callable
    step: Callable
    tail: Callable


def make_epoch_fn(model: Sequential, likelihood: Likelihood, x, y,
                  unravel_theta, unravel_eta, *,
                  adjust_hypers: bool,
                  hyper_leapfrog: int,
                  burnin: float,
                  mu: float,
                  batched_main_vg: Optional[Callable] = None,
                  batched_main_traj: Optional[Callable] = None,
                  batched_hyper_traj: Optional[Callable] = None,
                  eta_dim: Optional[int] = None,
                  tempering_beta=None,
                  record_uturn: bool = False,
                  data_chunk: Optional[int] = None,
                  compensated: bool = False,
                  peers=None) -> Callable:
    """Builds ``epoch_fn(carry, step_size, leapfrog, generator, draws=None,
    leapfrog_dev=None, step_scale=None, scale_sjd=True) -> (carry,
    trace)``.

    ``step_size`` is a float or a ``(C,)`` tensor on the chains' device.
    ``leapfrog`` is an int, or a ``(C,)`` host integer array in the
    driver's ``n_adapters`` mode; ``leapfrog_dev`` is then its device copy,
    made once per chunk by the runner so that an epoch never copies from
    the host (the plain path keeps the host array for its loop bound).
    ``scale_sjd=False`` leaves the trace's SJD unscaled: the graph runners
    (parallel/graphs.py) divide it by a shared count's square root after
    the replay, as a Python float, which a captured epoch cannot take.
    Where K3 or the plain path runs the main block, ``epoch_fn.parts`` is
    the epoch's ``EpochParts``, which ``epoch_fn`` runs: the head, one
    step a leapfrog step (to the largest count, from the host) and the
    tail; where K1 runs it, ``epoch_fn.parts`` is None.
    ``mu`` is the dual-averaging anchor ``log(100 * initial hyper step
    size)``. ``batched_main_vg`` is K3's ``f(thetas, etas, x, y) -> ((C,),
    (C, D))``; ``batched_main_traj`` K1's ``traj(thetas, etas, momenta, x,
    y, eps, L)``, which takes precedence; ``batched_hyper_traj`` K2's
    ``traj(etas, stats, momenta, eps)``.

    ``tempering_beta``: ``(n_rungs, betas)`` with the per-chain inverse
    temperatures ``betas (C,)`` rung-major, for parallel tempering. Both
    blocks then target ``prior + beta * loglik``: the main block through
    K1 built with ``tempered=True`` (it gets the betas as a trailing
    argument) or ``Potentials.main_vg_t``, never through K3, which bakes
    the untempered posterior; the hyper block through K2 when the
    likelihood is uncoupled (beta does not enter there), else through the
    tempered stats potential or ``Potentials.hyper_vg_t``. After the SJD
    and the hyper block, ``ll = loglik(theta, eta)`` feeds the even/odd
    replica swap, its parity from the epoch counter.

    ``record_uturn`` fills ``EpochTrace.uturn`` with each chain's first
    U-turn step (``trajectory="uturn"``): from K1's trailing output (the
    driver builds it with ``record_uturn=True``) or ``HMCResult.uturn``.
    It draws nothing more.

    ``data_chunk`` sums the plain path's likelihood (and the stats
    potential's residual power) over row chunks (sampler/potential.py).
    ``compensated`` runs the plain main block's leapfrog as Kahan sums
    (sampler/hmc.py); the hyper chain's O(1) state keeps the plain
    integrator. K1 integrates in its own program without the compensation
    carries, so the two together raise. ``step_scale`` ``(D,)``, an
    argument of each epoch, is the main block's diagonal-metric step
    multiplier (plain path only).

    ``peers`` (``parallel.mesh.DataPeers``) is the chain shard's data on a
    mesh: ``x``, ``y`` are then its first peer's rows, and with more than
    one peer the likelihood's value and gradient (plain or K3's), the
    stats' ``(R, K)`` and the tempered swap's log-likelihood are summed
    over the peers (the JAX package's data-axis psums). K1 cannot sum
    mid-trajectory, so a data mesh refuses it.
    """
    if peers is not None and len(peers) == 1:
        peers = None
    if peers is not None and batched_main_traj is not None:
        raise ValueError("a trajectory kernel cannot sum over the data "
                         "peers mid-trajectory; build without "
                         "batched_main_traj on a data mesh")
    if compensated and batched_main_traj is not None:
        raise ValueError("compensated leapfrog is handled by the plain "
                         "path; build without batched_main_traj")
    potentials = make_potentials(model, likelihood, x, y, unravel_theta,
                                 unravel_eta, data_chunk=data_chunk,
                                 peers=peers)
    stats_pair = None
    if adjust_hypers and eta_dim is not None:
        from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper
        stats_pair = make_stats_hyper(model, likelihood, x, y,
                                      unravel_theta, unravel_eta, eta_dim,
                                      data_chunk=data_chunk, peers=peers)
    tempered = tempering_beta is not None
    tempered_coupled = tempered and likelihood.main_probs_in_hypers
    if tempered:
        n_rungs, beta_full = tempering_beta
        beta_np = np.asarray(beta_full, np.float32)
        beta_c = torch.as_tensor(beta_np, dtype=x.dtype, device=x.device)
        swap_fn = make_swap_fn(
            torch.as_tensor(beta_np.reshape(n_rungs, -1)[:, 0],
                            dtype=x.dtype, device=x.device), n_rungs)

    def main_vg(eta):
        """The K3 or plain main block's value and gradient given ``eta``."""
        if tempered:
            return lambda ths: potentials.main_vg_t(ths, eta, beta_c)
        if batched_main_vg is not None:
            return lambda ths: batched_main_vg(ths, eta, x, y, peers=peers)
        return lambda ths: potentials.main_vg(ths, eta)

    def draws_of(carry, generator, draws):
        if draws is not None:
            return draws
        theta = carry.theta
        return draw_epoch(generator, *theta.shape,
                          carry.eta.shape[1] if adjust_hypers else None,
                          theta.dtype, theta.device, tempered)

    def head(carry, step_size, generator, draws=None, leapfrog_dev=None,
             step_scale=None) -> Flight:
        draws = draws_of(carry, generator, draws)
        tr, leap = transition_start(
            generator, carry.theta, main_vg(carry.eta), step_size,
            momenta=draws.main_momenta, log_u=draws.main_log_u,
            step_scale=step_scale, n_vec=leapfrog_dev,
            record_uturn=record_uturn, compensated=compensated)
        return Flight(draws, tr, leap)

    def step(carry, flight: Flight) -> Leap:
        return transition_step(main_vg(carry.eta), flight.main, flight.leap)

    def tail(carry, flight: Flight, sjd_steps):
        main = transition_end(flight.main, flight.leap)
        return finish(carry, main.position, main.accept_prob, main.uturn,
                      flight.draws, sjd_steps)

    def finish(carry, theta, main_accept, uturn, draws, sjd_steps):
        """The epoch after the main block's move to ``theta``."""
        eta = carry.eta
        # SJD scaled by L^(-1/2) (reference paramAdapter.py:219-222)
        dif = theta - carry.theta
        sjd = (dif * dif).sum(-1)
        if sjd_steps is not None:
            sjd = sjd / (torch.sqrt(sjd_steps.to(theta.dtype))
                         if torch.is_tensor(sjd_steps)
                         else math.sqrt(sjd_steps))

        hyper_step, log_eps_bar, h = (carry.hyper_step, carry.log_eps_bar,
                                      carry.h)
        hyper_accept = torch.zeros_like(sjd)
        if adjust_hypers:
            # -- hyper block: HMC over hypers given the new params ---------
            h_mom, h_log_u = draws.hyper_momenta, draws.hyper_log_u
            stats = stats_pair[0](theta) if stats_pair is not None else None
            if (batched_hyper_traj is not None and stats is not None
                    and not tempered_coupled):
                hq, hv, hlp0, hlp1 = batched_hyper_traj(eta, stats, h_mom,
                                                        hyper_step)
                hyper_accept, h_acc = metropolis(
                    hlp0, hlp1, 0.5 * (h_mom * h_mom).sum(-1),
                    0.5 * (hv * hv).sum(-1), h_log_u)
                eta = torch.where(h_acc[:, None], hq, eta)
            else:
                if stats is not None and tempered_coupled:
                    hyper_vg = lambda es: stats_pair[2](es, stats, beta_c)  # noqa: E731
                elif stats is not None:
                    hyper_vg = lambda es: stats_pair[1](es, stats)  # noqa: E731
                elif tempered:
                    hyper_vg = lambda es: potentials.hyper_vg_t(es, theta, beta_c)  # noqa: E731
                else:
                    hyper_vg = lambda es: potentials.hyper_vg(es, theta)  # noqa: E731
                hyper = hmc_step_batched(
                    None, eta, hyper_vg, hyper_step[:, None],
                    hyper_leapfrog, momenta=h_mom, log_u=h_log_u)
                eta, hyper_accept = hyper.position, hyper.accept_prob

            # -- dual averaging (reference network.py:457-469), per chain --
            m = carry.epoch + 1.0
            h = (1.0 - 1.0 / (m + DA_T0)) * h + \
                (1.0 / (m + DA_T0)) * (DA_TARGET - hyper_accept)
            log_eps = mu - h * torch.sqrt(m) / DA_GAMMA
            log_eps_bar = (1.0 - m ** (-DA_KAPPA)) * log_eps_bar + \
                m ** (-DA_KAPPA) * log_eps
            hyper_step = torch.where(m < burnin * 0.8,
                                     torch.exp(log_eps_bar), hyper_step)

        swapped = None
        if tempered:
            # -- replica swap; the SJD above saw the HMC move alone -------
            ll = potentials.loglik(theta, eta)
            # parity from the device-side epoch counter: no host sync
            parity = carry.epoch[0].to(torch.int64)
            theta, eta, swapped = swap_fn(theta, eta, ll, parity,
                                           draws.swap_log_u)

        new_carry = ChainState(theta=theta, eta=eta, hyper_step=hyper_step,
                               log_eps_bar=log_eps_bar, h=h,
                               epoch=carry.epoch + 1.0)
        return new_carry, EpochTrace(theta, eta, sjd, main_accept,
                                     hyper_accept, swapped, uturn)

    def epoch_fn(carry: ChainState, step_size, leapfrog, generator,
                 draws: Optional[EpochDraws] = None, leapfrog_dev=None,
                 step_scale: Optional[torch.Tensor] = None,
                 scale_sjd: bool = True):
        if leapfrog_dev is None and np.ndim(leapfrog) > 0:
            leapfrog_dev = torch.as_tensor(np.asarray(leapfrog),
                                           device=carry.theta.device)
        steps = leapfrog if leapfrog_dev is None else leapfrog_dev
        sjd_steps = steps if scale_sjd else None
        if batched_main_traj is None:
            flight = head(carry, step_size, generator, draws, leapfrog_dev,
                          step_scale)
            for _ in range(int(np.max(leapfrog))):
                flight = flight._replace(leap=step(carry, flight))
            return tail(carry, flight, sjd_steps)

        # -- main block through K1: HMC over params given the hypers -------
        draws = draws_of(carry, generator, draws)
        theta0, eta = carry.theta, carry.eta
        momenta, log_u = draws.main_momenta, draws.main_log_u
        q_new, v_new, lp0, lp1, *rec = batched_main_traj(
            theta0, eta, momenta, x, y, step_size, steps,
            *((beta_c,) if tempered else ()))
        main_accept, accepted = metropolis(
            lp0, lp1, 0.5 * (momenta * momenta).sum(-1),
            0.5 * (v_new * v_new).sum(-1), log_u)
        theta = torch.where(accepted[:, None], q_new, theta0)
        return finish(carry, theta, main_accept,
                      rec[0] if record_uturn else None, draws, sjd_steps)

    epoch_fn.parts = (None if batched_main_traj is not None
                      else EpochParts(head, step, tail))
    return epoch_fn
