"""NUTS-style dynamic trajectory lengths, redesigned for batched HMC.

A copy of ``tensorbnn_tpu/sampler/uturn.py`` (numpy only), held equal to
it by tests/test_torch_uturn.py; the port's driver runs it for
``trajectory="uturn"``. The U-turn step itself is recorded by
``leapfrog_batched(record_uturn=True)`` (sampler/hmc.py) or inside K1
(ops/fused_mlp.py, csrc/fused_trajectory.cu).

NUTS (Hoffman & Gelman 2014) picks each chain's trajectory length by
recursive tree doubling with per-chain data-dependent control flow — a
shape-hostile pattern on a TPU, where the whole chain fleet integrates as
one ``(C, D)`` wave front and divergent per-chain programs would serialize
the MXU/VPU work (the reference has no dynamic trajectories at all; its
tfp HMC kernel runs a fixed leapfrog count per epoch, network.py:394-408).

This module keeps the wave front and moves the dynamics to the *schedule*,
following empirical HMC (eHMC; Wu, Stoehr & Robert, arXiv:1810.04449):

* during burn-in, every trajectory records the step at which it first
  U-turns away from its start — the NUTS stopping criterion
  ``(q_i - q_0) . v_i < 0`` evaluated inside the ordinary leapfrog loop
  (one elementwise multiply+reduce per step, ~free next to the gradient);
  censored trajectories (no U-turn within the executed length) grow the
  next chunk's length geometrically until U-turns are observed;
* the observed U-turn lengths fill a rolling reservoir; after burn-in
  each epoch draws its trajectory length from that empirical
  distribution (a randomized-length HMC kernel — a mixture of valid
  fixed-length kernels, so detailed balance holds), shared by all chains
  so the fleet stays one batch;
* the step size is tuned toward a target acceptance of 0.8 by
  stochastic approximation on ``log eps`` (Robbins-Monro, the
  Andrieu & Thoms 2008 "Algorithm 4" controller), one update per
  *chunk* on the chunk's fleet-mean acceptance, frozen at its
  Polyak-style average when burn-in ends. Per-chunk — not per-epoch —
  updates matter here: the driver holds eps fixed across a dispatched
  chunk, and replaying Stan's per-iteration dual averaging against that
  stale feedback integrates the same error ``chunk`` times and slams
  the step size rail-to-rail (measured: eps oscillating between the
  grid bounds every boundary, final acceptance 0.9999). One update per
  chunk sees an 80-plus-sample acceptance estimate with bounded gain —
  smooth convergence in the same number of boundary crossings.

Both the per-epoch lengths and the step size are *traced* values of the
compiled chunk runner, so none of this ever recompiles.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

# Robbins-Monro controller constants. Target matches Stan's default
# HMC/NUTS acceptance goal; gain/decay sized so the first chunks can move
# eps ~5x each while the tail settles (see class docstring for why this
# is per-chunk stochastic approximation, not per-epoch dual averaging).
UT_TARGET = 0.8
RM_GAIN = 1.5
RM_DECAY = 0.6
UT_KAPPA = 0.75

#: rolling reservoir size; late-burn-in (well-adapted) lengths displace
#: early ones
RESERVOIR_CAP = 4096
#: growth factor applied while trajectories are censored (no U-turn seen)
GROW = 1.5


class UTurnAdapter:
    """Host-side schedule for the ``trajectory="uturn"`` driver mode.

    Replays per-epoch cross-chain acceptance means through dual averaging
    (step size) and per-chain U-turn lengths into a reservoir (trajectory
    length), at chunk boundaries — the same host-replay pattern as the
    GP-UCB adapter (sampler/adapter.py), with zero extra device traffic.
    """

    def __init__(self, *, step_size_start: float, step_size_min: float,
                 step_size_max: float, leapfrog_start: int,
                 leapfrog_min: int, leapfrog_max: int, burnin: int,
                 seed: int = 0, probe: str = "always"):
        if probe not in ("always", "alternate"):
            raise ValueError(
                f"probe must be 'always' or 'alternate', got {probe!r}")
        self.eps_min = float(step_size_min)
        self.eps_max = float(step_size_max)
        self.l_min = int(leapfrog_min)
        self.l_max = int(leapfrog_max)
        self.burnin = int(burnin)
        self.eps = float(np.clip(step_size_start, self.eps_min,
                                 self.eps_max))
        self.l_hat = int(np.clip(leapfrog_start, self.l_min, self.l_max))
        # stochastic-approximation state (t counts chunk updates)
        self.log_eps_bar = math.log(self.eps)
        self.t = 0
        self.frozen = False
        self.reservoir: List[int] = []
        self.rng = np.random.default_rng(seed)
        #: probe schedule: "always" executes ceil(l_hat*GROW) every burn-in
        #: chunk (every trajectory's U-turn is observed; ~GROW-1 extra
        #: gradient work through burn-in); "alternate" interleaves probe
        #: chunks with exploit chunks run at l_hat (halving the tax;
        #: only probe chunks feed the reservoir, so censoring at l_hat
        #: never biases the length distribution down)
        self.probe = probe
        self.n_burn_chunks = 0
        self._last_was_probe = True

    # -- planning ----------------------------------------------------------

    def plan_chunk(self, iter_: int, chunk: int) -> tuple:
        """(eps, per-epoch leapfrog vector) for the next ``chunk`` epochs
        starting after completed epoch ``iter_``."""
        if iter_ < self.burnin:
            # probe past the current estimate so U-turns are observed,
            # not censored (censoring ratchets l_hat up via the median)
            probe_now = (self.probe == "always"
                         or self.n_burn_chunks % 2 == 0)
            self.n_burn_chunks += 1
            self._last_was_probe = probe_now
            l_target = (self.l_hat * GROW) if probe_now else self.l_hat
            l_exec = int(np.clip(int(math.ceil(l_target)),
                                 self.l_min, self.l_max))
            leaps = np.full(chunk, l_exec, np.int64)
        else:
            if not self.frozen:
                self._freeze()
            if self.reservoir:
                draws = self.rng.choice(np.asarray(self.reservoir,
                                                   np.int64), size=chunk)
            else:
                draws = np.full(chunk, self.l_hat, np.int64)
            leaps = np.clip(draws, self.l_min, self.l_max)
        return self.eps, leaps

    # -- observation -------------------------------------------------------

    def observe(self, iter_before: int, accept_means: np.ndarray,
                uturns: np.ndarray, executed: np.ndarray) -> None:
        """Consumes one chunk's trace.

        ``accept_means``: (chunk,) cross-chain mean acceptance per epoch.
        ``uturns``: (chunk, C) first-U-turn steps (0 = censored).
        ``executed``: (chunk,) the leapfrog counts that were run.
        """
        chunk = len(accept_means)
        burn_rows = [j for j in range(chunk)
                     if iter_before + j + 1 <= self.burnin]
        if burn_rows:
            # one Robbins-Monro update on the chunk's pooled acceptance
            # (every epoch in the chunk ran the same eps)
            self.t += 1
            alpha = float(np.clip(
                np.mean([accept_means[j] for j in burn_rows]), 0.0, 1.0))
            gain = RM_GAIN / self.t ** RM_DECAY
            log_eps = math.log(self.eps) + gain * (alpha - UT_TARGET)
            log_eps = float(np.clip(log_eps, math.log(self.eps_min),
                                    math.log(self.eps_max)))
            self.eps = math.exp(log_eps)
            wk = self.t ** (-UT_KAPPA)
            self.log_eps_bar = (wk * log_eps
                                + (1.0 - wk) * self.log_eps_bar)
            # U-turn lengths into the rolling reservoir (censored
            # trajectories report the executed length — a lower bound
            # that grows the next probe geometrically via the median).
            # Under the "alternate" schedule only probe chunks feed it:
            # exploit chunks run AT l_hat, so their censored entries
            # would anchor the median to itself and stall the ratchet.
            if self.probe == "always" or self._last_was_probe:
                for j in burn_rows:
                    ut = np.asarray(uturns[j], np.int64)
                    ut = np.where(ut == 0, int(executed[j]), ut)
                    self.reservoir.extend(int(v) for v in ut)
            if len(self.reservoir) > RESERVOIR_CAP:
                del self.reservoir[:len(self.reservoir) - RESERVOIR_CAP]
            if self.reservoir:
                self.l_hat = int(np.clip(int(np.median(self.reservoir)),
                                         self.l_min, self.l_max))
        if iter_before + chunk >= self.burnin:
            self._freeze()

    def _freeze(self) -> None:
        if not self.frozen:
            self.eps = float(np.clip(math.exp(self.log_eps_bar),
                                     self.eps_min, self.eps_max))
            self.frozen = True

    # -- persistence (JSON-safe, for the resume checkpoint) ----------------

    def state_dict(self) -> dict:
        return {
            "eps": self.eps, "l_hat": self.l_hat,
            "log_eps_bar": self.log_eps_bar, "t": self.t,
            "frozen": self.frozen, "reservoir": list(self.reservoir),
            "rng": self.rng.bit_generator.state,
            "probe": self.probe, "n_burn_chunks": self.n_burn_chunks,
            "last_was_probe": self._last_was_probe,
        }

    def load_state_dict(self, state: dict) -> None:
        self.eps = float(state["eps"])
        self.l_hat = int(state["l_hat"])
        self.log_eps_bar = float(state["log_eps_bar"])
        self.t = int(state["t"])
        self.frozen = bool(state["frozen"])
        self.reservoir = [int(v) for v in state["reservoir"]]
        self.rng.bit_generator.state = state["rng"]
        # fields absent in pre-round-4 checkpoints default to the old
        # always-probe behavior
        self.probe = state.get("probe", "always")
        self.n_burn_chunks = int(state.get("n_burn_chunks", 0))
        self._last_was_probe = bool(state.get("last_was_probe", True))
