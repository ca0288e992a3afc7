"""Parallel tempering (replica exchange) over the batched chain axis.

Counterpart of ``tensorbnn_tpu/sampler/tempering.py``. The fleet is widened
rung-major to ``K * C`` replicas: rung 0 holds the ``C`` cold chains
(``beta = 1``, the posterior), rung ``K - 1`` the hottest (``beta =
beta_min``). Both HMC blocks target the power posterior ``prior + beta *
loglik`` (the priors are not tempered), and every epoch ends with an
even/odd replica swap: chain ``i`` of rung ``r`` proposes to exchange its
whole state ``(theta, eta)`` with chain ``i`` of its partner rung, rungs
``(0, 1), (2, 3), ...`` pairing at even parity and ``(1, 2), (3, 4), ...``
at odd parity. The Metropolis log-ratio of a swap is ``(beta_r - beta_p) *
(ll_p - ll_r)``, symmetric in the pair, and both members decide on the low
rung member's uniform, so a pair always exchanges or stays together.

On a ``(chains, data)`` mesh tempering needs a chains axis of 1: the one
chain shard holds the whole replica fleet, and the swap reads the
log-likelihood summed over the data peers (``Potentials.loglik``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def make_ladder(n_rungs: int, beta_min: float = 0.1) -> np.ndarray:
    """Geometric inverse-temperature ladder, cold first: ``beta_r =
    beta_min ** (r / (K - 1))``, float32."""
    if n_rungs < 2:
        raise ValueError(f"n_rungs must be >= 2, got {n_rungs}")
    if not (0.0 < beta_min < 1.0):
        raise ValueError(f"beta_min must be in (0, 1), got {beta_min}")
    r = np.arange(n_rungs, dtype=np.float64)
    return (beta_min ** (r / (n_rungs - 1))).astype(np.float32)


def make_swap_fn(beta: torch.Tensor, n_rungs: int) -> Callable:
    """Builds the even/odd replica-swap move over a rung-major fleet.

    ``beta``: the ``(K,)`` rung inverse temperatures, on the fleet's
    device. Returns ``swap(theta (K*C, D), eta (K*C, H), ll (K*C,), parity,
    log_u (K*C,)) -> (theta, eta, swapped (K*C,) float)``: ``ll`` is the
    data log-likelihood at each replica's state, ``parity`` an int or a
    0-d integer tensor on the device (so that an epoch needs no host
    sync), ``log_u`` one log-uniform per replica, of which a pair uses its
    low rung member's. ``swapped`` is 1.0 where a replica exchanged state
    (0 on a rung without a partner at this parity).
    """
    k = n_rungs
    rungs = torch.arange(k, device=beta.device)

    def swap(theta, eta, ll, parity, log_u):
        c = theta.shape[0] // k
        th = theta.reshape(k, c, -1)
        et = eta.reshape(k, c, -1)
        lv = ll.reshape(k, c)

        is_lo = (rungs % 2) == (parity % 2)
        partner = torch.where(is_lo, rungs + 1, rungs - 1)
        valid = (partner >= 0) & (partner <= k - 1)
        partner = partner.clamp(0, k - 1)

        lr = (beta - beta[partner])[:, None] * (lv[partner] - lv)
        pair_lo = torch.minimum(rungs, partner)
        accept = (log_u.reshape(k, c)[pair_lo] < lr) & valid[:, None]

        th_new = torch.where(accept[:, :, None], th[partner], th)
        et_new = torch.where(accept[:, :, None], et[partner], et)
        return (th_new.reshape(theta.shape), et_new.reshape(eta.shape),
                accept.to(theta.dtype).reshape(-1))

    return swap
