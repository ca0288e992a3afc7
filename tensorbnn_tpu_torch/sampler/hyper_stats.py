"""Sufficient-statistics hyper-chain potential.

Counterpart of ``tensorbnn_tpu/sampler/hyper_stats.py``. During the hyper
block theta is fixed, and for Gaussian-prior dense stacks every
theta-dependent term of the hyper potential is quadratic, so it collapses
to per-block statistics computed once per epoch:

* per dense block, ``S1 = sum(x)`` and ``S2 = sum(x ** 2)`` of the weights
  and of the biases, giving ``sum((x - loc) ** 2) = S2 - 2 loc S1 + k loc**2``;
* for the learned-sd Gaussian likelihood, ``R = sum((y - preds) ** 2)`` and
  the event count ``K``.

The stats rows are ``(S1_w, S2_w, S1_b, S2_b)`` per dense block in model
order, then ``(R, K)`` when the likelihood couples in. The fused hyper
kernel (ops/fused_hyper.py) consumes the same rows.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from tensorbnn_tpu_torch.sampler.potential import eta_index_probe, \
    row_chunks

LOG_2PI = math.log(2.0 * math.pi)


def probe_stats_layout(model, likelihood, unravel_eta, eta_dim: int):
    """Returns ``(dense_layers, coupled, sd_idx)`` or None when the stats
    potential does not apply. ``dense_layers`` lists ``(layer_index,
    eta-index dict, k_w, k_b)`` in model order.

    Scope: every hyper-carrying layer is a GaussianDenseLayer, and the
    likelihood is the fixed-sd Gaussian, the Bernoulli or the categorical
    (uncoupled), or the learned-sd Gaussian (coupled through R).
    """
    from tensorbnn_tpu_torch.likelihoods import BernoulliLikelihood, \
        CategoricalLikelihood, FixedGaussianLikelihood, GaussianLikelihood
    from tensorbnn_tpu_torch.models.layers import GaussianDenseLayer

    probe_h, probe_l = eta_index_probe(unravel_eta, eta_dim)
    dense_layers = []
    for i, (layer, h) in enumerate(zip(model.layers, probe_h)):
        if not h:
            continue
        if not isinstance(layer, GaussianDenseLayer):
            return None
        if set(h) != {"b_loc", "b_scale", "w_loc", "w_scale"}:
            return None
        idx = {k: int(v) for k, v in h.items()}
        dense_layers.append((i, idx, layer.in_dim * layer.out_dim,
                             layer.out_dim))
    if not dense_layers:
        return None

    coupled, sd_idx = False, None
    if isinstance(likelihood, GaussianLikelihood):
        if "sd_root" not in probe_l:
            return None
        coupled, sd_idx = True, int(probe_l["sd_root"])
    elif not isinstance(likelihood, (FixedGaussianLikelihood,
                                     BernoulliLikelihood,
                                     CategoricalLikelihood)):
        return None
    if likelihood.main_probs_in_hypers != coupled:
        return None
    return dense_layers, coupled, sd_idx


def make_stats_hyper(model, likelihood, x, y, unravel_theta, unravel_eta,
                     eta_dim: int, data_chunk: Optional[int] = None,
                     peers=None) -> Optional[Tuple[Callable, Callable]]:
    """Builds ``(stats_fn, hyper_vg, hyper_vg_t)`` or None when out of
    scope.

    * ``stats_fn(thetas (C, D)) -> stats (C, S)``, once per epoch after the
      main block;
    * ``hyper_vg(etas (C, H), stats (C, S)) -> ((C,), (C, H))``, value and
      grad of the hyper potential, equal to ``Potentials.hyper_vg``;
      with ``data_chunk`` the coupled likelihood's residual power ``R`` is
      summed over row chunks (forward only: nothing is differentiated
      through ``stats_fn``), as the chunked potential bounds its
      activations; with ``peers`` (``parallel.mesh.DataPeers``, more than
      one peer) ``R`` and the event count ``K`` are each peer's, summed
      over the peers (the JAX package's data-axis psums), and ``x``, ``y``
      are not read;
    * ``hyper_vg_t(etas, stats, betas (C,))``, the tempered variant (the
      power posterior: beta scales only the coupled likelihood term, so for
      an uncoupled likelihood it equals ``hyper_vg`` for any beta), equal to
      ``Potentials.hyper_vg_t``.
    """
    layout = probe_stats_layout(model, likelihood, unravel_eta, eta_dim)
    if layout is None:
        return None
    dense_layers, coupled, sd_idx = layout
    out_dim = int(model.layers[dense_layers[-1][0]].out_dim)

    def resid_and_count(xs, ys):
        """``f(thetas) -> (R (C,), K (C,))`` over the rows ``xs``, ``ys``:
        the residual power (over row chunks) and the likelihood's event
        count (rows x the output width)."""
        chunks = row_chunks(xs, ys, data_chunk) or [(xs, ys)]
        n_events = float(int(xs.shape[0]) * out_dim)

        def f(thetas):
            total = None
            for xc, yc in chunks:
                preds = vmap(lambda th: model.apply(unravel_theta(th), xc))(
                    thetas)
                resid = yc.reshape(preds.shape[1:]) - preds
                part = (resid * resid).flatten(1).sum(1)
                total = part if total is None else total + part
            return total, torch.full_like(total, n_events)

        return f

    if peers is not None and len(peers) > 1:
        r_and_k = functools.partial(peers.sum, [
            resid_and_count(xj, yj) for xj, yj in peers.shards])
    else:
        r_and_k = resid_and_count(x, y)

    def stats_fn(thetas):
        params = unravel_theta(thetas)                 # leaves (C, ...)
        cols = []
        for i, _, _, _ in dense_layers:
            w = params[i]["w"].flatten(1)
            b = params[i]["b"]
            cols += [w.sum(1), (w * w).sum(1), b.sum(1), (b * b).sum(1)]
        if coupled:
            cols += list(r_and_k(thetas))
        return torch.stack(cols, dim=1)

    def hyper_logp(eta, stats, beta):
        lp = 0.0
        for j, (_, idx, k_w, k_b) in enumerate(dense_layers):
            w_loc, w_scale = eta[idx["w_loc"]], eta[idx["w_scale"]]
            b_loc, b_scale = eta[idx["b_loc"]], eta[idx["b_scale"]]
            s1w, s2w, s1b, s2b = (stats[4 * j], stats[4 * j + 1],
                                  stats[4 * j + 2], stats[4 * j + 3])
            # hyperpriors: N(0, .1) on locs, N(1, .1) on squared scales
            for v, m in ((w_loc, 0.0), (w_scale ** 2, 1.0),
                         (b_loc, 0.0), (b_scale ** 2, 1.0)):
                z = (v - m) / 0.1
                lp = lp - 0.5 * z * z - math.log(0.1) - 0.5 * LOG_2PI
            # conditional priors, reference-exact gaussian_logprob with a
            # scalar sigma (one normalizer per block)
            for loc, scale, s1, s2, k in ((w_loc, w_scale, s1w, s2w, k_w),
                                          (b_loc, b_scale, s1b, s2b, k_b)):
                sd = (scale ** 2).clamp(1e-8, 1e8)
                quad = (s2 - 2.0 * loc * s1 + k * loc * loc) / (sd * sd)
                lp = lp - 0.5 * (2.0 * torch.log(sd) + quad + LOG_2PI)
        if coupled:
            sd = (eta[sd_idx] ** 2).clamp(1e-8, 1e8)
            r, k = stats[-2], stats[-1]
            lp = lp + beta * (-0.5 * (2.0 * k * torch.log(sd)
                                      + r / (sd * sd) + k * LOG_2PI))
        return lp

    vg = vmap(grad_and_value(lambda e, s: hyper_logp(e, s, 1.0)))
    vg_t = vmap(grad_and_value(hyper_logp))

    def hyper_vg(etas, stats):
        g, v = vg(etas, stats)
        return v, g

    def hyper_vg_t(etas, stats, betas):
        g, v = vg_t(etas, stats, betas)
        return v, g

    return stats_fn, hyper_vg, hyper_vg_t
