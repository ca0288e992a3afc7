"""The plain reference of one Gibbs epoch's two HMC blocks, and of the
run's random draws.

HMC as the reference tensorBNN defines it: unit-normal momenta, a half
kick, ``L`` full drifts and kicks (the last kick then taken back by half),
and the Metropolis test ``log u < (lp1 - lp0) + (K0 - K1)``, a NaN ratio
rejecting. A chain with a per-chain ``L`` below the fleet's largest stays
where it is for the remaining steps.

The draws: a run draws, from its one generator, the chains' start jitter
(``randn (C, D)``, only with a jitter) and then, each epoch, the main
momenta (``randn (C, D)``), the main coins (``log rand (C,)``), the hyper
momenta (``randn (C, H)``) and the hyper coins (``log rand (C,)``), in that
order. That order is part of what the program states about a seed (the
same seed gives the same samples on one card and torch version), so the
reference draws the same numbers from a generator of the same seed.
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import torch


class EpochDraws(NamedTuple):
    main_momenta: torch.Tensor
    main_log_u: torch.Tensor
    hyper_momenta: torch.Tensor
    hyper_log_u: torch.Tensor


def replay_draws(seed: int, c: int, d: int, h: int, jitter: float,
                 device, wanted: Sequence[int]) -> dict:
    """``{epoch: EpochDraws}`` for the 1-based ``wanted`` epochs of a run
    whose generator was seeded with ``seed``: every draw before them is
    made again and dropped."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(generator=gen, dtype=torch.float32, device=device)
    if jitter > 0:
        torch.randn((c, d), **kw)
    out, last = {}, max(wanted)
    wanted = set(wanted)
    for epoch in range(1, last + 1):
        p = torch.randn((c, d), **kw)
        lu = torch.log(torch.rand(c, **kw))
        ph = torch.randn((c, h), **kw)
        luh = torch.log(torch.rand(c, **kw))
        if epoch in wanted:
            out[epoch] = EpochDraws(p, lu, ph, luh)
    return out


def metropolis(lp0, lp1, p0, p1, log_u):
    """``(accepted (C,), log ratio (C,))``."""
    lar = (lp1 - lp0) + 0.5 * ((p0 * p0).sum(-1) - (p1 * p1).sum(-1))
    lar = torch.where(torch.isnan(lar), torch.full_like(lar, -torch.inf),
                      lar)
    return log_u.to(lar.dtype) < lar, lar


def trajectory(vg: Callable, q0, p0, eps, steps,
               snapshots: Optional[Callable] = None):
    """Leapfrog from ``(q0 (C, D), p0)`` with ``eps (C,)`` and per-chain
    ``steps (C,)`` (ints). Returns ``(q, p, lp0, lp1)`` at each chain's
    end. ``snapshots(i, q)``, if given, sees the positions after each full
    step ``i`` (1-based)."""
    if q0.shape[0] == 0:
        none = q0.new_zeros(0)
        return q0, p0.to(q0.dtype), none, none
    eps = eps.to(q0.dtype)[:, None]
    lp0, g = vg(q0)
    q = q0.clone()
    v = p0.to(q0.dtype) + 0.5 * eps * g
    lp = lp0
    n = int(steps.max())
    for i in range(n):
        act = (i < steps)[:, None].to(q.device)
        q = q + torch.where(act, eps * v, torch.zeros_like(v))
        lp, g = vg(q)
        v = v + torch.where(act, eps * g, torch.zeros_like(g))
        if snapshots is not None:
            snapshots(i + 1, q)
    return q, v - 0.5 * eps * g, lp0, lp


def transition(vg: Callable, q0, p0, log_u, eps, steps):
    """One HMC transition: ``(position (C, D), accepted (C,), proposal
    (C, D))``."""
    q, p, lp0, lp1 = trajectory(vg, q0, p0, eps, steps)
    accepted, _ = metropolis(lp0, lp1, p0.to(q.dtype), p, log_u)
    return torch.where(accepted[:, None], q, q0.to(q.dtype)), accepted, q


def moved(prev: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``(C,)`` whether a chain's state changed: the program keeps a
    rejected chain's state bit for bit."""
    return (prev != new).any(-1)


def relative_gap(got, want, start) -> torch.Tensor:
    """``(C,)``: the largest coordinate gap between ``got`` and ``want``
    over the largest coordinate of ``want``'s move from ``start``."""
    scale = (want - start).abs().amax(-1).clamp_min(1e-300)
    return (got.to(want.dtype) - want).abs().amax(-1) / scale


def search_steps(vg_for: Callable, q0, p0, target, group, n_groups: int,
                 eps_options, steps_options) -> tuple:
    """Each group's ``(eps, L)`` among ``eps_options`` x ``steps_options``:
    the one whose trajectories from ``(q0 (k, D), p0)`` end nearest
    ``target`` for the group's chains (``group (k,)``, ids below
    ``n_groups``: chains that moved), by the geometric mean of their
    ``relative_gap``s, so that one chaotic chain of the group cannot move
    the choice. ``vg_for(n)`` is the potential's value-and-gradient over
    the k chains repeated ``n`` times. Returns ``(eps (G,), L (G,), gap
    (G,))``, ``gap`` the geometric mean at the choice; a group without
    chains keeps an infinite gap."""
    k, d = q0.shape
    dev = q0.device
    e = torch.as_tensor(eps_options, dtype=q0.dtype, device=dev)
    n_e = e.numel()
    tt = target.to(q0.dtype).repeat(n_e, 1)
    start = q0.repeat(n_e, 1)
    index = group.to(dev)[None].expand(n_e, k)
    wanted = set(int(s) for s in steps_options)
    best_gap = torch.full((n_groups,), torch.inf, dtype=q0.dtype, device=dev)
    best_e = torch.zeros(n_groups, dtype=q0.dtype, device=dev)
    best_l = torch.zeros(n_groups, dtype=torch.int64, device=dev)

    def look(i, q):
        if i not in wanted:
            return
        gap = torch.nan_to_num(relative_gap(q, tt, start), nan=torch.inf)
        log_gap = torch.log(gap.clamp(1e-300, 1e300))
        mean = torch.zeros((n_e, n_groups), dtype=q.dtype,
                           device=dev).scatter_reduce(
            1, index, log_gap.reshape(n_e, k), reduce="mean",
            include_self=False)
        mean = torch.where(torch.zeros_like(mean).scatter_(
            1, index, 1.0) > 0, mean.exp(), torch.full_like(mean, torch.inf))
        g, j = mean.min(dim=0)
        better = g < best_gap
        best_gap.copy_(torch.where(better, g, best_gap))
        best_e.copy_(torch.where(better, e[j], best_e))
        best_l.copy_(torch.where(better, torch.full_like(best_l, i), best_l))

    steps = torch.full((n_e * k,), max(wanted), dtype=torch.int64, device=dev)
    trajectory(vg_for(n_e), q0.repeat(n_e, 1), p0.to(q0.dtype).repeat(n_e, 1),
               e.repeat_interleave(k), steps, snapshots=look)
    return best_e, best_l, best_gap


def _hyper_endpoints(vg: Callable, eta0, p0, steps: int, s):
    """Hyper trajectories' end positions at per-row steps ``s (R,)``."""
    n = torch.full((eta0.shape[0],), steps, dtype=torch.int64,
                   device=eta0.device)
    q, _, _, _ = trajectory(vg, eta0, p0, s, n)
    return q


def fit_hyper_step(vg_of: Callable, eta0, p0, eta1, steps: int, track,
                   n_tracks: int, grid: Iterator[float], rounds: int = 40,
                   basins: int = 5, block: int = 32):
    """Each track's hyper step size: one step size for the rows ``track
    (R,)`` of a track (a chain's accepted hyper transitions: from ``eta0
    (R, H)`` with momenta ``p0`` to ``eta1``, ``steps`` steps each), the
    one whose trajectories end nearest their ``eta1`` by the track's worst
    ``relative_gap``. A scan of ``grid`` (``block`` points at a time), then
    a golden-section search of the log step around each of the ``basins``
    lowest local minima of the scan, the best kept. ``vg_of(index)`` gives
    the hyper potential's value-and-gradient for the rows ``index``.
    Returns ``(s (T,), gap (T,))``: a track without rows keeps a NaN step
    and an infinite gap."""
    r, dev = eta0.shape[0], eta0.device
    s_out = torch.full((n_tracks,), float("nan"), dtype=eta0.dtype,
                       device=dev)
    f_out = torch.full((n_tracks,), torch.inf, dtype=eta0.dtype, device=dev)
    if r == 0:
        return s_out, f_out
    grid = torch.as_tensor(list(grid), dtype=eta0.dtype, device=dev)
    g = grid.numel()

    def worst(gaps, k):
        # each track's largest gap, for k step sizes: (k, T)
        gaps = torch.nan_to_num(gaps, nan=torch.inf).reshape(k, r)
        return torch.full((k, n_tracks), -1.0, dtype=gaps.dtype,
                          device=dev).scatter_reduce(
            1, track[None].expand(k, r), gaps, reduce="amax")

    rows = []
    for lo in range(0, g, block):
        part = grid[lo:lo + block]
        k = part.numel()
        idx = torch.arange(r, device=dev).repeat(k)
        ends = _hyper_endpoints(vg_of(idx), eta0.repeat(k, 1),
                                p0.repeat(k, 1), steps,
                                part.repeat_interleave(r))
        rows.append(worst(relative_gap(ends, eta1.repeat(k, 1),
                                       eta0.repeat(k, 1)), k))
    gaps = torch.cat(rows)
    inf = torch.full_like(gaps[:1], torch.inf)
    left = torch.cat([inf, gaps[:-1]])
    right = torch.cat([gaps[1:], inf])
    minima = torch.where((gaps <= left) & (gaps <= right), gaps,
                         torch.full_like(gaps, torch.inf))
    starts = torch.topk(minima, min(basins, g), dim=0, largest=False).indices
    vg = vg_of(torch.arange(r, device=dev))
    ratio = (5 ** 0.5 - 1) / 2

    def gap(log_s):
        ends = _hyper_endpoints(vg, eta0, p0, steps, torch.exp(log_s)[track])
        return worst(relative_gap(ends, eta1, eta0), 1)[0]

    for j in starts:
        lo = torch.log(grid[(j - 1).clamp_min(0)])
        hi = torch.log(grid[(j + 1).clamp_max(g - 1)])
        a = hi - ratio * (hi - lo)
        b = lo + ratio * (hi - lo)
        fa, fb = gap(a), gap(b)
        for _ in range(rounds):
            # keep the side of the smaller gap; one new point a round
            keep_left = fa < fb
            hi = torch.where(keep_left, b, hi)
            lo = torch.where(keep_left, lo, a)
            new = torch.where(keep_left, hi - ratio * (hi - lo),
                              lo + ratio * (hi - lo))
            f_new = gap(new)
            a, b, fa, fb = (torch.where(keep_left, new, b),
                            torch.where(keep_left, a, new),
                            torch.where(keep_left, f_new, fb),
                            torch.where(keep_left, fa, f_new))
        s = torch.exp(torch.where(fa < fb, a, b))
        f = torch.minimum(fa, fb)
        better = (f < f_out) & (f >= 0)
        s_out = torch.where(better, s, s_out)
        f_out = torch.where(better, f, f_out)
    return s_out, f_out
