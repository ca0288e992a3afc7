"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``), once the window has closed.

Sampling cells. A sampler's output is random, so the reference follows
the program step by step from the program's own recorded states: for a
sample, drawn from the seed, of consecutive recorded epochs ``e -> e + 1``
(the cells record every epoch after the burn-in), it takes the program's
state at ``e``, draws the epoch's momenta and coins again from a generator
of the job's seed (``reference.hmc.replay_draws``), runs the epoch's two
HMC blocks in float64, and compares the result with the program's state
at ``e + 1``, every chain and transition in one batch:

* main block, from the program's ``(theta_e, eta_e)``: each chain's
  Metropolis decision (``main_flips``: the share that differ) and, where
  both accept, the endpoint (``main_gap``: the worst chain's largest
  coordinate gap over its move). A cell whose adapters pick ``(eps, L)``
  per group takes them from the adapter's grids (``reference.hmc.
  search_steps``), at the candidate whose trajectories end nearest the
  program's for up to four of the group's moving chains (a group with no
  moving chain is not followed: ``main_unfollowed``, recorded). The
  steps followed are held to the L the program reports for each epoch
  (``main_steps_off``: the share of transitions where the groups' mean L
  is not the reported one; exact), and the median endpoint gap
  (``main_gap_median``) to a limit that a trajectory a step short or
  long cannot meet;
* hyper block, from ``eta_e`` given the program's ``theta_{e+1}``: each
  chain's hyper step size is the program's own state (set by dual
  averaging in the burn-in, frozen after it), so one step size a chain of
  a job is fitted to all its moving transitions together
  (``reference.hmc.fit_hyper_step``; a chain that never moves is not
  followed: ``hyper_unfitted``, recorded), and every transition of the
  chain is followed with it: ``hyper_flips``, ``hyper_gap``. The fitted
  steps' mean over a job's chains is held to the mean the program reports
  (``hyper_step_off``: the worst job's relative gap).

Long trajectories of these posteriors are chaotic: a float32 run departs
from the float64 one by a share that grows exponentially with the steps.
A transition whose float64 endpoint moves by more than ``CHAOS`` of its
move when its momenta are moved by float32's rounding (``nudged``) is
left out of the gaps and decisions (``main_chaotic``: their share,
recorded). Their acceptance is held to the reference's in law:
``main_chaos_z``, the gap between the program's and the reference's
counts of accepted chaotic transitions over the binomial standard
deviation of the reference's. Where no row is left to compare, a gap and
a share of flips read 1, as if the program had not moved.

The control (``control=True``) puts the reference in bfloat16 in the
program's place: the same transitions from the same states, draws and
steps, in bfloat16, judged by the same numbers.

Predict cells: the ensemble forward of a sample of calls, drawn from the
seed, and the last call, against the float64 forward of the ensemble the
benchmark made (``predict_gap``: the largest output gap over the largest
output).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from reference import hmc
from reference.mlp import Stack

#: the hyper step's scan, before the golden-section search (log-spaced,
#: 64 a decade over the dual averaging's reach)
HYPER_GRID = np.logspace(-8, 0, 513)
#: a transition is chaotic, and its endpoint and decision are not
#: compared, where the reference's run from momenta moved by float32's
#: rounding (``nudged``) ends further than this share of the move from its
#: run from the momenta themselves: about 170 times the nudge
CHAOS = 1e-5
#: float32's unit roundoff
U32 = 2.0 ** -24


def nudged(q, p):
    """``(q, p)`` with each momentum moved by N(0, 1) times float32's unit
    roundoff of itself (from a fixed generator): a start that float32's
    rounding cannot tell apart, which moves a calm trajectory's endpoint
    by about that share of its move."""
    g = torch.Generator(device=q.device).manual_seed(0)
    return q, p * (1.0 + U32 * torch.randn(p.shape, generator=g,
                                           dtype=p.dtype, device=p.device))


def step_options(mcmc: dict):
    """The adapter's candidate ``(eps, L)`` values: its step-size grid at
    its bounds and at up to three halvings (a strike halves both bounds),
    with the start, and its leapfrog grid (``leapfrog_min`` to
    ``leapfrog_max`` by ``leapfrog_increment``) with the start. The
    program passes per-chain steps as float32."""
    lo, hi, n = (mcmc["step_size_min"], mcmc["step_size_max"],
                 mcmc["step_size_options"])
    eps = [mcmc["step_size_start"]]
    for h in range(4):
        eps.extend(np.linspace(lo / 2 ** h, hi / 2 ** h, n).tolist())
    eps = np.unique(np.asarray(eps, np.float32)).astype(np.float64)
    steps = set(range(mcmc["leapfrog_min"], mcmc["leapfrog_max"] + 1,
                      mcmc["leapfrog_increment"]))
    steps.add(mcmc["leapfrog_start"])
    return eps, sorted(steps)


def fixed_step(mcmc: dict):
    """``(eps, L)`` of a cell whose grids are single points, else None."""
    if (mcmc["step_size_min"] == mcmc["step_size_max"]
            == mcmc["step_size_start"]
            and mcmc["leapfrog_min"] == mcmc["leapfrog_max"]
            == mcmc["leapfrog_start"]):
        return float(np.float32(mcmc["step_size_start"])), \
            int(mcmc["leapfrog_start"])
    return None


class Rows(NamedTuple):
    """Every followed transition of a run's picks, one row a chain and
    transition: the program's states before and after, the epoch's draws,
    the transition's index in its pick, ids of the chain's track (its job
    and chain) and of its adapter group at that transition, and what the
    program reports of its steps: the transition's L (the mean over the
    groups) and the job's mean hyper step."""
    q0: torch.Tensor
    q1: torch.Tensor
    e0: torch.Tensor
    e1: torch.Tensor
    p: torch.Tensor
    log_u: torch.Tensor
    ph: torch.Tensor
    log_uh: torch.Tensor
    t: torch.Tensor
    track: torch.Tensor
    group: torch.Tensor
    rec_l: torch.Tensor
    rec_h: torch.Tensor


def gather(picks: List[dict], draws: List[dict], groups: int,
           device) -> Rows:
    """The picks' transitions as ``Rows`` (float64)."""
    parts = {k: [] for k in Rows._fields}
    group_base = 0
    track_base = {}
    for pick, dr in zip(picks, draws):
        th = torch.as_tensor(pick["theta"], dtype=torch.float64,
                             device=device)
        et = torch.as_tensor(pick["eta"], dtype=torch.float64, device=device)
        t1, c = th.shape[0] - 1, th.shape[1]
        per = c // groups
        base = track_base.setdefault(pick["job"], c * len(track_base))
        for t in range(t1):
            d = dr[pick["first_epoch"] + t + 1]
            parts["q0"].append(th[t])
            parts["q1"].append(th[t + 1])
            parts["e0"].append(et[t])
            parts["e1"].append(et[t + 1])
            parts["p"].append(d.main_momenta.to(torch.float64))
            parts["log_u"].append(d.main_log_u.to(torch.float64))
            parts["ph"].append(d.hyper_momenta.to(torch.float64))
            parts["log_uh"].append(d.hyper_log_u.to(torch.float64))
            chain = torch.arange(c, device=device)
            parts["t"].append(torch.full((c,), t, device=device))
            parts["track"].append(base + chain)
            parts["group"].append(group_base + t * groups + chain // per)
            parts["rec_l"].append(torch.full(
                (c,), float(pick["leapfrog"][t]), dtype=torch.float64,
                device=device))
            parts["rec_h"].append(torch.full(
                (c,), pick["hyper_step"], dtype=torch.float64,
                device=device))
        group_base += t1 * groups
    return Rows(*(torch.cat(parts[k]) for k in Rows._fields))


class Follower:
    """The sampling numbers over every followed transition at once."""

    def __init__(self, config: dict, traffic: dict, x, y):
        self.config = config
        self.ref = Stack(config, torch.float64)
        self.x, self.y = x, y
        self.rows = int(config["reference_rows"])
        self.mcmc = traffic["mcmc"]
        self.groups = traffic["job"].get("n_adapters", 1)
        self.chains = int(traffic["job"]["n_chains"])
        self.hyper_steps = int(self.mcmc["hyper_leapfrog"])
        self.fixed = fixed_step(self.mcmc)
        self.detail: Dict[str, object] = {}

    def main_vg(self, stack, eta):
        return lambda q: stack.main_value_grad(q, eta, self.x, self.y,
                                               self.rows)

    def steps(self, r: Rows, moved):
        """Each row's ``(eps, L)`` and whether it is known: the cell's
        fixed pair, or each group's pick from the adapter's grids."""
        n, dev = r.q0.shape[0], r.q0.device
        if self.fixed is not None:
            eps, steps = self.fixed
            self.steps_off = float((r.rec_l != steps).double().mean())
            self.detail_steps = {"transitions_held": n // self.chains}
            return (torch.full((n,), eps, dtype=torch.float64, device=dev),
                    torch.full((n,), steps, dtype=torch.int64, device=dev),
                    torch.ones(n, dtype=torch.bool, device=dev))
        # up to four moving chains a group
        n_groups = int(r.group.max()) + 1
        order = torch.argsort(r.group * 2 + (~moved).long(), stable=True)
        g_sorted = r.group[order]
        first = torch.searchsorted(g_sorted, g_sorted)
        rank = torch.arange(n, device=dev) - first
        pick = order[(rank < 4) & moved[order]]
        if pick.numel() == 0:
            none = torch.zeros(n, dtype=torch.bool, device=dev)
            self.steps_off, self.detail_steps = 1.0, {}
            return none.double(), none.long(), none
        eps_options, steps_options = step_options(self.mcmc)
        e, l, gap = hmc.search_steps(
            lambda k: self.main_vg(self.ref, r.e0[pick].repeat(k, 1)),
            r.q0[pick], r.p[pick], r.q1[pick], r.group[pick], n_groups,
            eps_options, steps_options)
        self.hold_steps(r, l, torch.isfinite(gap), min(steps_options),
                        max(steps_options))
        known = torch.isfinite(gap)[r.group]
        return e[r.group], l[r.group], known

    def hold_steps(self, r: Rows, l_group, known_group, l_min, l_max):
        """``main_steps_off``: the share of transitions whose groups' fitted
        L do not add up to the groups times the L the program reports.
        Where some group of a transition has no moving chain, the rest
        must lie within the grid's reach for the groups not fitted."""
        g = self.groups
        rec = torch.zeros_like(l_group, dtype=torch.float64).scatter_(
            0, r.group, r.rec_l).view(-1, g)[:, 0]
        fitted = known_group.view(-1, g)
        got = (l_group.double().view(-1, g) * fitted).sum(1)
        want = torch.round(rec * g)
        unknown = (~fitted).sum(1).double()
        full = fitted.all(1)
        partial = ~full & fitted.any(1)
        rest = want - got
        off = (full & (got != want)) | (partial & (
            (rest < unknown * l_min) | (rest > unknown * l_max)))
        held = full | partial
        self.steps_off = (float(off[held].double().mean()) if held.any()
                          else 1.0)
        self.detail_steps = {"transitions_held": int(full.sum()),
                             "transitions_held_in_part": int(partial.sum())}

    def follow(self, r: Rows) -> Dict[str, torch.Tensor]:
        """The reference's transitions of every row (float64, and again
        from nudged momenta for the chaos mask), the rows' steps and the
        hyper steps fitted."""
        moved = hmc.moved(r.q0, r.q1)
        eps, steps, known = self.steps(r, moved)
        out = {"moved": moved, "eps": eps, "steps": steps, "known": known}
        k = torch.nonzero(known).flatten()
        vg = self.main_vg(self.ref, r.e0[k])
        _, acc, prop = hmc.transition(vg, r.q0[k], r.p[k], r.log_u[k],
                                      eps[k], steps[k])
        qp, _, _, _ = hmc.trajectory(vg, *nudged(r.q0[k], r.p[k]), eps[k],
                                     steps[k])
        out.update(k=k, acc=acc, prop=prop,
                   chaos=hmc.relative_gap(qp, prop, r.q0[k]) > CHAOS)
        # -- hyper block, given the program's new theta ------------------
        self.stats = {torch.float64: self.ref.hyper_stats(r.q1)}
        self.rss = self.n_out = None
        if self.ref.sd_index is not None:
            self.rss, self.n_out = self.ref.residual_power(
                r.q1, self.x, self.y, self.rows)
        h_moved = hmc.moved(r.e0, r.e1)
        # each track's (chain's) step size, fitted on its moves together;
        # then every row of a fitted track is followed with it
        n_tracks = int(r.track.max()) + 1
        fit = torch.nonzero(h_moved).flatten()
        s_track, residual = hmc.fit_hyper_step(
            lambda j: self.hyper_vg(self.ref, fit[j]), r.e0[fit], r.ph[fit],
            r.e1[fit], self.hyper_steps, r.track[fit], n_tracks, HYPER_GRID)
        h = torch.nonzero(torch.isfinite(s_track[r.track])).flatten()
        s = s_track[r.track[h]]
        # each job's fitted steps against the mean the program reports
        rec = torch.zeros_like(s_track).scatter_(0, r.track, r.rec_h)
        per_job = []
        for j0 in range(0, n_tracks, self.chains):
            got = s_track[j0:j0 + self.chains]
            ok = torch.isfinite(got)
            if ok.any():
                per_job.append(float((got[ok].mean() - rec[j0]).abs()
                                     / rec[j0]))
        self.hyper_step_off = max(per_job) if per_job else 1.0
        n_h = torch.full((h.numel(),), self.hyper_steps, dtype=torch.int64,
                         device=h.device)
        vg = self.hyper_vg(self.ref, h)
        _, h_acc, h_prop = hmc.transition(vg, r.e0[h], r.ph[h], r.log_uh[h],
                                          s, n_h)
        hp, _, _, _ = hmc.trajectory(vg, *nudged(r.e0[h], r.ph[h]), s, n_h)
        out.update(h=h, h_s=s, h_acc=h_acc, h_prop=h_prop, h_moved=h_moved,
                   h_chaos=hmc.relative_gap(hp, h_prop, r.e0[h]) > CHAOS,
                   n_fitted=int(torch.isfinite(residual).sum()),
                   n_tracks=n_tracks)
        return out

    def hyper_vg(self, stack, idx):
        st = [(n, a[idx], b[idx]) for n, a, b in self.stats[stack.dtype]]
        rss = None if self.rss is None else self.rss[idx]
        return lambda e: stack.hyper_value_grad(e, st, rss, self.n_out)

    def judge(self, r: Rows, f: dict, control: bool) -> Dict[str, float]:
        """The numbers: the program's rows (or, for the control, the
        bfloat16 reference's transitions from the same states, draws and
        steps) against the float64 reference's."""
        k, h = f["k"], f["h"]
        got, moved = r.q1[k], f["moved"][k]
        h_got, h_moved = r.e1[h], f["h_moved"][h]
        if control:
            low = Stack(self.config, torch.bfloat16)
            pos, moved, _ = hmc.transition(
                self.main_vg(low, r.e0[k]), r.q0[k].bfloat16(),
                r.p[k].bfloat16(), r.log_u[k], f["eps"][k], f["steps"][k])
            got = pos.double()
            self.stats[torch.bfloat16] = low.hyper_stats(r.q1)
            pos, h_moved, _ = hmc.transition(
                self.hyper_vg(low, h), r.e0[h].bfloat16(),
                r.ph[h].bfloat16(), r.log_uh[h], f["h_s"],
                torch.full((h.numel(),), self.hyper_steps, device=h.device))
            h_got = pos.double()
        calm = ~f["chaos"]
        both = f["acc"] & moved & calm
        main_gap = hmc.relative_gap(got[both], f["prop"][both],
                                    r.q0[k][both])
        # the chaotic transitions' acceptance, in law
        chaos = f["chaos"]
        n_ch = int(chaos.sum())
        if n_ch:
            a_ref = float(f["acc"][chaos].double().sum())
            a_got = float(moved[chaos].double().sum())
            p = min(max(a_ref / n_ch, 0.5 / n_ch), 1.0 - 0.5 / n_ch)
            chaos_z = abs(a_got - a_ref) / float(np.sqrt(n_ch * p * (1 - p)))
        else:
            chaos_z = 0.0
        h_calm = ~f["h_chaos"]
        h_both = f["h_acc"] & h_moved & h_calm
        h_gap = hmc.relative_gap(h_got[h_both], f["h_prop"][h_both],
                                 r.e0[h][h_both])
        n = r.q0.shape[0]
        self.detail = {
            "rows": n, "followed": int(k.numel()),
            "main_chaotic": int(f["chaos"].sum()),
            "main_compared": int(calm.sum()), "main_both": int(both.sum()),
            "hyper_compared": int(h_calm.sum()), "hyper_both": int(
                h_both.sum()), "hyper_chaotic": int(f["h_chaos"].sum()),
            "tracks": f["n_tracks"], "tracks_fitted": f["n_fitted"],
            **self.detail_steps}
        for name, g in (("main", main_gap), ("hyper", h_gap)):
            if g.numel():
                self.detail[name + "_gap_quantiles"] = [
                    float(v) for v in np.quantile(
                        g.double().cpu().numpy(), [0.5, 0.9, 0.99, 1.0])]
        # with no endpoint to compare, the number reads as an endpoint left
        # at its start: 1
        worst_main = float(main_gap.max()) if main_gap.numel() else 1.0
        worst_h = float(h_gap.max()) if h_gap.numel() else 1.0
        return {
            "main_gap": worst_main,
            "main_gap_median": (float(main_gap.median())
                                if main_gap.numel() else 1.0),
            "main_steps_off": self.steps_off,
            "main_chaos_z": chaos_z,
            "main_flips": float((f["acc"] != moved)[calm].double().mean())
            if calm.any() else 1.0,
            "main_unfollowed": 1.0 - k.numel() / max(n, 1),
            "main_chaotic": float(f["chaos"].double().mean())
            if k.numel() else 0.0,
            "hyper_gap": worst_h,
            "hyper_flips": float((f["h_acc"] != h_moved)[h_calm].double()
                                 .mean()) if h_calm.any() else 1.0,
            "hyper_unfitted": 1.0 - f["n_fitted"] / max(f["n_tracks"], 1),
            "hyper_step_off": self.hyper_step_off,
        }


def follow_jobs(config, traffic, x, y, picks: List[dict], state: dict,
                control: bool = False):
    """The sampling numbers over ``picks``: each ``{"theta", "eta" (T + 1,
    C, ...) numpy, "first_epoch", "gen_seed"}``. ``state`` keeps what the
    reference worked out (the program's run, then the control's, reuse
    it). Returns ``(readings, detail)``."""
    job = traffic["job"]
    if job["sampling_step"] != 1:
        raise ValueError("the check follows consecutive epochs: a checked "
                         "cell records every epoch (sampling_step 1)")
    if "follower" not in state:
        f = Follower(config, traffic, x, y)
        draws = []
        for pick in picks:
            t1 = pick["theta"].shape[0] - 1
            draws.append(hmc.replay_draws(
                pick["gen_seed"], pick["theta"].shape[1], f.ref.D, f.ref.H,
                job.get("chain_jitter", 0.0), x.device,
                [pick["first_epoch"] + t + 1 for t in range(t1)]))
        state["rows"] = gather(picks, draws, f.groups, x.device)
        state["follower"] = f
        state["followed"] = f.follow(state["rows"])
    f = state["follower"]
    readings = f.judge(state["rows"], state["followed"], control)
    return readings, dict(f.detail)


def predict_gap(config, thetas: torch.Tensor, calls: List[tuple],
                control: bool = False) -> float:
    """The largest output gap of the program's ``(x, out)`` calls against
    the float64 ensemble forward, over the largest output; the control
    puts the bfloat16 forward in the program's place."""
    ref = Stack(config, torch.float64)
    low = Stack(config, torch.bfloat16)
    worst = 0.0
    for x, out in calls:
        xd = torch.as_tensor(x, device=thetas.device)
        want = torch.cat([ref.forward(thetas[i:i + 250], xd)
                          for i in range(0, thetas.shape[0], 250)])
        if control:
            got = torch.cat([low.forward(thetas[i:i + 250], xd)
                             for i in range(0, thetas.shape[0], 250)])
        else:
            got = torch.as_tensor(np.asarray(out), device=thetas.device)
        if tuple(got.shape) != tuple(want.shape):
            return float("inf")
        gap = float((got.to(torch.float64) - want).abs().max()
                    / want.abs().max().clamp_min(1e-300))
        worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    return worst
