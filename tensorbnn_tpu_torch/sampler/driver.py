"""Training driver: chunked runs on the device, GP-UCB adaptation on the host.

Counterpart of ``sample_posterior`` in ``tensorbnn_tpu/sampler/driver.py``
for its default options. Each chunk runs one adapter cycle of epochs (the
chunk ends where the GP-UCB adapter may next change ``(eps, L)``), then
the per-epoch SJD and acceptance of every chain come back to the host in
one transfer, and the adapters replay them epoch by epoch to pick the next
chunk's ``(eps, L)``. With ``n_adapters = G`` the chains split into G
groups, each with its own adapter and its own ``(eps, L)``, repeated per
chain. Samples stay on the device until the run ends.

Parallel tempering (``tempering=K``) widens the fleet rung-major to ``K *
n_chains`` replicas (sampler/tempering.py), with one GP-UCB adapter per
rung; samples, SJD and acceptance cover the cold chains only, and the
per-epoch swap rates come back beside them.

U-turn trajectories (``trajectory="uturn"``, sampler/uturn.py) replace the
GP-UCB adapters with the ``UTurnAdapter``: burn-in chunks of
``averaging_steps`` epochs record each chain's first U-turn step, and the
adapter sets the step size (Robbins-Monro toward 0.8 acceptance) and the
per-epoch leapfrog counts of the next chunk; after burn-in each epoch
draws its count from the recorded U-turn lengths, in chunks of up to 50
epochs. Every chain of an epoch shares its ``(eps, L)``.

Kernel choice: with ``use_fused`` "auto" (or True) the driver builds K1
(ops/fused_mlp.py) for the main block whenever the model is in its scope
(its U-turn-recording program in ``trajectory="uturn"``): every likelihood
and layer of the port, within one block's shared memory. Else it builds
K3 (the per-step potential, same module) under ``hmc_step_batched``, else
the plain ``hmc_step_batched`` path. K2 (ops/fused_hyper.py) takes the
hyper block whenever the stats layout applies (Gaussian dense layers
only). A tempered run builds K1's tempered program and never K3, which
bakes the untempered posterior (so a tempered model outside K1 takes the
plain main block), and no K2 when the likelihood couples into the hypers.
The JAX package's TPU gates (its VMEM budget and measured profitability)
are not carried over.

Memory policy (as the JAX driver's): with ``keep_samples="auto"`` the
recorded samples stay in memory while their projected size is under
2 GiB; above it the run raises before any epoch, since streaming to disk
(``folder_name``) is not carried yet. ``keep_samples=True`` buffers
whatever the size.

Options of the JAX driver that this port does not carry yet raise
``NotImplementedError`` naming them (see ``NOT_CARRIED``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tensorbnn_tpu_torch.likelihoods import Likelihood
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.parallel.chains import init_multichain_state, \
    make_multichain_chunk_runner
from tensorbnn_tpu_torch.sampler.adapter import ParamAdapter
from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
    host_unraveler
from tensorbnn_tpu_torch.sampler.tempering import make_ladder
from tensorbnn_tpu_torch.sampler.uturn import UTurnAdapter

#: JAX-driver options this port does not carry, with the values that mean
#: "off" (any other value raises NotImplementedError)
NOT_CARRIED = {
    "mesh": (None,),
    "checkpoint_dir": (None,),
    "checkpoint_every": (0,),
    "folder_name": (None,),
    "precondition": (False, None),
    "compensated": (False,),
    "numerics": ("default",),
    "data_chunk": (None,),
    "state_layout": ("auto", "flat"),
    "max_dispatch_seconds": (None,),
    "tracer": (None,),
    "metric_list": ((), [], None),
    "keep_samples": ("auto", True),
    "donate": (False,),
}
#: JAX-driver options that only qualify a not-carried option; accepted and
#: unused
INERT = ("networks_per_file", "precondition_clip", "precondition_windows",
         "x_validate", "y_validate")


def _is(value, off) -> bool:
    # None and the booleans match only themselves (precondition=0 is an
    # epoch number, not "off")
    if off is None or isinstance(off, bool) or isinstance(value, bool):
        return value is off
    return type(value) is type(off) and value == off


def check_options(options: dict) -> None:
    """Raises for an option the port does not carry (NotImplementedError)
    or does not know (TypeError)."""
    for name, value in options.items():
        if name in NOT_CARRIED:
            off = NOT_CARRIED[name]
            if not any(_is(value, v) for v in off):
                raise NotImplementedError(
                    f"{name}={value!r} is not carried by tensorbnn_tpu_torch "
                    f"yet (supported: {', '.join(map(repr, off))})")
        elif name not in INERT:
            raise TypeError(f"sample_posterior() got an unexpected keyword "
                            f"argument {name!r}")


@dataclasses.dataclass
class MCMCConfig:
    """Sampler configuration, mirroring the reference ``setupMCMC``."""

    step_size_start: float = 1e-3
    step_size_min: float = 1e-4
    step_size_max: float = 1e-2
    step_size_options: int = 40
    leapfrog_start: int = 1000
    leapfrog_min: int = 100
    leapfrog_max: int = 10000
    leapfrog_increment: int = 1
    hyper_step_size: float = 1e-2
    hyper_leapfrog: int = 100
    burnin: int = 1000
    averaging_steps: int = 10
    a: float = 4.0
    delta: float = 0.1
    max_strikes: int = 50
    random_steps: int = 10
    adapter_seed: int = 0

    def __post_init__(self):
        if self.averaging_steps < 1:
            raise ValueError(
                f"averaging_steps must be >= 1, got {self.averaging_steps}")
        for name in ("leapfrog_start", "leapfrog_min", "leapfrog_max",
                     "hyper_leapfrog"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        for name in ("step_size_start", "step_size_min", "step_size_max",
                     "hyper_step_size"):
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"{name} must be > 0, got {getattr(self, name)}")

    def make_adapter(self, seed: Optional[int] = None) -> ParamAdapter:
        return ParamAdapter(
            e1=self.step_size_start, L1=self.leapfrog_start,
            el=self.step_size_min, eu=self.step_size_max,
            e_number=self.step_size_options,
            Ll=self.leapfrog_min, Lu=self.leapfrog_max,
            l_step=self.leapfrog_increment,
            m=self.averaging_steps,
            k=self.burnin / self.averaging_steps,
            a=self.a, delta=self.delta,
            max_strikes=self.max_strikes,
            random_steps=self.random_steps,
            seed=self.adapter_seed if seed is None else seed)


@dataclasses.dataclass
class RunResult:
    """Outcome of a sampling run."""

    #: posterior samples pooled over chains, chain-major, as numpy trees
    param_samples: tuple
    hyper_samples: tuple
    lik_hyper_samples: dict
    #: per-epoch cross-chain means, shape (epochs,)
    sjd: np.ndarray
    main_accept: np.ndarray
    hyper_accept: np.ndarray
    final_step_size: float
    final_leapfrog: int
    final_hyper_step: float
    n_epochs: int
    n_chains: int
    wall_time: float
    #: raw flat sample stacks: (S, C, D) / (S, C, H)
    theta_samples: np.ndarray = None
    eta_samples: np.ndarray = None
    #: per-epoch main leapfrog count, mean over chains, shape (epochs,);
    #: the executed count of each epoch under ``trajectory="uturn"``
    leapfrog: np.ndarray = None
    #: which blocks ran through the fused kernels (K1 or K3 main, K2 hyper)
    fused_main: bool = False
    fused_hyper: bool = False
    #: what ran the main block: "K1", "K3" or "plain"
    main_path: str = "plain"
    #: per-epoch replica-swap rate (fleet mean; None unless tempering > 1)
    swap_accept: np.ndarray = None
    #: per-epoch per-rung swap rate, shape (epochs, K): rung r's rate
    #: counts exchanges with either neighbour (None unless tempering > 1)
    swap_accept_rung: np.ndarray = None
    #: per-epoch count of chains whose trajectory U-turned within its L
    #: (the rest were censored), shape (epochs,); None unless
    #: ``trajectory="uturn"``
    uturn_turned: np.ndarray = None

    @property
    def theta_pooled(self) -> np.ndarray:
        """(S*C, D), chain-major."""
        s, c, d = self.theta_samples.shape
        return np.transpose(self.theta_samples, (1, 0, 2)).reshape(-1, d)

    @property
    def eta_pooled(self) -> np.ndarray:
        s, c, h = self.eta_samples.shape
        return np.transpose(self.eta_samples, (1, 0, 2)).reshape(-1, h)

    def split_rhat(self) -> np.ndarray:
        """Per-parameter split R-hat over the raw (S, C, D) stack."""
        from tensorbnn_tpu_torch.utils.diagnostics import split_rhat
        return split_rhat(self.theta_samples)

    def multichain_ess(self, max_params: int = 256):
        """Pooled cross-chain ESS of the parameter traces: a ``PooledEss``,
        the worst coordinate's ESS with the breakdown attached."""
        from tensorbnn_tpu_torch.utils.diagnostics import multichain_ess
        return multichain_ess(self.theta_samples, max_params=max_params)

    def summary(self, max_params: int = 256):
        """Per-parameter convergence table (mean, sd, pooled ESS, split
        R-hat) over the raw parameter traces, printable."""
        from tensorbnn_tpu_torch.utils.diagnostics import summary
        return summary(self.theta_samples, max_params=max_params)


def sample_posterior(model: Sequential, likelihood: Likelihood,
                     x_train: torch.Tensor, y_train: torch.Tensor, *,
                     config: MCMCConfig,
                     params: tuple, hypers: tuple,
                     generator: torch.Generator,
                     epochs: int,
                     sampling_step: int,
                     adjust_hypers: bool = True,
                     display_skip: int = 0,
                     n_chains: int = 1,
                     n_adapters: int = 1,
                     chain_jitter: float = 0.0,
                     use_fused="auto",
                     verbose: bool = True,
                     tempering: int = 1,
                     tempering_beta_min: float = 0.1,
                     trajectory: str = "adapter",
                     uturn_probe: str = "alternate",
                     **options) -> RunResult:
    """Runs the two-block adaptive HMC sampler on the device of
    ``x_train`` (``params``, ``hypers`` and ``generator`` live there too).

    Posterior networks are recorded every ``sampling_step`` epochs after
    ``config.burnin``. ``n_adapters`` splits the chains into that many
    equal groups with their own GP-UCB adapter (seeds ``adapter_seed +
    g``). ``use_fused``: "auto"/True build the fused kernels for in-scope
    models, False forces the plain path. ``tempering`` > 1 runs parallel
    tempering over that many rungs, the hottest at ``tempering_beta_min``
    (one adapter per rung, seeds ``adapter_seed + r``). ``trajectory``:
    "adapter" tunes ``(eps, L)`` with the GP-UCB adapters, "uturn" with
    the ``UTurnAdapter`` (see the module docstring; one adapter, no
    tempering); ``uturn_probe`` is its burn-in probe schedule, "alternate"
    or "always".
    """
    t_start = time.time()
    if n_adapters < 1 or n_chains % n_adapters:
        raise ValueError(f"n_adapters ({n_adapters}) must be >= 1 and "
                         f"divide n_chains ({n_chains})")
    # the trajectory's and tempering's own errors come first, with the JAX
    # driver's messages (tensorbnn_tpu/sampler/driver.py:486-531), for
    # options the port does not carry as well
    if trajectory not in ("adapter", "uturn"):
        raise ValueError(
            f"trajectory must be 'adapter' or 'uturn', got {trajectory!r}")
    traj_uturn = trajectory == "uturn"
    if traj_uturn and n_adapters != 1:
        raise ValueError(
            "trajectory='uturn' shares one dynamic length schedule "
            "across the fleet (one wave front); it is incompatible with "
            "n_adapters > 1")
    if tempering < 1:
        raise ValueError(f"tempering must be >= 1, got {tempering}")
    tempering_beta = None
    fleet_chains = n_chains
    if tempering > 1:
        if traj_uturn:
            raise ValueError(
                "tempering is incompatible with trajectory='uturn' (the "
                "shared U-turn schedule would mix feedback across "
                "temperatures; each rung needs its own trajectory tuning, "
                "which the per-rung GP adapters provide)")
        if n_adapters != 1:
            raise ValueError(
                "tempering assigns one adapter group per rung; it is "
                "incompatible with an explicit n_adapters > 1")
        precondition = options.get("precondition", False)
        if precondition is not False and precondition is not None:
            raise ValueError(
                "tempering is incompatible with precondition: the "
                "cross-chain spread mixes temperatures, and the diagonal "
                "metric was measured to hurt multimodal targets")
        if options.get("state_layout") == "tree":
            raise ValueError("tempering requires the flat state layout")
        ladder = make_ladder(tempering, tempering_beta_min)
        fleet_chains = n_chains * tempering
        tempering_beta = (tempering, np.repeat(ladder, n_chains))
    check_options(options)
    if use_fused not in ("auto", True, False):
        raise ValueError(f"use_fused must be 'auto', True or False, got "
                         f"{use_fused!r}")
    device, dtype = x_train.device, x_train.dtype
    lik_hypers = likelihood.init_hypers(dtype, device)
    flat = flatten_state(params, hypers, lik_hypers)
    eta_dim = flat.eta.numel()

    # memory policy: refuse a run whose samples would not fit in memory
    # before it spends any time (JAX driver.py:786-800)
    n_expected = max(0, epochs // sampling_step
                     - config.burnin // sampling_step)
    projected = n_expected * n_chains * (flat.theta.numel() + eta_dim) * 4
    if options.get("keep_samples", "auto") == "auto" and \
            projected >= (2 << 30):
        raise ValueError(
            f"keep_samples='auto' with a ~{projected / 1e9:.1f}GB projected "
            f"posterior ({n_expected} recorded epochs x {n_chains} chains) "
            f"and no folder_name would not fit in memory; pass "
            f"keep_samples=True to buffer it anyway, or record fewer "
            f"epochs (sampling_step)")

    tempered = tempering_beta is not None
    main_traj = main_vg = hyper_traj = None
    if use_fused:
        from tensorbnn_tpu_torch.ops.fused_hyper import \
            try_build_fused_hyper_trajectory
        from tensorbnn_tpu_torch.ops.fused_mlp import \
            try_build_fused_main_vg, try_build_fused_trajectory
        main_traj = try_build_fused_trajectory(
            model, likelihood, flat.unravel_theta, flat.unravel_eta,
            x_train, y_train, eta_dim=eta_dim, tempered=tempered,
            record_uturn=traj_uturn)
        if main_traj is None and not tempered:
            main_vg = try_build_fused_main_vg(
                model, likelihood, flat.unravel_theta, flat.unravel_eta,
                x_train, y_train, eta_dim=eta_dim)
        # beta scales a coupled likelihood's term of the hyper potential,
        # which K2 does not take: such tempered runs use the plain block
        if adjust_hypers and not (tempered
                                  and likelihood.main_probs_in_hypers):
            hyper_traj = try_build_fused_hyper_trajectory(
                model, likelihood, flat.unravel_eta, eta_dim,
                config.hyper_leapfrog)
    main_path = "K1" if main_traj else "K3" if main_vg else "plain"
    if verbose:
        print(f"main block: "
              f"{'plain' if main_path == 'plain' else 'fused ' + main_path}"
              f"{f' (tempered, {tempering} rungs)' if tempered else ''}"
              f"{' (U-turn recording)' if traj_uturn else ''}; "
              f"hyper block: {'fused K2' if hyper_traj else 'plain'} "
              f"(device {device})")

    run_chunk = make_multichain_chunk_runner(
        model, likelihood, x_train, y_train, flat.unravel_theta,
        flat.unravel_eta, adjust_hypers=adjust_hypers,
        hyper_leapfrog=config.hyper_leapfrog, burnin=float(config.burnin),
        hyper_step_size_init=config.hyper_step_size, eta_dim=eta_dim,
        batched_main_vg=main_vg, batched_main_traj=main_traj,
        batched_hyper_traj=hyper_traj, tempering_beta=tempering_beta,
        record_uturn=traj_uturn, per_epoch_leapfrog=traj_uturn)
    carry = init_multichain_state(flat.theta, flat.eta,
                                  config.hyper_step_size, fleet_chains,
                                  generator, jitter=chain_jitter)

    # adapter groups: the n_adapters groups, or one per tempering rung
    n_grp = tempering if tempered else n_adapters
    grp_chains = fleet_chains // n_grp
    # U-turn runs replay the UTurnAdapter instead of GP-UCB adapters
    adapters = [] if traj_uturn else [config.make_adapter(
        seed=config.adapter_seed + g if n_grp > 1 else None)
        for g in range(n_grp)]
    if traj_uturn:
        uturn_ad = UTurnAdapter(
            step_size_start=config.step_size_start,
            step_size_min=config.step_size_min,
            step_size_max=config.step_size_max,
            leapfrog_start=config.leapfrog_start,
            leapfrog_min=config.leapfrog_min,
            leapfrog_max=config.leapfrog_max,
            burnin=config.burnin, seed=config.adapter_seed,
            probe=uturn_probe)
    step_sizes = np.full(n_grp, config.step_size_start, np.float64)
    leapfrogs = np.full(n_grp, config.leapfrog_start, np.int64)

    theta_rows, eta_rows = [], []
    sjds, main_accepts, hyper_accepts, leaps = [], [], [], []
    swap_accepts, swap_rung_accepts, turned = [], [], []
    iter_ = 0
    while iter_ < epochs:
        if traj_uturn:
            # burn-in chunks keep the step-size updates frequent and end on
            # the burn-in boundary; sampling chunks are long (JAX
            # driver.py:1073-1084)
            if iter_ < config.burnin:
                chunk = min(max(1, config.averaging_steps),
                            config.burnin - iter_, epochs - iter_)
            else:
                chunk = min(50, epochs - iter_)
            eps_arg, leap_arg = uturn_ad.plan_chunk(iter_, chunk)
        else:
            chunk = min(min(a.epochs_until_next_change() for a in adapters),
                        epochs - iter_)
            if n_grp == 1:
                eps_arg, leap_arg = float(step_sizes[0]), int(leapfrogs[0])
            else:
                eps_arg = np.repeat(step_sizes, grp_chains).astype(
                    np.float32)
                leap_arg = np.repeat(leapfrogs, grp_chains)
        carry, trace = run_chunk(carry, eps_arg, leap_arg, chunk, generator)
        leaps.append(np.asarray(leap_arg, np.float64) if traj_uturn
                     else np.full(chunk, leapfrogs.mean()))

        rows = [j for j in range(chunk)
                if iter_ + j + 1 > config.burnin
                and (iter_ + j + 1) % sampling_step == 0]
        if rows:
            # the cold chains only: hot replicas sample flattened targets
            theta_rows.append(trace.theta[rows, :n_chains])
            eta_rows.append(trace.eta[rows, :n_chains])
        # one device-to-host transfer of the chunk's diagnostics
        fields = [trace.sjd, trace.main_accept, trace.hyper_accept]
        if tempered:
            fields.append(trace.swap_accept)
        if traj_uturn:
            # the step counts ride the same transfer, exact in float32
            fields.append(trace.uturn.to(trace.sjd.dtype))
        sjd, m_acc, h_acc, *extra = torch.stack(fields).cpu().numpy()
        swap = extra if tempered else []
        # each group's (each rung's) mean SJD feeds its adapter; the
        # recorded diagnostics cover the cold chains
        sjd_grp = sjd.reshape(chunk, n_grp, grp_chains).mean(axis=2)
        sjds.append(sjd[:, :n_chains].mean(axis=1))
        main_accepts.append(m_acc[:, :n_chains].mean(axis=1))
        hyper_accepts.append(h_acc[:, :n_chains].mean(axis=1))
        if swap:
            swap_accepts.append(swap[0].mean(axis=1))
            swap_rung_accepts.append(
                swap[0].reshape(chunk, tempering, n_chains).mean(axis=2))

        if traj_uturn:
            # the chunk's acceptance and U-turn steps feed the schedule
            # (burn-in epochs only)
            uturn_ad.observe(iter_, m_acc.mean(axis=1),
                             extra[0].astype(np.int64), leap_arg)
            turned.append((extra[0] > 0).sum(axis=1))
            step_sizes[0] = float(uturn_ad.eps)
            leapfrogs[0] = int(uturn_ad.l_hat)

        for j in range(chunk):
            iter_ += 1
            # the reference's first adapter call carries no SJD
            for g, a in enumerate(adapters):
                e_g, l_g = a.update(
                    None if iter_ == 1 else float(sjd_grp[j, g]))
                step_sizes[g] = float(np.clip(e_g, 1e-12, None))
                leapfrogs[g] = int(l_g)
            if display_skip and iter_ % display_skip == 0 and verbose:
                print(f"iter {iter_}: step size {step_sizes.tolist()}, "
                      f"leapfrog {leapfrogs.tolist()}, main acceptance "
                      f"{m_acc[j, :n_chains].mean():.4f}, hyper acceptance "
                      f"{h_acc[j, :n_chains].mean():.4f}"
                      + (f", swap rate {swap[0][j].mean():.4f}" if swap
                         else ""))

    if theta_rows:
        theta_stack = torch.cat(theta_rows).cpu().numpy()   # (S, C, D)
        eta_stack = torch.cat(eta_rows).cpu().numpy()
        s, c, d = theta_stack.shape
        pooled_theta = np.transpose(theta_stack, (1, 0, 2)).reshape(s * c, d)
        pooled_eta = np.transpose(eta_stack, (1, 0, 2)).reshape(s * c, -1)
        param_samples = host_unraveler(params)(pooled_theta)
        hyper_samples, lik_hyper_samples = host_unraveler(
            (hypers, lik_hypers))(pooled_eta)
    else:
        theta_stack = np.zeros((0, n_chains, flat.theta.numel()), np.float32)
        eta_stack = np.zeros((0, n_chains, eta_dim), np.float32)
        param_samples = tuple({} for _ in model.layers)
        hyper_samples = tuple({} for _ in model.layers)
        lik_hyper_samples = {}

    return RunResult(
        param_samples=param_samples,
        hyper_samples=hyper_samples,
        lik_hyper_samples=lik_hyper_samples,
        sjd=np.concatenate(sjds) if sjds else np.zeros(0),
        main_accept=(np.concatenate(main_accepts) if main_accepts
                     else np.zeros(0)),
        hyper_accept=(np.concatenate(hyper_accepts) if hyper_accepts
                      else np.zeros(0)),
        swap_accept=(np.concatenate(swap_accepts) if swap_accepts
                     else None),
        swap_accept_rung=(np.concatenate(swap_rung_accepts)
                          if swap_rung_accepts else None),
        uturn_turned=np.concatenate(turned) if traj_uturn else None,
        leapfrog=np.concatenate(leaps) if leaps else np.zeros(0),
        final_step_size=float(np.mean(step_sizes)),
        final_leapfrog=int(round(float(np.mean(leapfrogs)))),
        final_hyper_step=float(carry.hyper_step.mean()),
        n_epochs=iter_,
        n_chains=n_chains,
        wall_time=time.time() - t_start,
        theta_samples=theta_stack,
        eta_samples=eta_stack,
        fused_main=main_path != "plain",
        fused_hyper=hyper_traj is not None,
        main_path=main_path)
