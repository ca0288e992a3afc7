"""K2: the fused hyper-block trajectory, and its plain twin.

Counterpart of ``tensorbnn_tpu/ops/fused_hyper.py``.
``try_build_fused_hyper_trajectory`` returns ``traj(etas (C, H), stats
(C, S), momenta (C, H), eps (C,)) -> (q (C, H), v (C, H), lp0 (C,), lp1
(C,))``: all ``n_steps`` hyper leapfrog steps of one epoch per chain, on
the sufficient-statistics potential (sampler/hyper_stats.py), whose stats
rows it consumes. The MH accept stays with the caller.

On CUDA tensors ``traj`` launches ``csrc/fused_hyper.cu``, or raises; on
CPU tensors it runs ``hyper_trajectory_plain``, the same trajectory with
the closed-form value and gradient written out in batched torch ops. The
kernel runs each item of the potential (a dense block's weights' or
biases' (loc, scale) pair, or the coupled term) on a lane of its own, from
the item table that ``HyperProgram`` decides and the C entry point checks.
Scope is the stats potential's: Gaussian dense layers under a fixed-sd
Gaussian, Bernoulli or categorical likelihood (uncoupled) or a learned-sd
Gaussian one (the coupled ``(R, K)`` term).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, ClassVar, Optional

import numpy as np
import torch

from tensorbnn_tpu_torch.ops import _build

LOG_2PI = math.log(2.0 * math.pi)
SD_LO, SD_HI = 1e-8, 1e8
MAX_H = 64
MAX_STATS = 64
MAX_BLOCKS = 16


@dataclasses.dataclass
class HyperProgram:
    """K2's layout: per dense block the eta rows ``(w_loc, w_scale, b_loc,
    b_scale)`` and the weight and bias counts ``(k_w, k_b)``; and the item
    table, lanes and block size the kernel runs it with."""

    blocks: tuple
    coupled: bool
    sd_idx: int
    eta_dim: int
    n_steps: int
    #: threads per block: 64 chains at 8 lanes a chain spread over 8 SMs.
    #: On the H100, 32, 64 and 128 threads time within 1.5% of each other
    #: from 8 to 2,048 chains, and 256 4-9% slower (PERF.md)
    threads: ClassVar[int] = 64

    @property
    def n_stats(self) -> int:
        return 4 * len(self.blocks) + (2 if self.coupled else 0)

    @functools.cached_property
    def items(self) -> tuple:
        """One row per item of the potential, in the value's order, each
        run by a lane of its own: per dense block its weights' and then its
        biases' ``(loc_row, scale_row, S1's column, S2's column, k)``; then,
        if coupled, ``(sd_idx, -1, R's column, K's column, 0)``."""
        out = []
        for j, (wl, ws, bl, bs, k_w, k_b) in enumerate(self.blocks):
            out.append((wl, ws, 4 * j, 4 * j + 1, k_w))
            out.append((bl, bs, 4 * j + 2, 4 * j + 3, k_b))
        if self.coupled:
            n = 4 * len(self.blocks)
            out.append((self.sd_idx, -1, n, n + 1, 0))
        return tuple(out)

    @functools.cached_property
    def lanes(self) -> int:
        """Lanes a chain: the least power of two at or above its items (at
        most 32, so a chain's items share one warp)."""
        return 1 << (len(self.items) - 1).bit_length()

    @functools.cached_property
    def table(self) -> np.ndarray:
        """The host item table the C entry point checks and hands the
        kernel."""
        return np.ascontiguousarray(np.asarray(self.items,
                                               np.int32).reshape(-1))


def build_hyper_program(model, likelihood, unravel_eta, eta_dim: int,
                        n_steps: int) -> Optional[HyperProgram]:
    """The K2 layout, or None when the stats potential does not apply."""
    from tensorbnn_tpu_torch.sampler.hyper_stats import probe_stats_layout

    layout = probe_stats_layout(model, likelihood, unravel_eta, eta_dim)
    if layout is None:
        return None
    dense_layers, coupled, sd_idx = layout
    blocks = tuple((idx["w_loc"], idx["w_scale"], idx["b_loc"],
                    idx["b_scale"], int(k_w), int(k_b))
                   for _, idx, k_w, k_b in dense_layers)
    program = HyperProgram(blocks, bool(coupled),
                           -1 if sd_idx is None else int(sd_idx),
                           int(eta_dim), int(n_steps))
    if (eta_dim > MAX_H or program.n_stats > MAX_STATS
            or len(blocks) > MAX_BLOCKS):
        return None
    return program


def try_build_fused_hyper_trajectory(model, likelihood, unravel_eta,
                                     eta_dim: int,
                                     n_steps: int) -> Optional[Callable]:
    """``traj(etas, stats, momenta, eps)`` for an in-scope model, else
    None (the caller then takes the plain ``hmc_step_batched`` path)."""
    program = build_hyper_program(model, likelihood, unravel_eta, eta_dim,
                                  n_steps)
    if program is None:
        return None
    return functools.partial(fused_hyper_trajectory, program)


def fused_hyper_trajectory(program: HyperProgram, etas, stats, momenta,
                           eps):
    """K2's wrapper: CUDA tensors launch the kernel, CPU tensors run
    ``hyper_trajectory_plain``. Counts its kernel launches in
    ``LAUNCHES``."""
    c = etas.shape[0]
    if torch.is_tensor(eps) and eps.ndim == 1:
        eps_c = eps.to(device=etas.device, dtype=torch.float32)
    else:
        eps_c = torch.full((c,), float(eps), dtype=torch.float32,
                           device=etas.device)
    if etas.device.type == "cpu":
        return hyper_trajectory_plain(program, etas, stats, momenta, eps_c)
    if etas.device.type != "cuda":
        raise ValueError(f"fused_hyper_trajectory: unsupported device "
                         f"{etas.device}")
    shapes = {"etas": (c, program.eta_dim), "stats": (c, program.n_stats),
              "momenta": (c, program.eta_dim), "eps": (c,)}
    for name, t in (("etas", etas), ("stats", stats), ("momenta", momenta),
                    ("eps", eps_c)):
        if t.device != etas.device or t.dtype != torch.float32:
            raise ValueError(f"fused_hyper_trajectory: {name} must be "
                             f"float32 on {etas.device}, got {t.dtype} on "
                             f"{t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_hyper_trajectory: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
    etas, stats, momenta, eps_c = (t.contiguous() for t in
                                   (etas, stats, momenta, eps_c))
    q = torch.empty_like(etas)
    v = torch.empty_like(etas)
    lp0 = torch.empty(c, dtype=torch.float32, device=etas.device)
    lp1 = torch.empty_like(lp0)
    lib = _build.load()
    # the library launches on the current device: make it the tensors'
    with torch.cuda.device(etas.device):
        rc = lib.tbnn_fused_hyper(
            etas.data_ptr(), momenta.data_ptr(), stats.data_ptr(),
            eps_c.data_ptr(), program.table.ctypes.data, len(program.items),
            int(program.coupled), c, program.eta_dim, program.n_stats,
            program.n_steps, program.lanes, program.threads, q.data_ptr(),
            v.data_ptr(), lp0.data_ptr(), lp1.data_ptr(),
            torch.cuda.current_stream(etas.device).cuda_stream)
    _build.check(rc, "fused_hyper_trajectory")
    fused_hyper_trajectory.LAUNCHES += 1
    return q, v, lp0, lp1


fused_hyper_trajectory.LAUNCHES = 0


def stats_value_and_grad(program: HyperProgram, eta, stats):
    """Closed-form value ``(C,)`` and gradient ``(C, H)`` of the stats hyper
    potential, term by term as the kernel computes them."""
    lp = torch.zeros(eta.shape[0], dtype=eta.dtype, device=eta.device)
    grad = torch.zeros_like(eta)
    hyper_const = -2.0 * (math.log(0.1) + 0.5 * LOG_2PI)
    for j, (wl, ws, bl, bs, k_w, k_b) in enumerate(program.blocks):
        for loc_row, scale_row, s1, s2, k in (
                (wl, ws, stats[:, 4 * j], stats[:, 4 * j + 1], float(k_w)),
                (bl, bs, stats[:, 4 * j + 2], stats[:, 4 * j + 3],
                 float(k_b))):
            loc = eta[:, loc_row]
            s = eta[:, scale_row]
            u = s * s
            # hyperpriors: N(0, .1) on loc, N(1, .1) on the squared scale
            z_loc, z_u = loc / 0.1, (u - 1.0) / 0.1
            lp = lp - 0.5 * (z_loc * z_loc + z_u * z_u) + hyper_const
            grad[:, loc_row] += -loc / 0.01
            g_scale = (-(u - 1.0) / 0.01) * (2.0 * s)
            # conditional prior via (S1, S2), sd = clip(scale ** 2)
            in_range = (u >= SD_LO) & (u <= SD_HI)
            sd = u.clamp(SD_LO, SD_HI)
            quad_num = s2 - 2.0 * loc * s1 + k * loc * loc
            inv_sd2 = 1.0 / (sd * sd)
            lp = lp - 0.5 * (2.0 * torch.log(sd) + quad_num * inv_sd2
                             + LOG_2PI)
            grad[:, loc_row] += (s1 - k * loc) * inv_sd2
            d_sd = -1.0 / sd + quad_num * inv_sd2 / sd
            g_scale = g_scale + torch.where(in_range, d_sd * 2.0 * s, 0.0)
            grad[:, scale_row] += g_scale
    if program.coupled:
        e = eta[:, program.sd_idx]
        u = e * e
        in_range = (u >= SD_LO) & (u <= SD_HI)
        sd = u.clamp(SD_LO, SD_HI)
        r, k = stats[:, -2], stats[:, -1]
        inv_sd2 = 1.0 / (sd * sd)
        lp = lp - 0.5 * (2.0 * k * torch.log(sd) + r * inv_sd2 + k * LOG_2PI)
        d_sd = -k / sd + r * inv_sd2 / sd
        grad[:, program.sd_idx] += torch.where(in_range, d_sd * 2.0 * e, 0.0)
    return lp, grad


def hyper_trajectory_plain(program: HyperProgram, etas, stats, momenta,
                           eps_c):
    """The K2 trajectory in batched torch ops."""
    q, v = etas, momenta
    n = program.n_steps
    lp0 = lp = None
    for i in range(n + 1):
        lp, g = stats_value_and_grad(program, q, stats)
        if i == 0:
            lp0 = lp
        kick = 0.5 * eps_c if i in (0, n) else eps_c
        v = v + kick[:, None] * g
        if i < n:
            q = q + eps_c[:, None] * v
    return q, v, lp0, lp
