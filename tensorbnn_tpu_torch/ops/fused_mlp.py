"""K1 and K3: the fused main-block kernels, and their plain twins.

Counterpart of ``tensorbnn_tpu/ops/fused_mlp.py``. Both kernels run a dense
stack given as an op program (``_model_program``) whose flat row layout
``verify_theta_layout`` checks.

K1, ``try_build_fused_trajectory``, returns ``traj(thetas (C, D), etas (C,
H), momenta (C, D), x, y, eps, L) -> (q (C, D), v (C, D), lp0 (C,), lp1
(C,))``: one whole leapfrog trajectory per chain, ``lp0``/``lp1`` the log
posterior at its start and end. The MH accept stays with the caller
(sampler/gibbs.py). On CUDA tensors ``traj`` launches the hand-written
kernel ``csrc/fused_trajectory.cu``, or raises; on CPU tensors it runs
``trajectory_plain``, the same trajectory in batched torch ops. ``eps`` and
``L`` are shared (a float and an int) or per chain (``(C,)`` tensors on the
chains' device); every chain runs exactly its own ``L``. Built with
``tempered=True`` (parallel tempering), ``traj`` takes a trailing ``betas
(C,)`` of per-chain inverse temperatures and integrates the power posterior
``prior + beta * loglik``. Built with ``record_uturn=True`` (the driver's
``trajectory="uturn"``), ``traj`` returns a trailing ``uturn (C,)`` int32:
each chain's first U-turn step, 0 when censored. Scope: dense layers with
Gaussian priors and tanh / relu / sigmoid / exp / elu activations under a
fixed-sd Gaussian likelihood, within one block's shared memory.

K3, ``try_build_fused_main_vg``, returns ``batched_main_vg(thetas (C, D),
etas (C, H), x, y) -> (lp (C,), grad (C, D))``: one log-posterior value and
gradient per chain, for ``hmc_step_batched``. The likelihood half comes from
``fused_potential``, which on CUDA tensors launches ``csrc/fused_potential.cu``
(or raises) and on CPU tensors runs ``potential_plain``; the prior half is
added outside the kernel, as the JAX package adds it. Scope: Gaussian or
Cauchy dense layers, the same activations, each following a dense layer,
and a Gaussian likelihood with a fixed sd or a learned one (``sd_root``, the
last eta coordinate). The driver builds K3 where K1 declines a model: a
learned sd, Cauchy priors, or planes too wide for shared memory.

Not ported: the Bernoulli and categorical tails, the leakyrelu / prelu /
sqprelu activations, and K3's data-axis ``psum``. Deliberate divergences: the TPU's VMEM gates
(``kernel_vmem_bytes``, ``trajectory_vmem_bytes``), its chain blocks
(``choose_block_c``) and the TPU-measured ``fused_profitable`` gate do not
apply on the H100. K3 keeps its planes in device memory and so has no size
gate; K1's only gate is one block's shared memory.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tensorbnn_tpu_torch.ops import _build

LOG_2PI = math.log(2.0 * math.pi)

#: activation codes of K1's op program (csrc/fused_trajectory.cu); K3's
#: layer table (csrc/fused_potential.cu) uses them with 0 for none
OP_CODES = {"dense": 0, "tanh": 1, "relu": 2, "sigmoid": 3, "exp": 4,
            "elu": 5}
MAX_OPS = 32
MAX_PRIOR_BLOCKS = 64
#: threads per chain's block
THREADS = 128
#: dynamic shared memory one block may take: the H100's 227 KB per block
#: less room for the kernel's static tables
SMEM_BUDGET_BYTES = 232448 - 4096


# --------------------------------------------------------------------------
# Op program: a linear pipeline of ("dense", d_in, d_out) and (act, d)
# --------------------------------------------------------------------------

def _op_rows(op) -> int:
    return op[2] + op[1] * op[2] if op[0] == "dense" else 0


def _program_dims(ops) -> Tuple[int, int, int]:
    """Returns (d0, d_final, total theta rows)."""
    d = ops[0][1]
    d0 = d
    for op in ops:
        d = op[2] if op[0] == "dense" else op[1]
    return d0, d, sum(_op_rows(op) for op in ops)


def _model_program(model, dense_types) -> Optional[tuple]:
    """Pattern-matches ``model`` to the op program, or None when a layer is
    outside it (dense layers of ``dense_types``, the activations of
    ``OP_CODES``)."""
    from tensorbnn_tpu_torch.models.layers import Activation

    ops, d = [], None
    for layer in model.layers:
        if isinstance(layer, dense_types):
            if d is not None and d != layer.in_dim:
                return None
            ops.append(("dense", int(layer.in_dim), int(layer.out_dim)))
            d = int(layer.out_dim)
        elif isinstance(layer, Activation):
            name = {"Exp": "exp"}.get(layer.name, layer.name)
            if d is None or name not in OP_CODES:
                return None
            ops.append((name, d))
        else:
            return None
    if d is None:
        return None
    return tuple(ops)


def verify_theta_layout(unravel_theta, ops) -> bool:
    """Checks the flat layout matches the kernel's row contract: per dense
    layer, bias rows then row-major ``(in, out)`` weight rows."""
    _, _, d_total = _program_dims(ops)
    try:
        probe = unravel_theta(np.arange(d_total))
    except ValueError:
        return False
    row_ops = [op for op in ops if _op_rows(op)]
    off, oi = 0, 0
    for layer_params in probe:
        if not layer_params:
            continue
        if oi >= len(row_ops) or set(layer_params) != {"b", "w"}:
            return False
        _, d_in, d_out = row_ops[oi]
        want_w = np.arange(off + d_out, off + d_out + d_in * d_out)
        if not (np.array_equal(layer_params["b"],
                               np.arange(off, off + d_out))
                and np.array_equal(layer_params["w"],
                                   want_w.reshape(d_in, d_out))):
            return False
        off += _op_rows(row_ops[oi])
        oi += 1
    return oi == len(row_ops) and off == d_total


@dataclasses.dataclass
class TrajectoryProgram:
    """Everything K1 needs besides the state: the op program, the prior
    blocks ``(start_row, rows, loc_eta_idx, scale_eta_idx)`` covering the
    flat state in row order, the likelihood's fixed sd, whether the
    likelihood is tempered by per-chain betas, and whether the trajectory
    records each chain's first U-turn step."""

    ops: tuple
    prior_blocks: tuple
    sd: float
    n_rows: int
    eta_dim: int
    tempered: bool = False
    record_uturn: bool = False
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return _program_dims(self.ops)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one chain's block: q, v, g, every
        activation plane and two backward planes (the layout of
        csrc/fused_trajectory.cu)."""
        d0, _, d_total = self.dims
        widths = [d0] + [op[2] if op[0] == "dense" else op[1]
                         for op in self.ops]
        n = self.n_rows
        return 4 * (3 * d_total + n * sum(widths) + 2 * n * max(widths))

    def tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The op and prior tables as int32 tensors on ``device``."""
        key = str(device)
        if key not in self._tables:
            ops = [(OP_CODES[op[0]], op[1], op[2] if op[0] == "dense"
                    else op[1]) for op in self.ops]
            prior = [(0, rows, i_loc, i_scale)
                     for _, rows, i_loc, i_scale in self.prior_blocks]
            self._tables[key] = (
                torch.tensor(ops, dtype=torch.int32, device=device),
                torch.tensor(prior, dtype=torch.int32, device=device))
        return self._tables[key]


def gaussian_prior_blocks(model, unravel_eta, eta_dim: int
                          ) -> Optional[tuple]:
    """The closed-form prior blocks ``(start_row, rows, loc_eta_idx,
    scale_eta_idx)`` of a model whose layers with hypers are all
    ``GaussianDenseLayer``s, in flat row order; None otherwise."""
    from tensorbnn_tpu_torch.models.layers import GaussianDenseLayer
    from tensorbnn_tpu_torch.sampler.potential import eta_index_probe

    probe_h, _ = eta_index_probe(unravel_eta, eta_dim)
    blocks, start = [], 0
    for layer, h in zip(model.layers, probe_h):
        if not h:
            continue
        if not isinstance(layer, GaussianDenseLayer):
            return None
        for rows, loc, scale in ((layer.out_dim, "b_loc", "b_scale"),
                                 (layer.in_dim * layer.out_dim, "w_loc",
                                  "w_scale")):
            blocks.append((start, rows, int(h[loc]), int(h[scale])))
            start += rows
    return tuple(blocks)


def build_trajectory_program(model, likelihood, unravel_theta, unravel_eta,
                             eta_dim: int, n_rows: int,
                             tempered: bool = False,
                             record_uturn: bool = False
                             ) -> Optional[TrajectoryProgram]:
    """The K1 program for ``(model, likelihood)``, or None when out of
    scope (see the module docstring) or over the shared-memory budget;
    ``tempered`` builds the power-posterior program, ``record_uturn`` the
    U-turn-recording one."""
    from tensorbnn_tpu_torch.likelihoods import FixedGaussianLikelihood
    from tensorbnn_tpu_torch.models.layers import GaussianDenseLayer

    if not isinstance(likelihood, FixedGaussianLikelihood):
        return None
    ops = _model_program(model, (GaussianDenseLayer,))
    if ops is None or not verify_theta_layout(unravel_theta, ops):
        return None
    blocks = gaussian_prior_blocks(model, unravel_eta, eta_dim)
    program = TrajectoryProgram(ops, blocks, float(likelihood.sd),
                                int(n_rows), int(eta_dim), bool(tempered),
                                bool(record_uturn))
    if (len(ops) > MAX_OPS or len(blocks) > MAX_PRIOR_BLOCKS
            or sum(b[1] for b in blocks) != program.dims[2]
            or program.smem_bytes > SMEM_BUDGET_BYTES):
        return None
    return program


def try_build_fused_trajectory(model, likelihood, unravel_theta,
                               unravel_eta, x, y, eta_dim: int,
                               n_rows: Optional[int] = None,
                               tempered: bool = False,
                               record_uturn: bool = False
                               ) -> Optional[Callable]:
    """``traj(thetas, etas, momenta, x, y, eps, L)`` (with a trailing
    ``betas`` when ``tempered``; returning a trailing ``uturn`` when
    ``record_uturn``) for an in-scope model, else None (the caller then
    takes the plain ``hmc_step_batched`` path)."""
    del y
    n = int(n_rows if n_rows is not None else x.shape[0])
    program = build_trajectory_program(model, likelihood, unravel_theta,
                                       unravel_eta, eta_dim, n, tempered,
                                       record_uturn)
    if program is None:
        return None
    return functools.partial(fused_trajectory, program)


def per_chain(eps, n_leapfrog, c: int, device):
    """``(eps (C,) float32, L (C,) int32)`` on ``device`` from shared
    scalars or per-chain vectors."""
    if torch.is_tensor(eps) and eps.ndim == 1:
        eps_c = eps.to(device=device, dtype=torch.float32)
    else:
        eps_c = torch.full((c,), float(eps), dtype=torch.float32,
                           device=device)
    if torch.is_tensor(n_leapfrog) and n_leapfrog.ndim == 1:
        l_c = n_leapfrog.to(device=device, dtype=torch.int32)
    else:
        l_c = torch.full((c,), int(n_leapfrog), dtype=torch.int32,
                         device=device)
    return eps_c, l_c


def fused_trajectory(program: TrajectoryProgram, thetas, etas, momenta, x,
                     y, eps, n_leapfrog, betas=None):
    """K1's wrapper: CUDA tensors launch the kernel, CPU tensors run
    ``trajectory_plain``. A tempered program needs ``betas (C,)`` (an
    untempered one ignores them, as the JAX package's does). Returns ``(q,
    v, lp0, lp1)``, and ``uturn (C,)`` int32 after them when the program
    records. Counts its kernel launches in ``LAUNCHES``."""
    if program.tempered and betas is None:
        raise TypeError("tempered trajectory kernel requires betas")
    c = thetas.shape[0]
    d0, dk, d_total = program.dims
    n = program.n_rows
    eps_c, l_c = per_chain(eps, n_leapfrog, c, thetas.device)
    beta_c = (torch.as_tensor(betas, dtype=torch.float32,
                              device=thetas.device)
              if program.tempered else None)
    if thetas.device.type == "cpu":
        return trajectory_plain(program, thetas, etas, momenta, x, y, eps_c,
                                l_c, beta_c)
    x = x.reshape(n, d0)
    y = y.reshape(n, dk)
    if thetas.device.type != "cuda":
        raise ValueError(f"fused_trajectory: unsupported device "
                         f"{thetas.device}")
    tensors = {"thetas": thetas, "etas": etas, "momenta": momenta, "x": x,
               "y": y, "eps": eps_c, "L": l_c}
    shapes = {"thetas": (c, d_total), "etas": (c, program.eta_dim),
              "momenta": (c, d_total), "x": (n, d0), "y": (n, dk),
              "eps": (c,), "L": (c,), "betas": (c,)}
    if beta_c is not None:
        tensors["betas"] = beta_c
    for name, t in tensors.items():
        dtype = torch.int32 if name == "L" else torch.float32
        if t.device != thetas.device or t.dtype != dtype:
            raise ValueError(f"fused_trajectory: {name} must be {dtype} on "
                             f"{thetas.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_trajectory: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
    thetas, etas, momenta, x, y, eps_c, l_c = (
        t.contiguous() for t in (thetas, etas, momenta, x, y, eps_c, l_c))
    beta_ptr = None if beta_c is None else beta_c.contiguous()
    ops_t, prior_t = program.tables(thetas.device)
    q = torch.empty_like(thetas)
    v = torch.empty_like(thetas)
    lp0 = torch.empty(c, dtype=torch.float32, device=thetas.device)
    lp1 = torch.empty_like(lp0)
    ut = (torch.empty(c, dtype=torch.int32, device=thetas.device)
          if program.record_uturn else None)
    lib = _build.load()
    rc = lib.tbnn_fused_trajectory(
        thetas.data_ptr(), momenta.data_ptr(), etas.data_ptr(),
        x.data_ptr(), y.data_ptr(), eps_c.data_ptr(), l_c.data_ptr(),
        None if beta_ptr is None else beta_ptr.data_ptr(),
        ops_t.data_ptr(), len(program.ops), prior_t.data_ptr(),
        len(program.prior_blocks), c, d_total, program.eta_dim, n,
        program.sd, THREADS, program.smem_bytes, q.data_ptr(), v.data_ptr(),
        lp0.data_ptr(), lp1.data_ptr(), None if ut is None else ut.data_ptr(),
        torch.cuda.current_stream(thetas.device).cuda_stream)
    _build.check(rc, "fused_trajectory")
    fused_trajectory.LAUNCHES += 1
    return (q, v, lp0, lp1) + ((ut,) if ut is not None else ())


fused_trajectory.LAUNCHES = 0


# --------------------------------------------------------------------------
# K3: the per-step potential
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PotentialProgram:
    """Everything K3 needs besides the state: the op program, its dense
    layers as ``(d_in, d_out, act)`` rows with each activation fused into
    the dense layer before it (``OP_CODES``, 0 for none), and the data's
    row count."""

    ops: tuple
    layers: tuple
    n_rows: int

    def __post_init__(self):
        # the host table the C entry point walks; kept alive with the
        # program while the kernel library reads it
        self.table = np.ascontiguousarray(np.asarray(self.layers,
                                                     np.int32).reshape(-1))

    @property
    def dims(self) -> Tuple[int, int, int]:
        return _program_dims(self.ops)

    def workspace_floats(self, c: int) -> int:
        """Floats of the kernel's workspace: every layer's output plane
        ``(C, N, d_out)`` and two gradient planes ``(C, N, max d_out)``."""
        widths = [d_out for _, d_out, _ in self.layers]
        return c * self.n_rows * (sum(widths) + 2 * max(widths))


def make_fused_potential_vg(ops, n_rows: int) -> Optional[Callable]:
    """``vg(thetas (C, D), sd, x (N, d0), y) -> (ll (C,), grad (C, D))`` for
    an op program, ``sd`` a float or per-chain ``(C,)``; None when an
    activation does not follow a dense layer (K3 fuses each activation
    into the epilogue of the layer before it)."""
    layers = []
    for op in ops:
        if op[0] == "dense":
            layers.append([op[1], op[2], 0])
        elif not layers or layers[-1][2]:
            return None
        else:
            layers[-1][2] = OP_CODES[op[0]]
    program = PotentialProgram(tuple(ops), tuple(map(tuple, layers)),
                               int(n_rows))
    return functools.partial(fused_potential, program)


def fused_potential(program: PotentialProgram, thetas, sd, x, y):
    """K3's wrapper: CUDA tensors launch the kernel, CPU tensors run
    ``potential_plain``. Counts its calls into the kernel library (each a
    fixed sequence of CUDA launches, see csrc/fused_potential.cu) in
    ``LAUNCHES``."""
    c = thetas.shape[0]
    d0, dk, d_total = program.dims
    n = program.n_rows
    if torch.is_tensor(sd) and sd.ndim == 1:
        sd_c = sd.to(device=thetas.device, dtype=torch.float32)
    else:
        sd_c = torch.full((c,), float(sd), dtype=torch.float32,
                          device=thetas.device)
    if thetas.device.type == "cpu":
        return potential_plain(program.ops, thetas, sd_c, x, y)
    if thetas.device.type != "cuda":
        raise ValueError(f"fused_potential: unsupported device "
                         f"{thetas.device}")
    x = x.reshape(n, d0)
    y = y.reshape(n, dk)
    shapes = {"thetas": (c, d_total), "x": (n, d0), "y": (n, dk),
              "sd": (c,)}
    for name, t in (("thetas", thetas), ("x", x), ("y", y), ("sd", sd_c)):
        if t.device != thetas.device or t.dtype != torch.float32:
            raise ValueError(f"fused_potential: {name} must be float32 on "
                             f"{thetas.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_potential: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
    thetas, x, y, sd_c = (t.contiguous() for t in (thetas, x, y, sd_c))
    ll = torch.empty(c, dtype=torch.float32, device=thetas.device)
    grad = torch.empty_like(thetas)
    work = torch.empty(program.workspace_floats(c), dtype=torch.float32,
                       device=thetas.device)
    lib = _build.load()
    rc = lib.tbnn_fused_potential(
        thetas.data_ptr(), x.data_ptr(), y.data_ptr(), sd_c.data_ptr(),
        program.table.ctypes.data, len(program.layers), c, d_total, n,
        work.data_ptr(), work.numel(), ll.data_ptr(), grad.data_ptr(),
        torch.cuda.current_stream(thetas.device).cuda_stream)
    _build.check(rc, "fused_potential")
    fused_potential.LAUNCHES += 1
    return ll, grad


fused_potential.LAUNCHES = 0


def try_build_fused_main_vg(model, likelihood, unravel_theta, unravel_eta,
                            x, y, eta_dim: int) -> Optional[Callable]:
    """``batched_main_vg(thetas, etas, x, y) -> ((C,), (C, D))`` for a model
    in K3's scope (see the module docstring), else None (the caller then
    takes the plain ``hmc_step_batched`` path).

    The likelihood's value and gradient come from ``fused_potential``; the
    priors are added outside it: in closed form when every layer with
    hypers is a ``GaussianDenseLayer``, else through ``torch.func`` over
    ``model.log_prior``.
    """
    from tensorbnn_tpu_torch.likelihoods import FixedGaussianLikelihood, \
        GaussianLikelihood
    from tensorbnn_tpu_torch.models.layers import CauchyDenseLayer, \
        GaussianDenseLayer
    from tensorbnn_tpu_torch.sampler.potential import \
        _batched_value_and_grad, eta_index_probe

    del y
    if not isinstance(likelihood, (FixedGaussianLikelihood,
                                   GaussianLikelihood)):
        return None
    ops = _model_program(model, (GaussianDenseLayer, CauchyDenseLayer))
    if ops is None or not verify_theta_layout(unravel_theta, ops):
        return None
    vg = make_fused_potential_vg(ops, x.shape[0])
    if vg is None:
        return None
    learned_sd = isinstance(likelihood, GaussianLikelihood)
    if learned_sd:
        # the sd_root hyper must be the last flat-eta coordinate
        _, lik_hypers = eta_index_probe(unravel_eta, eta_dim)
        if int(lik_hypers.get("sd_root", -1)) != eta_dim - 1:
            return None
    else:
        sd_fixed = float(likelihood.sd)

    prior_blocks = gaussian_prior_blocks(model, unravel_eta, eta_dim)
    if prior_blocks is None:
        def prior_fn(theta, eta):
            hypers, _ = unravel_eta(eta)
            return model.log_prior(hypers, unravel_theta(theta))

        prior_vg = _batched_value_and_grad(prior_fn)

    def batched_main_vg(thetas, etas, x_in, y_in):
        sd = etas[:, -1] ** 2 if learned_sd else sd_fixed
        value, grad = vg(thetas, sd, x_in, y_in)
        if prior_blocks is not None:
            return add_gaussian_priors(prior_blocks, thetas, etas, value,
                                       grad)
        p_value, p_grad = prior_vg(thetas, etas)
        return value + p_value, grad + p_grad

    return batched_main_vg


# --------------------------------------------------------------------------
# The plain twins: the kernels' arithmetic in batched torch ops
# --------------------------------------------------------------------------

def _act_forward(kind: str, a):
    if kind == "tanh":
        return torch.tanh(a)
    if kind == "relu":
        return torch.clamp(a, min=0.0)
    if kind == "sigmoid":
        return torch.sigmoid(a)
    if kind == "exp":
        return torch.exp(a)
    return torch.where(a > 0.0, a, torch.exp(a) - 1.0)       # elu


def _act_backward(kind: str, h_in, h_out):
    if kind == "tanh":
        return 1.0 - h_out * h_out
    if kind == "relu":
        return (h_out > 0.0).to(h_out.dtype)
    if kind == "sigmoid":
        return h_out * (1.0 - h_out)
    if kind == "exp":
        return h_out
    return torch.where(h_in > 0.0, 1.0, torch.exp(h_in))     # elu


def potential_plain(ops, thetas, sd_c, x, y):
    """Gaussian log likelihood ``(C,)`` and its gradient ``(C, D)`` at
    ``thetas (C, D)`` with the per-chain sd ``sd_c (C,)`` (clamped to [1e-8,
    1e8]): forward pass and hand-written backward pass in batched torch ops,
    as the kernels compute them. K3's twin, and the likelihood half of
    K1's."""
    c = thetas.shape[0]
    d0, dk, _ = _program_dims(ops)
    x = x.reshape(-1, d0)
    n = x.shape[0]
    h = x.expand(c, n, d0)
    planes, dense = [h], []
    off = 0
    for op in ops:
        if op[0] == "dense":
            d_in, d_out = op[1], op[2]
            b = thetas[:, off:off + d_out]
            w = thetas[:, off + d_out:off + d_out + d_in * d_out].reshape(
                c, d_in, d_out)
            dense.append((off, w))
            h = torch.baddbmm(b[:, None, :], h, w)
            off += d_out + d_in * d_out
        else:
            h = _act_forward(op[0], h)
        planes.append(h)

    sd = sd_c.clamp(1e-8, 1e8)
    inv_sd2 = (1.0 / (sd * sd))[:, None, None]
    k = float(n * dk)
    resid = y.reshape(n, dk) - h
    value = -0.5 * ((resid * resid * inv_sd2).sum((1, 2))
                    + 2.0 * k * torch.log(sd) + k * LOG_2PI)
    g = resid * inv_sd2

    grad = torch.empty_like(thetas)
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        if op[0] == "dense":
            base, w = dense.pop()
            d_out = op[2]
            grad[:, base:base + d_out] = g.sum(1)
            grad[:, base + d_out:base + d_out + op[1] * d_out] = torch.bmm(
                planes[i].transpose(1, 2), g).reshape(c, -1)
            if i > 0:
                g = torch.bmm(g, w.transpose(1, 2))
        else:
            g = g * _act_backward(op[0], planes[i], planes[i + 1])
    return value, grad


def add_gaussian_priors(prior_blocks, q, etas, value, grad):
    """Adds the closed-form Gaussian priors (sd = scale ** 2, clamped to
    [1e-8, 1e8]) of ``prior_blocks`` to ``value`` and, in place, to
    ``grad``; returns both. The per-block scalars are taken for all blocks
    at once, so each block costs three launches: a wide model's blocks are
    large and a narrow model's many."""
    s = torch.stack([etas[:, i_scale] for _, _, _, i_scale in prior_blocks],
                    1)
    sig = (s * s).clamp(1e-8, 1e8)
    iv = 1.0 / (sig * sig)                                    # (C, blocks)
    norms = []
    for b, (start, rows, i_loc, _) in enumerate(prior_blocks):
        dif = q[:, start:start + rows] - etas[:, i_loc, None]
        norms.append(torch.linalg.vector_norm(dif, dim=1))
        grad[:, start:start + rows].addcmul_(dif, iv[:, b:b + 1], value=-1.0)
    quad = torch.stack(norms, 1).square()
    value = value - 0.5 * ((quad * iv).sum(1) + 2.0 * torch.log(sig).sum(1)
                           + len(prior_blocks) * LOG_2PI)
    return value, grad


def program_value_and_grad(program: TrajectoryProgram, q, etas, x, y,
                           betas=None):
    """Log posterior ``(C,)`` and its gradient ``(C, D)`` at ``q (C, D)``,
    as K1 computes them: the fixed-sd likelihood (times ``betas (C,)``
    when given, the power posterior) plus closed-form Gaussian priors."""
    sd_c = torch.full((q.shape[0],), program.sd, dtype=q.dtype,
                      device=q.device)
    value, grad = potential_plain(program.ops, q, sd_c, x, y)
    if betas is not None:
        value, grad = betas * value, betas[:, None] * grad
    return add_gaussian_priors(program.prior_blocks, q, etas, value, grad)


def trajectory_plain(program: TrajectoryProgram, thetas, etas, momenta, x,
                     y, eps_c, l_c, betas=None):
    """The K1 trajectory in batched torch ops: the kernel's schedule run as
    one wave front to ``max(L)``, with chains past their own ``L`` frozen
    (their value is re-taken at the unchanged end point). ``betas (C,)``
    tempers the likelihood.

    A recording program also returns each chain's first U-turn step, as
    the Pallas kernel records it (tensorbnn_tpu/ops/fused_mlp.py:560-574):
    at iteration 1 <= i <= L_c, after the kick, ``(q - q0) . v_rec < 0``
    with the pre-drift q and ``v_rec`` the kicked momentum, plus the other
    half kick at i == L_c. That pairs (q_i, v_{i+1/2}) as
    ``leapfrog_batched(record_uturn=True)`` does."""
    d0, dk, _ = program.dims
    x = x.reshape(program.n_rows, d0)
    y = y.reshape(program.n_rows, dk)
    q, v = thetas, momenta
    l_c = l_c.to(torch.int64)
    ut = torch.zeros(thetas.shape[0], dtype=torch.int32,
                     device=thetas.device)
    lp0 = lp = None
    for i in range(int(l_c.max()) + 1):
        lp, g = program_value_and_grad(program, q, etas, x, y, betas)
        if i == 0:
            lp0 = lp
        kick = torch.where(i < l_c, eps_c, 0.0)
        kick = torch.where((l_c == i) | (i == 0), 0.5 * eps_c, kick)
        drift = torch.where(i < l_c, eps_c, 0.0)
        v = v + kick[:, None] * g
        if program.record_uturn and i >= 1:
            half_fix = torch.where(l_c == i, 0.5 * eps_c, 0.0)
            proj = ((q - thetas) * (v + half_fix[:, None] * g)).sum(-1)
            ut = torch.where((i <= l_c) & (ut == 0) & (proj < 0), i, ut)
        q = q + drift[:, None] * v
    if program.record_uturn:
        return q, v, lp0, lp, ut
    return q, v, lp0, lp
