"""K1 and K3: the fused main-block kernels, and their plain twins.

Counterpart of ``tensorbnn_tpu/ops/fused_mlp.py``. Both kernels run a dense
stack given as an op program (``_model_program``) whose flat row layout
``verify_theta_layout`` checks, under one of three likelihood tails:
"gaussian" (fixed or learned sd), "bernoulli" (probabilities clipped to
[1e-8, 1 - 1e-7]) or "categorical" (a trailing ``Softmax`` folded into a
logits-space tail with the closed-form gradient ``onehot - p``).

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
each chain's first U-turn step, 0 when censored. Scope: Gaussian or Cauchy
dense layers, the tanh / relu / sigmoid / exp / elu / leakyrelu
activations and the sampled Prelu / SquarePrelu slopes, with closed-form
priors ("gauss", "gauss_raw", "cauchy", "exp"), under any of the three
tails, within one block's shared memory.

K3, ``try_build_fused_main_vg``, returns ``batched_main_vg(thetas (C, D),
etas (C, H), x, y) -> (lp (C,), grad (C, D))``: one log-posterior value and
gradient per chain, for ``hmc_step_batched``. The likelihood half comes from
``fused_potential``, which on CUDA tensors launches ``csrc/fused_potential.cu``
(or raises) and on CPU tensors runs ``potential_plain``; the prior half is
added outside the kernel in closed form (``add_priors``). Scope: K1's ops,
each activation following a dense layer, and K1's tails (a learned sd must
be the last eta coordinate). The driver builds K3 where K1 declines a
model: planes too wide for one block's shared memory. Built with
``data_chunk`` (a divisor of the rows, more than one chunk), K3 runs over
row chunks: one call a chunk over contiguous row views, one after another
on one stream, so that each call's workspace (``C x data_chunk`` rows of
planes) takes the last one's memory; the values summed with a Kahan
carry, the gradients plainly, as the chunked plain path sums them.

Not ported: K3's data-axis ``psum``. Deliberate divergences: the TPU's VMEM
gates (``kernel_vmem_bytes``, ``trajectory_vmem_bytes``), its chain blocks
(``choose_block_c``) and the TPU-measured ``fused_profitable`` gate do not
apply on the H100. K3 keeps its planes in device memory; its gate is the
card's memory (``parallel.graphs.k3_fits``, which the driver applies to a
call's workspace: where even one chunk's does not fit, the main block
takes the plain path, as the JAX package's VMEM gate sends it to XLA).
Where the JAX package's gate declines K3 under ``data_chunk``, the port
runs K3 over row chunks: the same function up to float association. K1's
only gate is one block's shared memory.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tensorbnn_tpu_torch.ops import _build

LOG_2PI = math.log(2.0 * math.pi)
#: Bernoulli probability clip (reference likelihood.py:225-231)
BERN_LO, BERN_HI = 1e-8, 1.0 - 1e-7
#: categorical probability floor (distributions.categorical_logprob)
CAT_LO = 1e-8

#: op codes of K1's op program (csrc/fused_trajectory.cu); K3's layer
#: table (csrc/fused_potential.cu) uses the activation codes with 0 for none
OP_CODES = {"dense": 0, "tanh": 1, "relu": 2, "sigmoid": 3, "exp": 4,
            "elu": 5, "leakyrelu": 6, "prelu": 7, "sqprelu": 8}
#: likelihood tails of both kernels
LIK_CODES = {"gaussian": 0, "bernoulli": 1, "categorical": 2}
#: closed-form prior kinds of K1's prior blocks
PRIOR_CODES = {"gauss": 0, "gauss_raw": 1, "cauchy": 2, "exp": 3}
MAX_OPS = 32
MAX_PRIOR_BLOCKS = 64
#: K1's threads per chain's block: the value threads (row or item r of the
#: log posterior's and the U-turn sum's partials on thread r % 128, which
#: fixes their bits), or twice as many for a fleet that fits the card
THREADS, WIDE_THREADS = 128, 256
#: K1 blocks of WIDE_THREADS an SM holds (its at most 64 registers)
WIDE_BLOCKS_PER_SM = 4
#: dynamic shared memory one block may take: the H100's 227 KB per block
#: less room for the kernel's static tables
SMEM_BUDGET_BYTES = 232448 - 4096
#: the H100's streaming multiprocessors, which K3's launch plan fills
SMS = 132
#: K3's product tiles (csrc/fused_potential.cu: kBM, kBN, kBK)
TILE_M, TILE_N, TILE_K = 64, 64, 16
#: blocks an SM holds at once: a product's 256 threads at 76-80 registers
#: (ptxas for sm_90a), a slope pass's 512 threads (an SM's 2,048)
PRODUCT_BLOCKS_PER_SM, SLOPE_BLOCKS_PER_SM = 3, 4
#: a slice of rows in a split row sum is at least this long
MIN_SLICE_ROWS = 256


# --------------------------------------------------------------------------
# Op program: a linear pipeline of
#   ("dense", d_in, d_out)    rows: d_out bias + d_in * d_out weights
#   ("tanh"|"relu"|"sigmoid"|"exp"|"elu", d)
#   ("leakyrelu", d, alpha)   fixed slope, no rows
#   ("prelu", d)              rows: d sampled slopes
#   ("sqprelu", d)            rows: d sampled slopes (effective slope s ** 2)
# --------------------------------------------------------------------------

def _op_rows(op) -> int:
    if op[0] == "dense":
        return op[2] + op[1] * op[2]
    return op[1] if op[0] in ("prelu", "sqprelu") else 0


def _op_width(op) -> int:
    return op[2] if op[0] == "dense" else op[1]


def _program_dims(ops) -> Tuple[int, int, int]:
    """Returns (d0, d_final, total theta rows)."""
    return ops[0][1], _op_width(ops[-1]), sum(_op_rows(op) for op in ops)


def _alpha_bits(alpha: float) -> int:
    """A float32's bits as an int32, for the kernels' int tables."""
    return int(np.asarray(alpha, np.float32).view(np.int32))


#: act codes of the ops that carry sampled slopes (their backward sums a
#: column over the N rows)
SLOPE_CODES = (OP_CODES["prelu"], OP_CODES["sqprelu"])


def _layer_table(ops, standalone: bool = False) -> Optional[tuple]:
    """The op program as the kernels' layer rows ``(d_in, d_out, act,
    row_off, slope_off, alpha_bits)``: each op fused into the dense layer
    before it (``act`` an ``OP_CODES`` code, 0 for none; ``row_off`` the
    layer's first theta row; ``slope_off`` the first slope row of a prelu
    or sqprelu, else -1; ``alpha_bits`` a leakyrelu's slope as float32
    bits). An op that does not directly follow a dense layer is, with
    ``standalone`` (K1), a row of its own with ``d_in`` 0 and ``row_off``
    the next theta row; without it (K3) the table is None."""
    layers, off = [], 0
    for op in ops:
        if op[0] == "dense":
            layers.append([op[1], op[2], 0, off, -1, 0])
        else:
            if not layers or layers[-1][2]:
                if not standalone:
                    return None
                layers.append([0, op[1], 0, off, -1, 0])
            layers[-1][2] = OP_CODES[op[0]]
            if op[0] in ("prelu", "sqprelu"):
                layers[-1][4] = off
            elif op[0] == "leakyrelu":
                layers[-1][5] = _alpha_bits(op[2])
        off += _op_rows(op)
    return tuple(map(tuple, layers))


def _model_program(model, likelihood) -> Optional[Tuple[tuple, str]]:
    """Pattern-matches ``(model, likelihood)`` to ``(ops, lik)``, or None
    when a layer or the likelihood is outside the kernels' scope. A
    trailing ``Softmax`` under ``CategoricalLikelihood`` folds into the
    categorical tail, so the program ends at the logits; a softmax anywhere
    else, or without that likelihood, is out of scope (as
    tensorbnn_tpu/ops/fused_mlp.py:1046-1110). A dense layer with a
    ``compute_dtype`` is out of scope too (the kernels compute in float32);
    ``matmul_precision`` is not: both kernels' products are float32 FFMA
    already, which is what "highest" asks for."""
    from tensorbnn_tpu_torch.likelihoods import BernoulliLikelihood, \
        CategoricalLikelihood, FixedGaussianLikelihood, GaussianLikelihood
    from tensorbnn_tpu_torch.models.layers import Activation, \
        CauchyDenseLayer, GaussianDenseLayer, LeakyRelu, Prelu, SquarePrelu

    if isinstance(likelihood, (FixedGaussianLikelihood, GaussianLikelihood)):
        lik = "gaussian"
    elif isinstance(likelihood, BernoulliLikelihood):
        lik = "bernoulli"
    elif isinstance(likelihood, CategoricalLikelihood):
        lik = "categorical"
    else:
        return None
    ops: List[tuple] = []
    d = None
    for layer in model.layers:
        if isinstance(layer, (GaussianDenseLayer, CauchyDenseLayer)):
            if (d is not None and d != layer.in_dim) or layer.compute_dtype:
                return None
            ops.append(("dense", int(layer.in_dim), int(layer.out_dim)))
            d = int(layer.out_dim)
        elif d is None:
            return None
        elif isinstance(layer, Activation):
            name = {"Exp": "exp"}.get(layer.name, layer.name)
            if name not in ("tanh", "relu", "sigmoid", "elu", "exp",
                            "softmax"):
                return None
            ops.append((name, d))
        elif isinstance(layer, LeakyRelu):
            ops.append(("leakyrelu", d, float(layer.alpha)))
        elif isinstance(layer, (Prelu, SquarePrelu)):
            if layer.in_dim != d:
                return None
            ops.append(("sqprelu" if isinstance(layer, SquarePrelu)
                        else "prelu", d))
        else:
            return None
    if d is None:
        return None
    if lik == "categorical":
        if ops[-1][0] != "softmax" or len(ops) < 2:
            return None
        ops = ops[:-1]
    if any(op[0] == "softmax" for op in ops):
        return None
    return tuple(ops), lik


def verify_theta_layout(unravel_theta, ops) -> bool:
    """Checks the flat layout matches the kernel's row contract: per dense
    layer, bias rows then row-major ``(in, out)`` weight rows; per Prelu or
    SquarePrelu, its slope rows."""
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
        if oi >= len(row_ops):
            return False
        op = row_ops[oi]
        if op[0] == "dense":
            _, d_in, d_out = op
            want_w = np.arange(off + d_out, off + d_out + d_in * d_out)
            if set(layer_params) != {"b", "w"} or not (
                    np.array_equal(layer_params["b"],
                                   np.arange(off, off + d_out))
                    and np.array_equal(layer_params["w"],
                                       want_w.reshape(d_in, d_out))):
                return False
        elif set(layer_params) != {"slopes"} or not np.array_equal(
                layer_params["slopes"], np.arange(off, off + op[1])):
            return False
        off += _op_rows(op)
        oi += 1
    return oi == len(row_ops) and off == d_total


def _prep_labels(y, n: int, dk: int, lik: str):
    """``y`` as the kernels' ``(n, dk)`` float32 plane: categorical class
    ids (``n`` values, in any shape) one-hot encode to the logits width,
    anything else (one-hot rows included) reshapes."""
    if lik == "categorical" and y.numel() == n and dk > 1:
        return torch.nn.functional.one_hot(
            y.reshape(n).to(torch.int64), dk).to(torch.float32)
    return y.to(torch.float32).reshape(n, dk)


def prior_blocks(model, unravel_eta, eta_dim: int) -> Optional[tuple]:
    """The closed-form prior blocks ``(kind, start_row, rows, loc_eta_idx,
    scale_eta_idx, sign)`` of ``model``, in flat row order (as
    tensorbnn_tpu/ops/fused_mlp.py:780-815): "gauss" for a Gaussian dense
    layer (sd = scale ** 2), "cauchy" for a Cauchy one (gamma = scale ** 2;
    sign +1 is the reference's flipped density, -1 ``proper=True``), "exp"
    for Prelu slopes (rate = |eta[loc_eta_idx]|) and "gauss_raw" for
    SquarePrelu slopes (sd = scale). None when a layer with hypers has no
    closed form."""
    from tensorbnn_tpu_torch.models.layers import CauchyDenseLayer, \
        GaussianDenseLayer, Prelu, SquarePrelu
    from tensorbnn_tpu_torch.sampler.potential import eta_index_probe

    probe_h, _ = eta_index_probe(unravel_eta, eta_dim)
    blocks, start = [], 0
    for layer, h in zip(model.layers, probe_h):
        if not h:
            continue
        if isinstance(layer, (GaussianDenseLayer, CauchyDenseLayer)):
            if set(h) != {"b_loc", "b_scale", "w_loc", "w_scale"}:
                return None
            kind, sign = "gauss", 0
            if isinstance(layer, CauchyDenseLayer):
                kind, sign = "cauchy", -1 if layer.proper else 1
            for rows, loc, scale in ((layer.out_dim, "b_loc", "b_scale"),
                                     (layer.in_dim * layer.out_dim, "w_loc",
                                      "w_scale")):
                blocks.append((kind, start, rows, int(h[loc]),
                               int(h[scale]), sign))
                start += rows
        elif isinstance(layer, Prelu) and set(h) == {"rate"}:
            blocks.append(("exp", start, layer.in_dim, int(h["rate"]),
                           int(h["rate"]), 0))
            start += layer.in_dim
        elif isinstance(layer, SquarePrelu) and set(h) == {"loc", "scale"}:
            blocks.append(("gauss_raw", start, layer.in_dim, int(h["loc"]),
                           int(h["scale"]), 0))
            start += layer.in_dim
        else:
            return None
    return tuple(blocks)


@dataclasses.dataclass
class TrajectoryProgram:
    """Everything K1 needs besides the state: the op program, the prior
    blocks (``prior_blocks``) covering the flat state in row order, the
    likelihood tail, the Gaussian tail's fixed sd or the eta index of its
    learned ``sd_root`` (sd = eta ** 2, clipped to [1e-8, 1e8]), whether
    the likelihood is tempered by per-chain betas, and whether the
    trajectory records each chain's first U-turn step."""

    ops: tuple
    prior_blocks: tuple
    sd: float
    n_rows: int
    eta_dim: int
    tempered: bool = False
    record_uturn: bool = False
    lik: str = "gaussian"
    sd_idx: Optional[int] = None
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return _program_dims(self.ops)

    @property
    def full(self) -> bool:
        """Whether the program needs the kernel's general build: a
        classification tail, a prior other than "gauss" or a slope op.
        Other programs run the build specialized to them."""
        return (self.lik != "gaussian"
                or any(b[0] != "gauss" for b in self.prior_blocks)
                or any(op[0] in ("leakyrelu", "prelu", "sqprelu")
                       for op in self.ops))

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one chain's block: q, v, g, every
        activation plane and two backward planes (the layout of
        csrc/fused_trajectory.cu). The tails and the slope ops need no
        more: slopes are rows of q and g, and a prelu's backward reads its
        input plane."""
        d0, _, d_total = self.dims
        widths = [d0] + [_op_width(op) for op in self.ops]
        n = self.n_rows
        return 4 * (3 * d_total + n * sum(widths) + 2 * n * max(widths))

    @functools.cached_property
    def layers(self) -> tuple:
        """K1's layer table: the rows of ``_layer_table`` with
        ``standalone`` (each activation fused into the dense layer before
        it, an op that does not follow a dense layer a row of its own) and
        a seventh column, ``deriv``: 1 where the activation's derivative is
        applied where its output's gradient is produced (the next dense
        layer's input-gradient items, or the Gaussian and Bernoulli tails)
        with no pass of its own. That is an elementwise activation (not a
        slope op) whose next layer is dense, or that ends a program with
        such a tail. The kernel runs the flags as given; its entry point
        refuses one that cannot hold."""
        rows = _layer_table(self.ops, standalone=True)
        out = []
        for l, row in enumerate(rows):
            act = row[2]
            if act == 0 or act in SLOPE_CODES:
                deriv = False
            elif l == len(rows) - 1:
                deriv = self.lik != "categorical"
            else:
                deriv = rows[l + 1][0] > 0
            out.append(row + (int(deriv),))
        return tuple(out)

    @functools.cached_property
    def table(self) -> np.ndarray:
        """The host table the C entry point checks and hands the kernel."""
        return np.ascontiguousarray(np.asarray(self.layers,
                                               np.int32).reshape(-1))

    @functools.cached_property
    def update_merged(self) -> bool:
        """Whether the leapfrog update runs in the backward's last phase
        (layer 0's products) with no barrier of its own, passed to the
        kernel as ``merge``: each of layer 0's gradient rows is written
        there by the thread that updates it, unless a recording program
        has more such rows than ``THREADS`` (its update runs on the value
        threads alone)."""
        d_in, d_out = self.layers[0][:2]
        return not self.record_uturn or (d_in + 1) * d_out <= THREADS

    @property
    def barriers_per_step(self) -> int:
        """``__syncthreads`` in one leapfrog step that computes no value
        (0 < i < L) as the kernel runs the table: one per layer's forward
        pass, one for the categorical tail's pass, one for each slope pass
        and each derivative pass (``deriv`` 0), one for each dense layer's
        backward products, and one for the update unless it is merged into
        the last of them. The value steps i = 0 and i = L add three (the
        block reduction)."""
        n = (len(self.layers) + (self.lik == "categorical")
             + (not self.update_merged))
        for d_in, _, act, _, _, _, deriv in self.layers:
            n += act in SLOPE_CODES or (act != 0 and not deriv)
            n += d_in > 0
        return n

    @functools.cached_property
    def step_items(self) -> int:
        """The most items of one phase of a step: the update's rows, and
        per layer its forward items and its backward products' (the
        weight-gradient rows, then from a warp boundary the input
        gradient)."""
        n = self.n_rows
        return max([self.dims[2]] + [
            max(n * d_out, _cdiv((d_in + 1) * d_out, 32) * 32 + n * d_in)
            for d_in, d_out, *_ in self.layers])

    def threads(self, c: int) -> int:
        """Threads of each of ``c`` chains' blocks: ``WIDE_THREADS`` where
        a phase of a step has more items than ``THREADS`` (so that it runs
        one round of items) and the fleet's blocks fit the card at once
        (``WIDE_BLOCKS_PER_SM`` on each of ``SMS``), else ``THREADS``: a
        larger fleet runs in fewer waves of narrower blocks (on an H100,
        the tempered flagship at C = 2,048 took 0.74 ms at 128 threads
        against 1.02 at 256; PERF.md)."""
        if self.step_items > THREADS and c <= WIDE_BLOCKS_PER_SM * SMS:
            return WIDE_THREADS
        return THREADS

    def prior_table(self, device) -> torch.Tensor:
        """The prior table ``(kind, rows, loc_idx, scale_idx, sign)`` as an
        int32 tensor on ``device``."""
        key = str(device)
        if key not in self._tables:
            prior = [(PRIOR_CODES[kind], rows, i_loc, i_scale, sign)
                     for kind, _, rows, i_loc, i_scale, sign
                     in self.prior_blocks]
            self._tables[key] = torch.tensor(prior, dtype=torch.int32,
                                             device=device)
        return self._tables[key]


def _likelihood_sd(likelihood, unravel_eta, eta_dim: int):
    """``(fixed sd, sd_root eta index)`` of a likelihood: the fixed-sd
    Gaussian's sd, the learned-sd Gaussian's index (None when its
    ``sd_root`` is missing: out of scope), and (1.0, None) for the
    classification tails, which take no sd."""
    from tensorbnn_tpu_torch.likelihoods import FixedGaussianLikelihood, \
        GaussianLikelihood
    from tensorbnn_tpu_torch.sampler.potential import eta_index_probe

    if isinstance(likelihood, GaussianLikelihood):
        _, lik_hypers = eta_index_probe(unravel_eta, eta_dim)
        if "sd_root" not in lik_hypers:
            return None
        return 1.0, int(lik_hypers["sd_root"])
    if isinstance(likelihood, FixedGaussianLikelihood):
        return float(likelihood.sd), None
    return 1.0, None


def build_trajectory_program(model, likelihood, unravel_theta, unravel_eta,
                             eta_dim: int, n_rows: int,
                             tempered: bool = False,
                             record_uturn: bool = False
                             ) -> Optional[TrajectoryProgram]:
    """The K1 program for ``(model, likelihood)``, or None when out of
    scope (see the module docstring) or over the shared-memory budget;
    ``tempered`` builds the power-posterior program, ``record_uturn`` the
    U-turn-recording one."""
    matched = _model_program(model, likelihood)
    if matched is None:
        return None
    ops, lik = matched
    if not verify_theta_layout(unravel_theta, ops):
        return None
    blocks = prior_blocks(model, unravel_eta, eta_dim)
    sd = _likelihood_sd(likelihood, unravel_eta, eta_dim)
    if blocks is None or sd is None:
        return None
    program = TrajectoryProgram(ops, blocks, sd[0], int(n_rows),
                                int(eta_dim), bool(tempered),
                                bool(record_uturn), lik, sd[1])
    if (len(ops) > MAX_OPS or len(blocks) > MAX_PRIOR_BLOCKS
            or sum(b[2] for b in blocks) != program.dims[2]
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
    untempered one ignores them, as the JAX package's does). Categorical
    class ids are one-hot encoded here. Returns ``(q, v, lp0, lp1)``, and
    ``uturn (C,)`` int32 after them when the program records. Counts its
    kernel launches in ``LAUNCHES``."""
    if program.tempered and betas is None:
        raise TypeError("tempered trajectory kernel requires betas")
    c = thetas.shape[0]
    d0, dk, d_total = program.dims
    n = program.n_rows
    eps_c, l_c = per_chain(eps, n_leapfrog, c, thetas.device)
    beta_c = (torch.as_tensor(betas, dtype=torch.float32,
                              device=thetas.device)
              if program.tempered else None)
    y = _prep_labels(y, n, dk, program.lik)
    if thetas.device.type == "cpu":
        return trajectory_plain(program, thetas, etas, momenta, x, y, eps_c,
                                l_c, beta_c)
    x = x.reshape(n, d0)
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
    prior_t = program.prior_table(thetas.device)
    q = torch.empty_like(thetas)
    v = torch.empty_like(thetas)
    lp0 = torch.empty(c, dtype=torch.float32, device=thetas.device)
    lp1 = torch.empty_like(lp0)
    ut = (torch.empty(c, dtype=torch.int32, device=thetas.device)
          if program.record_uturn else None)
    lib = _build.load()
    # the library launches on the current device: make it the tensors'
    with torch.cuda.device(thetas.device):
        rc = lib.tbnn_fused_trajectory(
            thetas.data_ptr(), momenta.data_ptr(), etas.data_ptr(),
            x.data_ptr(), y.data_ptr(), eps_c.data_ptr(), l_c.data_ptr(),
            None if beta_ptr is None else beta_ptr.data_ptr(),
            program.table.ctypes.data, len(program.layers),
            prior_t.data_ptr(), len(program.prior_blocks), c, d_total,
            program.eta_dim, n, LIK_CODES[program.lik], program.sd,
            -1 if program.sd_idx is None else program.sd_idx,
            int(program.full), int(program.update_merged),
            program.threads(c), program.smem_bytes, q.data_ptr(),
            v.data_ptr(), lp0.data_ptr(), lp1.data_ptr(),
            None if ut is None else ut.data_ptr(),
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
    layers as ``(d_in, d_out, act, row_off, slope_off, alpha_bits)`` rows
    with each activation fused into the dense layer before it (``act`` an
    ``OP_CODES`` code, 0 for none; ``row_off`` the layer's first theta row;
    ``slope_off`` the first slope row of a following prelu or sqprelu, else
    -1; ``alpha_bits`` a following leakyrelu's slope as float32 bits), the
    likelihood tail and the data's row count."""

    ops: tuple
    layers: tuple
    n_rows: int
    lik: str = "gaussian"
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        # the host table the C entry point walks; kept alive with the
        # program while the kernel library reads it
        self.table = np.ascontiguousarray(np.asarray(self.layers,
                                                     np.int32).reshape(-1))

    @property
    def dims(self) -> Tuple[int, int, int]:
        return _program_dims(self.ops)

    def plan(self, c: int) -> "PotentialPlan":
        """K3's launch plan for ``c`` chains, which the C entry point
        checks and runs. The first layer's forward and weight-gradient
        products are packed: one product over all chains' columns against
        the shared data. A row sum over the data's N rows (a weight
        gradient, a slope pass) whose grid leaves room on the card is
        split into the most slices of rows whose blocks the card holds at
        once (``PRODUCT_BLOCKS_PER_SM`` or ``SLOPE_BLOCKS_PER_SM`` on each
        of ``SMS``), each slice's partials summed in slice order afterwards
        (no atomics); slices are multiples of the tile depth and at least
        ``MIN_SLICE_ROWS`` rows long."""
        if c not in self._plans:
            rows, partials = [], 0
            for i, (d_in, d_out, _, _, slope_off, _) in enumerate(
                    self.layers):
                packed = i == 0
                blocks = (_cdiv(c * d_out if packed else d_out, TILE_N)
                          * _cdiv(d_in, TILE_M) * (1 if packed else c))
                wg = _row_slices(self.n_rows, blocks,
                                 PRODUCT_BLOCKS_PER_SM * SMS)
                sp = (1, self.n_rows)
                if slope_off >= 0:
                    sp = _row_slices(self.n_rows, _cdiv(d_out, 32) * c,
                                     SLOPE_BLOCKS_PER_SM * SMS)
                rows.append((int(packed), *wg, *sp))
                # a split product's partials: slices x C x its grad rows
                if wg[0] > 1:
                    partials = max(partials,
                                   wg[0] * c * (d_out + d_in * d_out))
                if sp[0] > 1:
                    partials = max(partials, sp[0] * c * d_out)
            self._plans[c] = PotentialPlan(tuple(rows), partials)
        return self._plans[c]

    def workspace_floats(self, c: int) -> int:
        """Floats of the kernel's workspace: every layer's output plane
        ``(C, N, d_out)``, the pre-activation plane of each layer followed
        by a prelu or sqprelu (their derivative and slope gradient need the
        input's sign, which the output does not keep), two gradient
        planes ``(C, N, max d_out)``, and the partials of the largest
        split row sum of ``plan(c)``."""
        widths = [row[1] for row in self.layers]
        pre = [row[1] for row in self.layers if row[4] >= 0]
        return (c * self.n_rows * (sum(widths) + sum(pre) + 2 * max(widths))
                + self.plan(c).partial_floats)


def _row_slices(n_rows: int, blocks: int, wave: int) -> Tuple[int, int]:
    """``(slices, rows a slice)`` of a row sum whose unsplit grid has
    ``blocks`` blocks: the most slices whose blocks fit in ``wave``, as
    far as slices of at least ``MIN_SLICE_ROWS`` rows allow, each a
    multiple of ``TILE_K`` rows (the last one shorter); one slice of all
    rows when no split fits."""
    want = min(wave // blocks, n_rows // MIN_SLICE_ROWS)
    if want <= 1:
        return 1, n_rows
    per = _cdiv(_cdiv(n_rows, want), TILE_K) * TILE_K
    return _cdiv(n_rows, per), per


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PotentialPlan:
    """K3's launch plan for one chain count: per dense layer ``(packed,
    weight-gradient slices, rows a slice, slope-pass slices, rows a
    slice)``, slice ``s`` covering rows ``[s * rows, min(N, (s + 1) *
    rows))`` (one slope slice for a layer without slopes), and the floats
    of the largest split row sum's partials (split row sums run one at a
    time, so they share that room)."""

    layers: tuple
    partial_floats: int

    @functools.cached_property
    def table(self) -> np.ndarray:
        """The host table the C entry point reads."""
        return np.ascontiguousarray(np.asarray(self.layers,
                                               np.int32).reshape(-1))


def make_fused_potential_vg(ops, n_rows: int, lik: str = "gaussian"
                            ) -> Optional[Callable]:
    """``vg(thetas (C, D), sd, x (N, d0), y) -> (ll (C,), grad (C, D))`` for
    an op program under the ``lik`` tail, ``sd`` a float or per-chain
    ``(C,)`` (read by the Gaussian tail only); None when an activation does
    not follow a dense layer (K3 fuses each activation into the epilogue of
    the layer before it)."""
    layers = _layer_table(ops)
    if layers is None:
        return None
    program = PotentialProgram(tuple(ops), layers, int(n_rows), lik)
    return functools.partial(fused_potential, program)


def fused_potential(program: PotentialProgram, thetas, sd, x, y):
    """K3's wrapper: CUDA tensors launch the kernel, CPU tensors run
    ``potential_plain``. Categorical class ids are one-hot encoded here.
    Counts its calls into the kernel library (each a fixed sequence of CUDA
    launches, see csrc/fused_potential.cu) in ``LAUNCHES``."""
    c = thetas.shape[0]
    d0, dk, d_total = program.dims
    n = program.n_rows
    if torch.is_tensor(sd) and sd.ndim == 1:
        sd_c = sd.to(device=thetas.device, dtype=torch.float32)
    else:
        sd_c = torch.full((c,), float(sd), dtype=torch.float32,
                          device=thetas.device)
    y = _prep_labels(y, n, dk, program.lik)
    if thetas.device.type == "cpu":
        return potential_plain(program.ops, thetas, sd_c, x, y, program.lik)
    if thetas.device.type != "cuda":
        raise ValueError(f"fused_potential: unsupported device "
                         f"{thetas.device}")
    x = x.reshape(n, d0)
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
    # the library launches on the current device: make it the tensors'
    with torch.cuda.device(thetas.device):
        rc = lib.tbnn_fused_potential(
            thetas.data_ptr(), x.data_ptr(), y.data_ptr(), sd_c.data_ptr(),
            program.table.ctypes.data, program.plan(c).table.ctypes.data,
            len(program.layers), LIK_CODES[program.lik], c, d_total, n,
            work.data_ptr(), work.numel(), ll.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream(thetas.device).cuda_stream)
    _build.check(rc, "fused_potential")
    fused_potential.LAUNCHES += 1
    return ll, grad


fused_potential.LAUNCHES = 0


def try_build_fused_main_vg(model, likelihood, unravel_theta, unravel_eta,
                            x, y, eta_dim: int,
                            n_rows: Optional[int] = None,
                            data_chunk: Optional[int] = None
                            ) -> Optional[Callable]:
    """``batched_main_vg(thetas, etas, x, y, peers=None) -> ((C,), (C,
    D))`` for a model in K3's scope (see the module docstring), else None
    (the caller then takes the plain ``hmc_step_batched`` path). The
    likelihood's value and gradient come from ``fused_potential``, the
    closed-form priors from ``add_priors``, outside it.

    K3 is built for ``n_rows`` rows (``x``'s by default): on a data mesh,
    a peer's local rows. Where ``data_chunk`` makes more than one chunk of
    them (``sampler.potential.n_row_chunks``, which raises where it does
    not divide them), K3 is built for ``data_chunk`` rows and each
    evaluation makes one call a chunk over row views of ``x`` and ``y``,
    the values summed with the Kahan carry of ``_chunked_loglik``, the
    gradients plainly. Given ``peers`` (``parallel.mesh.DataPeers``),
    ``batched_main_vg`` runs K3 on each peer's rows (chunked there, with a
    carry of its own), sums the peers' ``(value, grad)`` and then adds the
    priors, once (the JAX package's psum around K3,
    ``tensorbnn_tpu/ops/fused_mlp.py:1191-1197``); ``x``, ``y`` are then
    not read. Each call's workspace is ``C`` x (a chunk's or a peer's
    rows) x 257 floats at the surrogate's 8-64-64-1, allocated on the
    calling stream, so the chunks and the peers that share a card reuse
    one. ``batched_main_vg.workspace_bytes(c)`` gives one call's bytes at
    ``c`` chains: the driver's gate and the stepped runner's read it."""
    from tensorbnn_tpu_torch.sampler.hmc import _kahan_add
    from tensorbnn_tpu_torch.sampler.potential import n_row_chunks

    del y
    matched = _model_program(model, likelihood)
    if matched is None:
        return None
    ops, lik = matched
    blocks = prior_blocks(model, unravel_eta, eta_dim)
    sd = _likelihood_sd(likelihood, unravel_eta, eta_dim)
    if (blocks is None or sd is None
            or not verify_theta_layout(unravel_theta, ops)):
        return None
    sd_fixed, sd_idx = sd
    # the sd_root hyper must be the last flat-eta coordinate
    if sd_idx is not None and sd_idx != eta_dim - 1:
        return None
    n = int(x.shape[0] if n_rows is None else n_rows)
    n_chunks = n_row_chunks(n, data_chunk)
    chunk = n // n_chunks
    vg = make_fused_potential_vg(ops, chunk, lik)
    if vg is None:
        return None

    def likelihood_vg(x_in, y_in, thetas, etas):
        sd_c = sd_fixed if sd_idx is None else etas[:, sd_idx] ** 2
        if n_chunks == 1:
            return vg(thetas, sd_c, x_in, y_in)
        acc = comp = thetas.new_zeros(thetas.shape[0])
        grad = None
        for i in range(0, n, chunk):
            value, g = vg(thetas, sd_c, x_in[i:i + chunk], y_in[i:i + chunk])
            acc, comp = _kahan_add(acc, comp, value)
            grad = g if grad is None else grad + g
        return acc, grad

    def batched_main_vg(thetas, etas, x_in, y_in, peers=None):
        if peers is None:
            value, grad = likelihood_vg(x_in, y_in, thetas, etas)
        else:
            value, grad = peers.sum(
                [functools.partial(likelihood_vg, *shard)
                 for shard in peers.shards], thetas, etas)
        return add_priors(blocks, thetas, etas, value, grad)

    program = vg.args[0]
    # one call's workspace bytes at c chains (a chunk's rows): the driver's
    # gate on the card's memory and the stepped graph runner's
    batched_main_vg.workspace_bytes = lambda c: 4 * program.workspace_floats(c)
    return batched_main_vg


# --------------------------------------------------------------------------
# The plain twins: the kernels' arithmetic in batched torch ops
# --------------------------------------------------------------------------

def _act_forward(op, a, slopes=None):
    kind = op[0]
    if kind == "tanh":
        return torch.tanh(a)
    if kind == "relu":
        return torch.clamp(a, min=0.0)
    if kind == "sigmoid":
        return torch.sigmoid(a)
    if kind == "exp":
        return torch.exp(a)
    if kind == "elu":
        return torch.where(a > 0.0, a, torch.exp(a) - 1.0)
    if kind == "leakyrelu":
        return torch.where(a < 0.0, op[2] * a, a)
    eff = slopes * slopes if kind == "sqprelu" else slopes    # prelu
    return torch.where(a < 0.0, eff[:, None, :] * a, a)


def _act_backward(op, h_in, h_out, slopes=None):
    """The activation's derivative: from its output, but for elu and the
    sampled slopes (from its input), as the JAX kernels take it."""
    kind = op[0]
    if kind == "tanh":
        return 1.0 - h_out * h_out
    if kind == "relu":
        return (h_out > 0.0).to(h_out.dtype)
    if kind == "sigmoid":
        return h_out * (1.0 - h_out)
    if kind == "exp":
        return h_out
    if kind == "elu":
        return torch.where(h_in > 0.0, 1.0, torch.exp(h_in))
    if kind == "leakyrelu":
        return torch.where(h_out < 0.0, op[2], 1.0)
    eff = slopes * slopes if kind == "sqprelu" else slopes    # prelu
    return torch.where(h_in < 0.0, eff[:, None, :], 1.0)


def _tail(lik: str, h, y, sd_c):
    """The likelihood's value ``(C,)`` and its gradient with respect to the
    program's output ``h (C, N, dk)``, as the kernels compute them."""
    if lik == "gaussian":
        n, dk = h.shape[1:]
        sd = sd_c.clamp(1e-8, 1e8)
        inv_sd2 = (1.0 / (sd * sd))[:, None, None]
        k = float(n * dk)
        resid = y - h
        value = -0.5 * ((resid * resid * inv_sd2).sum((1, 2))
                        + 2.0 * k * torch.log(sd) + k * LOG_2PI)
        return value, resid * inv_sd2
    if lik == "bernoulli":
        p = h.clamp(BERN_LO, BERN_HI)
        value = (y * torch.log(p) + (1.0 - y) * torch.log1p(-p)).sum((1, 2))
        in_range = (h > BERN_LO) & (h < BERN_HI)
        return value, torch.where(in_range, y / p - (1.0 - y) / (1.0 - p),
                                  0.0)
    # categorical over logits: softmax, then the clipped log of the
    # observed class's probability (tensorbnn_tpu/ops/fused_mlp.py:65-83)
    ez = torch.exp(h - h.amax(-1, keepdim=True))
    p = ez / ez.sum(-1, keepdim=True)
    py = (y * p).sum(-1, keepdim=True)
    value = torch.log(py.clamp(min=CAT_LO)).sum((1, 2))
    return value, torch.where(py > CAT_LO, y - p, 0.0)


def potential_plain(ops, thetas, sd_c, x, y, lik: str = "gaussian"):
    """The log likelihood ``(C,)`` of the ``lik`` tail and its gradient
    ``(C, D)`` at ``thetas (C, D)``, the Gaussian tail with the per-chain
    sd ``sd_c (C,)`` (clamped to [1e-8, 1e8]): forward pass and
    hand-written backward pass in batched torch ops, as the kernels compute
    them. K3's twin, and the likelihood half of K1's."""
    c = thetas.shape[0]
    d0, dk, _ = _program_dims(ops)
    x = x.reshape(-1, d0)
    n = x.shape[0]
    h = x.expand(c, n, d0)
    planes, offs = [h], []
    off = 0
    for op in ops:
        offs.append(off)
        if op[0] == "dense":
            d_in, d_out = op[1], op[2]
            b = thetas[:, off:off + d_out]
            w = thetas[:, off + d_out:off + d_out + d_in * d_out].reshape(
                c, d_in, d_out)
            h = torch.baddbmm(b[:, None, :], h, w)
        else:
            h = _act_forward(op, h, thetas[:, off:off + _op_rows(op)])
        off += _op_rows(op)
        planes.append(h)

    value, g = _tail(lik, h, _prep_labels(y, n, dk, lik), sd_c)
    grad = torch.empty_like(thetas)
    for i in range(len(ops) - 1, -1, -1):
        op, base = ops[i], offs[i]
        if op[0] == "dense":
            d_in, d_out = op[1], op[2]
            grad[:, base:base + d_out] = g.sum(1)
            grad[:, base + d_out:base + d_out + d_in * d_out] = torch.bmm(
                planes[i].transpose(1, 2), g).reshape(c, -1)
            if i > 0:
                w = thetas[:, base + d_out:base + d_out + d_in * d_out]
                g = torch.bmm(g, w.reshape(c, d_in, d_out).transpose(1, 2))
        else:
            slopes = thetas[:, base:base + _op_rows(op)]
            if op[0] in ("prelu", "sqprelu"):
                d_eff = (planes[i].clamp(max=0.0) * g).sum(1)
                grad[:, base:base + op[1]] = (
                    2.0 * slopes * d_eff if op[0] == "sqprelu" else d_eff)
            g = g * _act_backward(op, planes[i], planes[i + 1], slopes)
    return value, grad


@functools.lru_cache(maxsize=None)
def _raw_mask(flags: tuple, device: torch.device) -> torch.Tensor:
    """The Gaussian blocks' "gauss_raw" flags on ``device``, made once a
    device: a copy from the host cannot be captured in a CUDA graph."""
    return torch.tensor(flags, device=device)


def add_priors(blocks, q, etas, value, grad):
    """Adds the closed-form priors of ``blocks`` (``prior_blocks``) to
    ``value`` and, in place, to ``grad``; returns both. The Gaussian blocks'
    per-block scalars are taken for all of them at once, so each costs
    three launches: a wide model's blocks are large and a narrow model's
    many."""
    gauss = [b for b in blocks if b[0] in ("gauss", "gauss_raw")]
    if gauss:
        s = torch.stack([etas[:, b[4]] for b in gauss], 1)
        if any(b[0] == "gauss_raw" for b in gauss):
            raw = _raw_mask(tuple(b[0] == "gauss_raw" for b in gauss),
                            s.device)
            sig = torch.where(raw, s, s * s).clamp(1e-8, 1e8)
        else:
            sig = (s * s).clamp(1e-8, 1e8)
        iv = 1.0 / (sig * sig)                                # (C, blocks)
        norms = []
        for j, (_, start, rows, i_loc, _, _) in enumerate(gauss):
            dif = q[:, start:start + rows] - etas[:, i_loc, None]
            norms.append(torch.linalg.vector_norm(dif, dim=1))
            grad[:, start:start + rows].addcmul_(dif, iv[:, j:j + 1],
                                                 value=-1.0)
        quad = torch.stack(norms, 1).square()
        value = value - 0.5 * ((quad * iv).sum(1)
                               + 2.0 * torch.log(sig).sum(1)
                               + len(gauss) * LOG_2PI)
    for kind, start, rows, i_loc, i_scale, sign in blocks:
        blk = q[:, start:start + rows]
        if kind == "cauchy":
            gam = etas[:, i_scale] ** 2
            gam2 = (gam * gam)[:, None]
            dif = blk - etas[:, i_loc, None]
            d2 = dif * dif
            value = value + sign * torch.log1p(d2 / gam2).sum(1) \
                - rows * torch.log(math.pi * gam)
            grad[:, start:start + rows] += sign * 2.0 * dif / (gam2 + d2)
        elif kind == "exp":
            rate = etas[:, i_loc].abs()
            value = value - rate * blk.sum(1) + rows * torch.log(rate)
            grad[:, start:start + rows] -= rate[:, None]
    return value, grad


def program_value_and_grad(program: TrajectoryProgram, q, etas, x, y,
                           betas=None):
    """Log posterior ``(C,)`` and its gradient ``(C, D)`` at ``q (C, D)``,
    as K1 computes them: the program's likelihood tail (times ``betas
    (C,)`` when given, the power posterior) plus its closed-form priors."""
    if program.sd_idx is None:
        sd_c = torch.full((q.shape[0],), program.sd, dtype=q.dtype,
                          device=q.device)
    else:
        sd_c = etas[:, program.sd_idx] ** 2
    value, grad = potential_plain(program.ops, q, sd_c, x, y, program.lik)
    if betas is not None:
        value, grad = betas * value, betas[:, None] * grad
    return add_priors(program.prior_blocks, q, etas, value, grad)


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
    y = _prep_labels(y, program.n_rows, dk, program.lik)
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
