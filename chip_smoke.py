"""Drives the torch port's sampler on one NVIDIA card and checks it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (``nvcc``); it imports torch, numpy and
``tensorbnn_tpu_torch`` only. Phases, in order; any failure raises and the
script exits non-zero:

1. card: name and power limit (nvidia-smi); a CUDA device is required;
2. build: compiles the kernels from ``tensorbnn_tpu_torch/csrc``;
3. K1 (the fused main-block trajectory) against its plain twin at the
   flagship shapes, from a flagship Network's state: 64 chains with shared
   (eps, L) = (1e-2, 13) and (1e-3, 100), 512 chains with per-chain
   (eps, L) in 4 groups; K1's tempered program (per-chain betas, parallel
   tempering) at 256 replicas (64 x 4 rungs, beta_min 0.1) and 2,048
   (512 x 4, beta_min 0.5), per-rung (eps, L); K1's U-turn-recording
   program at 64 chains, (eps, L) = (1e-3, 100), and 512 chains with
   per-chain (eps, L), its U-turn steps equal to the twin's but at
   near-zero projections; K1 variant (d), from 0.3 N(0, 1) weights: the
   JAX bench's ``classification`` stack at 128 chains (shared and
   per-chain (eps, L)) and tempered at 128 x 4 rungs, ``multiclass`` at
   128 chains, the learned-sd and Cauchy-compat flagships and a Prelu +
   LeakyRelu stack at 64;
4. K2 (the fused hyper-block trajectory) against its twin at the hyper
   block of each main path, from the stats of that model's own state: the
   flagship at 64 and 512 chains, 100 steps (uncoupled); the learned-sd
   flagship at 64 chains, 30 steps, and ``wide_deep`` (the 10x256 model of
   benchmarks/run_benchmarks.py) at 64 chains, 5 steps (both coupled);
5. K3 (the per-step potential) against its twin at ``wide_deep`` (128
   rows, 64 chains, per-chain learned sd, weights from a Network's init),
   the flagship (64 chains, fixed sd) and a ragged stack; its Bernoulli
   tail and sqprelu at the tutorial shape (784-20-20-1 over 9,585 rows, 64
   chains), its categorical tail at a digits shape (64-20-10 over 1,437
   rows) and its prelu and leakyrelu at a ragged stack; then one
   ``wide_deep`` trajectory through K3 against the plain ``torch.func``
   potential;
6. the sampler through ``Network.train``: 3-epoch runs through K1 and K2,
   untempered and tempered (4 rungs), against the same runs on the plain
   path (same seed, same draws), then each main path with the kernels'
   launch counts set to 0 just before it and read just after: the flagship
   at 64 chains (one adapter, the verify recipe) and the 512-chain, G = 4
   quality block (the JAX bench's ``ess_run`` settings, 1,300 epochs) on
   K1 + K2; the tempered quality block (512 chains x 4 rungs at beta_min
   0.5, ``ess_run``'s settings) on tempered K1 + K2, with its swap rate
   per rung; ``wide_deep`` on K3 + K2 (6 epochs, (eps, L) = (1e-5, 20)),
   then on the plain path as a witness of its hyper acceptance; the
   learned-sd flagship on K1 (d) + K2; the JAX bench's ``classification``
   (K1 (d), plain hyper block) and ``multiclass`` (K1 (d) + K2) cells, 128
   chains over 60 epochs after 3 epochs against the plain path, held to
   the JAX package's acceptance and (classification) a training accuracy
   above 0.9, each printed as a ``{"cell": ...}`` line with its steady
   steps/sec; the tutorial-shaped model on K3 (6 epochs); the U-turn
   quality block
   (``trajectory="uturn"``, 512 chains at ``ess_run``'s settings) under
   the "alternate" and then the "always" probe on K1's U-turn-recording
   program + K2, held to the JAX package's seed-deterministic statistics;
   ``wide_deep`` in U-turn mode on K3 + K2. The quality blocks report ESS
   (the predictive mean at x = 0.5 and the worst parameter) per second;
7. times: each kernel against its twin (CUDA events), K3 against the
   same value and gradient through cuBLAS (the twin) and torch.func, K1's
   U-turn-recording program against the non-recording one on the same
   inputs, K1 (d) at its phase 3 shapes, K3 at the tutorial and digits
   shapes, the steady 64-chain leapfrog rates of the flagship at (eps, L)
   = (1e-3, 100) and of ``wide_deep`` at (1e-5, 20).

It prints the kernels' JSON line and the card's line before its last line,
``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# the main-block trajectories of phase 3 are compared with the tolerances
# of tests/test_fused_trajectory.py:72-79, (rtol, atol) for q, v, lp0, lp1
K1_TOL = ((1e-3, 1e-4), (1e-3, 1e-3), (1e-4, 1e-3), (1e-4, 1e-2))
# K2 over 100 steps, kernel vs twin in float32: (rtol, atol) for q, v,
# lp0, lp1 (tests/test_torch_cuda.py)
K2_TOL = ((1e-4, 1e-3),) * 4
# K3 against its twin: (rtol, atol) for ll and grad, the tolerances of
# tests/test_fused_mlp.py:33-36
K3_TOL = ((1e-4, 1e-4), (1e-3, 1e-4))
# At wide_deep the gradient reaches ~4e5 and each element is a float32 sum
# of 128 or 256 products of that scale, so an element that cancels to near
# zero keeps a rounding error of ~1e-7 of the largest ones: the kernel and
# the twin each differ from a float64 twin by up to ~6e-7 x max |grad| (on
# an H100 80GB HBM3). There the grad's atol grows by 2e-6 x max |grad|.
K3_WIDE_ATOL = 2e-6
# published H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the
# tensor cores, and HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# the verify recipe's sampler settings (.claude/skills/verify/SKILL.md)
RECIPE = dict(burnin=200, leapfrog_start=100, leapfrog_min=20,
              leapfrog_max=500, leapfrog_increment=5, averaging_steps=10,
              random_steps=5, hyper_leapfrog=30)
# the quality blocks' settings: ess_run in benchmarks/run_benchmarks.py
# (Network seed 11, chain jitter 0.05, 1,300 epochs, sampling step 2)
ESS_RUN = dict(step_size_start=2e-3, step_size_min=5e-4, step_size_max=2e-2,
               step_size_options=40, leapfrog_start=50, leapfrog_min=20,
               leapfrog_max=200, leapfrog_increment=5, hyper_step_size=1e-3,
               hyper_leapfrog=30, burnin=300, averaging_steps=10,
               random_steps=5)
ESS_EPOCHS = 1300
# the JAX package's swap rates per rung for the tempered block (K = 4 at
# beta_min 0.5; BENCH_r05.json, at 64 and 512 chains), a statistic of the
# sampler and not of the chip, and how far the port may be from them
SWAP_RUNG_REF = (0.34, 0.68, 0.68, 0.34)
SWAP_RUNG_TOL = 0.06
# per-rung (eps, L) of the kernel comparisons at per-chain (eps, L)
K1_GROUPS = ((1e-3, 100), (2e-3, 50), (5e-3, 25), (1e-2, 13))
# the JAX package's seed-deterministic statistics of the U-turn quality
# block (benchmarks/captures/r4_ess_uturn_probe2.json, PERF_NOTES.md:372-
# 419): statistics of the sampler, not of the chip, and how far the port's
# may be from them (total and min-param ESS as fractions)
UTURN_REF = {
    "alternate": dict(total_ess=189384, min_param_ess=14871,
                      main_accept=0.7930, final_leapfrog=200),
    "always": dict(total_ess=189257, min_param_ess=15200,
                   main_accept=0.8006, final_leapfrog=200)}
UTURN_ACCEPT_TOL = 0.05
UTURN_TOTAL_ESS_TOL = 0.30
UTURN_MIN_ESS_TOL = 0.50
# a kernel's recorded U-turn step may differ from the twin's only where the
# twin's projection at the first step either records is this close to 0,
# relative to ||q - q0|| ||v||: there two float32 orders of summation may
# give it either sign
UTURN_NEAR_ZERO = 1e-5
# the JAX bench's classification and multiclass cells
# (benchmarks/run_benchmarks.py:238-340): 128 chains, each cell's fixed (eps,
# L) and hyper steps, hyper step 1e-4, chain jitter 0.01, 60 epochs (the
# bench's warm-up chunk of 10 and five more); the last 10 epochs, after
# burn-in, are the window of the JAX package's figures
CLS_CELLS = {"classification": dict(eps=5e-4, steps=50, hyper_steps=10),
             "multiclass": dict(eps=1e-2, steps=20, hyper_steps=5)}
CLS_CHAINS, CLS_EPOCHS, CLS_BURNIN = 128, 60, 50
# the JAX package's main and hyper acceptance over epochs 51-60 of each cell
# at the same settings, on its XLA path (`JAX_PLATFORMS=cpu python3
# jax_reference_stats.py`, which runs run_benchmarks.py::_bench_sampler with
# use_fused=False): statistics of the sampler, not of the chip
CLS_REF = {"classification": dict(main_accept=0.998704731464386,
                                  hyper_accept=0.9714168310165405),
           "multiclass": dict(main_accept=0.9995704889297485,
                              hyper_accept=0.9770184755325317)}
CLS_ACCEPT_TOL, CLS_HYPER_TOL = 0.05, 0.15
# the training accuracy of the posterior-mean prediction that the
# classification cell must pass
CLS_MIN_ACCURACY = 0.9
# per-chain (eps, L) of K1 (d)'s comparisons at the classification shape
CLS_GROUPS = ((5e-4, 50), (1e-3, 40), (2e-3, 20), (5e-3, 10))
# rows of the tutorial-shaped model: 80% of MNIST's 11,982 training 3s and 8s
TUTORIAL_ROWS = 9585
# K1's U-turn comparisons draw each chain's prior sd (its scale hyper
# squared) from this range: the tight prior makes a stable oscillator whose
# half period (pi sd) falls on both sides of eps L, so some chains turn and
# some are censored (from the flagship's own prior, the trajectories that
# turn within 200 steps are those that diverge, where float32 orders drift)
UTURN_PRIOR_SD = (0.02, 0.06)


def phase(name):
    print(f"\n== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def trig_network(device, seed=0):
    """A Network over the flagship's data: 11 points of the reference's
    trig curve."""
    from tensorbnn_tpu_torch import Network
    x = np.linspace(-2, 2, 11).astype(np.float32)
    y = (np.sin(x * math.pi * 2) * x - np.cos(x * math.pi)).astype(
        np.float32)
    return Network(torch.float32, 1, x, y, x, y, seed=seed, device=device)


def flagship_network(device, seed=0, learned_sd=False, cauchy=False):
    """The flagship, 1-10-10-10-1 tanh, with a fixed- or learned-sd
    Gaussian likelihood; ``cauchy`` takes ``CauchyDenseLayer``s (the
    reference's default dense layer, its flipped density) for the Gaussian
    ones."""
    from tensorbnn_tpu_torch import CauchyDenseLayer, \
        FixedGaussianLikelihood, GaussianDenseLayer, GaussianLikelihood, Tanh
    dense = CauchyDenseLayer if cauchy else GaussianDenseLayer
    net = trig_network(device, seed)
    net.add(dense(1, 10)).add(Tanh())
    net.add(dense(10, 10)).add(Tanh())
    net.add(dense(10, 10)).add(Tanh())
    net.add(dense(10, 1))
    if learned_sd:
        return net, GaussianLikelihood(sd=0.1)
    return net, FixedGaussianLikelihood(sd=0.1)


def prelu_network(device, seed=0):
    """1-10-10-1 with a Prelu and a LeakyRelu (alpha 0.3) on the flagship
    data, fixed-sd Gaussian likelihood: K1's two other slope ops and the
    exponential prior."""
    from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
        GaussianDenseLayer, LeakyRelu, Prelu
    net = trig_network(device, seed)
    net.add(GaussianDenseLayer(1, 10)).add(Prelu(10))
    net.add(GaussianDenseLayer(10, 10)).add(LeakyRelu(0.3))
    net.add(GaussianDenseLayer(10, 1))
    return net, FixedGaussianLikelihood(sd=0.1)


def classification_network(device, seed=0):
    """``classification`` of benchmarks/run_benchmarks.py:238-293:
    GaussianDense(10, 16), SquarePrelu(16), GaussianDense(16, 16),
    SquarePrelu(16), GaussianDense(16, 1), Sigmoid, under the Bernoulli
    likelihood, over 64 rows of N(0, 1) data (``default_rng(2)``) labelled
    ``sum(x) > 0``."""
    from tensorbnn_tpu_torch import BernoulliLikelihood, GaussianDenseLayer, \
        Network, Sigmoid, SquarePrelu
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 10)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    net = Network(torch.float32, 10, x, y, x, y, seed=seed, device=device)
    net.add(GaussianDenseLayer(10, 16)).add(SquarePrelu(16))
    net.add(GaussianDenseLayer(16, 16)).add(SquarePrelu(16))
    net.add(GaussianDenseLayer(16, 1)).add(Sigmoid())
    return net, BernoulliLikelihood()


def multiclass_network(device, seed=0):
    """``multiclass`` of benchmarks/run_benchmarks.py:295-340:
    GaussianDense(2, 8), Tanh, GaussianDense(8, 3), Softmax, under the
    categorical likelihood, over 16 rows of N(0, 1) data
    (``default_rng(3)``) with class ids 0..2 as labels."""
    from tensorbnn_tpu_torch import CategoricalLikelihood, \
        GaussianDenseLayer, Network, Softmax, Tanh
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 2)).astype(np.float32)
    y = rng.integers(0, 3, size=16).astype(np.float32)
    net = Network(torch.float32, 2, x, y, x, y, seed=seed, device=device)
    net.add(GaussianDenseLayer(2, 8)).add(Tanh())
    net.add(GaussianDenseLayer(8, 3)).add(Softmax())
    return net, CategoricalLikelihood()


def tutorial_network(device, seed=0):
    """The reference's classification tutorial stack at MNIST 3-vs-8 width
    (examples/digits_classification.py:18-20, :81-103 with 784 inputs):
    GaussianDense(784, 20), SquarePrelu(20, alpha=sqrt(0.1)),
    GaussianDense(20, 20), SquarePrelu(20), GaussianDense(20, 1), Sigmoid,
    Bernoulli, over ``TUTORIAL_ROWS`` rows of uniform [0, 1) pixels
    (``default_rng(5)``; MNIST is not in the repository) labelled by a
    fixed random hyperplane through the pixels' mean."""
    from tensorbnn_tpu_torch import BernoulliLikelihood, GaussianDenseLayer, \
        Network, Sigmoid, SquarePrelu
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(TUTORIAL_ROWS, 784)).astype(np.float32)
    y = ((x - 0.5) @ rng.normal(size=784) > 0).astype(np.float32)
    net = Network(torch.float32, 784, x, y, x, y, seed=seed, device=device)
    net.add(GaussianDenseLayer(784, 20))
    net.add(SquarePrelu(20, alpha=math.sqrt(0.1)))
    net.add(GaussianDenseLayer(20, 20)).add(SquarePrelu(20))
    net.add(GaussianDenseLayer(20, 1)).add(Sigmoid())
    return net, BernoulliLikelihood()


def cls_mcmc(cell, burnin=CLS_BURNIN):
    """``setup_mcmc`` settings of a classification cell: its fixed (eps, L)
    (the adapter's first change would come after 100 epochs, past the
    run), hyper steps and hyper step 1e-4, as ``_bench_sampler`` runs
    it."""
    c = CLS_CELLS[cell]
    return dict(step_size_start=c["eps"], step_size_min=c["eps"],
                step_size_max=c["eps"], leapfrog_start=c["steps"],
                leapfrog_min=c["steps"], leapfrog_max=c["steps"],
                hyper_leapfrog=c["hyper_steps"], hyper_step_size=1e-4,
                burnin=burnin, averaging_steps=100)


def train_accuracy(net, res):
    """Training accuracy of the posterior-mean prediction over the
    recorded samples: probabilities above 0.5 for a sigmoid head, the
    argmax for a softmax one."""
    from tensorbnn_tpu_torch.sampler.potential import flatten_state

    params, hypers = net.init_state()
    unravel = flatten_state(params, hypers, {}).unravel_theta
    thetas = torch.tensor(res.theta_pooled, device=net.device)
    preds = torch.func.vmap(lambda th: net.model.apply(
        unravel(th), net.train_x))(thetas).mean(0)
    y = net.train_y.reshape(-1)
    if preds.shape[1] == 1:
        hit = (preds[:, 0] > 0.5) == (y > 0.5)
    else:
        hit = preds.argmax(1) == y.to(torch.int64)
    return float(hit.to(torch.float32).mean())


def wide_network(device, seed=0):
    """``wide_deep`` of benchmarks/run_benchmarks.py:128-164: 9 x (dense
    256 -> 256, tanh), dense 256 -> 1, over 128 rows of N(0, 1) data, under
    a learned-sd Gaussian likelihood (sd 0.1)."""
    from tensorbnn_tpu_torch import GaussianDenseLayer, GaussianLikelihood, \
        Network, Tanh
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 256)).astype(np.float32)
    y = rng.normal(size=(128, 1)).astype(np.float32)
    net = Network(torch.float32, 256, x, y, x, y, seed=seed, device=device)
    for _ in range(9):
        net.add(GaussianDenseLayer(256, 256)).add(Tanh())
    net.add(GaussianDenseLayer(256, 1))
    return net, GaussianLikelihood(sd=0.1)


def chunk_runner(net, lik, flat, hyper_steps, hyper_eps, tempering_beta=None,
                 record_uturn=False):
    """The chunk runner of ``(net, lik)`` with the kernels that
    ``sample_posterior`` picks (K1, else K3, for the main block; K2 for the
    hyper block where the stats layout applies, else the plain block),
    ``hyper_steps`` hyper leapfrog steps from ``hyper_eps``,
    tempered by ``tempering_beta = (K, per-chain betas)`` when given (K1's
    tempered program, never K3), recording U-turn steps with
    ``record_uturn`` (K1's recording program): the steady rates here and
    the profile of chip_profile.py."""
    from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
    from tensorbnn_tpu_torch.parallel.chains import \
        make_multichain_chunk_runner

    h = flat.eta.numel()
    x, y = net.train_x, net.train_y
    tempered = tempering_beta is not None
    traj = fused_mlp.try_build_fused_trajectory(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h,
        tempered=tempered, record_uturn=record_uturn)
    vg = None if traj or tempered else fused_mlp.try_build_fused_main_vg(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h)
    hyper = fused_hyper.try_build_fused_hyper_trajectory(
        net.model, lik, flat.unravel_eta, h, hyper_steps)
    assert traj or vg, "the main-block kernels declined the model"
    return make_multichain_chunk_runner(
        net.model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
        adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
        hyper_step_size_init=hyper_eps, eta_dim=h, batched_main_traj=traj,
        batched_main_vg=vg, batched_hyper_traj=hyper,
        tempering_beta=tempering_beta, record_uturn=record_uturn)


def rung_groups(c, n_rungs=4):
    """Per-chain ``(eps (C,), L (C,))`` of ``K1_GROUPS``, one group per
    rung of a rung-major fleet of ``c`` replicas."""
    groups = np.repeat(np.asarray(K1_GROUPS[:n_rungs]), c // n_rungs, axis=0)
    return groups[:, 0].astype(np.float32), groups[:, 1].astype(np.int32)


def quality(label, net, res, wall, burnin, **extra):
    """The quality figures of ``ess_run``: total ESS of the predictive mean
    at x = 0.5 (``effective_sample_size_batch`` over chains), the worst
    parameter's pooled ESS, both per second of ``wall``, and the
    post-burn-in main and hyper acceptance (and the swap rate per rung of
    a tempered run, and ``extra``). Prints them as one JSON line."""
    from tensorbnn_tpu_torch.sampler.potential import flatten_state
    from tensorbnn_tpu_torch.utils.autocorr import \
        effective_sample_size_batch

    params, hypers = net.init_state()
    unravel = flatten_state(params, hypers, {}).unravel_theta
    s, c, d = res.theta_samples.shape
    xq = torch.tensor([[0.5]], device=net.device)
    thetas = torch.tensor(res.theta_samples.reshape(s * c, d),
                          device=net.device)
    series = torch.func.vmap(
        lambda th: net.model.apply(unravel(th), xq)[0, 0])(thetas)
    total = effective_sample_size_batch(series.reshape(s, c).cpu().numpy().T)
    param_ess = res.multichain_ess(max_params=256)
    out = {"block": label, "n_chains": c, "epochs": res.n_epochs,
           "wall_seconds": wall, "total_ess": total,
           "ess_per_sec": total / wall, "min_param_ess": float(param_ess),
           "median_param_ess": param_ess.median,
           "min_param_ess_per_sec": float(param_ess) / wall,
           "main_accept": float(res.main_accept[burnin:].mean()),
           "hyper_accept": float(res.hyper_accept[burnin:].mean()),
           "final_step_size": res.final_step_size,
           "final_leapfrog": res.final_leapfrog}
    if res.swap_accept_rung is not None:
        out["swap_accept_rung"] = res.swap_accept_rung.mean(axis=0).tolist()
    out.update(extra)
    print(json.dumps({"quality": out}), flush=True)
    return out


def uturn_inputs(program, flat, c, x, y, g):
    """K1 inputs of ``c`` chains for the U-turn comparisons: 0.3 N(0, 1)
    weights and N(0, 1) momenta as ``k1_inputs``, each chain's prior sd
    drawn from ``UTURN_PRIOR_SD``."""
    dev = x.device
    d, h = flat.theta.numel(), flat.eta.numel()
    thetas = 0.3 * torch.randn((c, d), generator=g, device=dev)
    mom = torch.randn((c, d), generator=g, device=dev)
    lo, hi = UTURN_PRIOR_SD
    sd = lo + (hi - lo) * torch.rand(c, generator=g, device=dev)
    etas = flat.eta.expand(c, h).clone()
    for _, _, _, _, i_scale, _ in program.prior_blocks:
        etas[:, i_scale] = sd.sqrt()
    return thetas, etas, mom, x, y


def uturn_projection(program, args, eps_c, c, step):
    """The twin's U-turn projection ``(q - q0) . v_rec`` of chain ``c`` at
    ``step``, and its scale ``||q - q0|| ||v_rec||``: the twin run to L =
    step ends with q at that step and v half-kicked, and the other half
    kick gives v_rec."""
    from tensorbnn_tpu_torch.ops import fused_mlp

    thetas, etas, mom = (a[c:c + 1] for a in args[:3])
    x, y = args[3:]
    eps = eps_c[c:c + 1]
    steps = torch.full((1,), step, dtype=torch.int32, device=eps.device)
    q, v, *_ = fused_mlp.trajectory_plain(program, thetas, etas, mom, x, y,
                                          eps, steps)
    _, g = fused_mlp.program_value_and_grad(program, q, etas, x, y)
    d_q, v_rec = q - thetas, v + 0.5 * eps[:, None] * g
    return (float((d_q * v_rec).sum()),
            float(d_q.norm() * v_rec.norm()))


def check_uturns(label, program, args, eps_c, l_c, got, want):
    """Raises unless the kernel's U-turn steps equal the twin's, but at
    near-zero projections (``UTURN_NEAR_ZERO``), and unless some chains
    turned and some were censored; prints how many chains turned and were
    censored, and how many differ at such projections."""
    got, want = got.cpu(), want.cpu()
    near = 0
    for c in (got != want).nonzero()[:, 0].tolist():
        step = min(s for s in (int(got[c]), int(want[c])) if s > 0)
        proj, scale = uturn_projection(program, args, eps_c, c, step)
        if abs(proj) >= UTURN_NEAR_ZERO * scale:
            raise AssertionError(
                f"{label}: chain {c} turned at step {int(got[c])} on the "
                f"kernel and {int(want[c])} on the twin; the twin's "
                f"projection at step {step} is {proj:.3e}, not near 0 "
                f"(scale {scale:.3e})")
        near += 1
    turned = int((want > 0).sum())
    censored = want.numel() - turned
    print(f"{label}: U-turn steps: {turned} chains turned, {censored} "
          f"censored (L up to {int(l_c.max())}); {near} differ at near-zero "
          f"projections")
    if not (turned and censored):
        raise AssertionError(f"{label}: the comparison needs chains that "
                             f"turn and chains that are censored")
    return turned, censored, near


def dual_averaging_steps(accepts, eps0, burnin):
    """The hyper step after each epoch under the JAX package's dual
    averaging (tensorbnn_tpu/sampler/gibbs.py:274-280, mu from
    parallel/chains.py:144: target 0.95, gamma 0.4, t0 10, kappa 0.75, mu =
    log(100 eps0), frozen from 80% of burn-in), in float64 on the host, for
    per-epoch acceptances that every chain shares."""
    mu = math.log(100.0 * eps0)
    h = log_bar = 0.0
    step, steps = eps0, []
    for m, acc in enumerate(accepts, 1):
        h = (1.0 - 1.0 / (m + 10.0)) * h + (0.95 - acc) / (m + 10.0)
        log_eps = mu - h * math.sqrt(m) / 0.4
        log_bar = (1.0 - m ** -0.75) * log_bar + m ** -0.75 * log_eps
        if m < 0.8 * burnin:
            step = math.exp(log_bar)
        steps.append(step)
    return steps


def compare(name, got, want, tols, labels=("q", "v", "lp0", "lp1")):
    """Max abs error of the kernel's outputs against the twin's; raises
    unless every output is within its (rtol, atol)."""
    worst = 0.0
    for label, g, w, (rtol, atol) in zip(labels, got, want, tols):
        if not torch.isclose(g, w, rtol=rtol, atol=atol,
                             equal_nan=True).all():
            bad = (g - w).abs().max().item()
            raise AssertionError(f"{name}: {label} differs from the twin "
                                 f"(max abs err {bad:.3e}, rtol {rtol}, "
                                 f"atol {atol})")
        both = torch.isfinite(g) & torch.isfinite(w)
        if both.any():
            worst = max(worst, (g - w)[both].abs().max().item())
    print(f"{name}: max abs err {worst:.3e}")
    return worst


def bound(flops, nbytes):
    """(ms, what sets it): the least time for ``flops`` float32 operations
    and ``nbytes`` moved, at the card's published peaks."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def product_flops(ops, n):
    """Float32 operations of one likelihood value and gradient per chain:
    the multiply-adds of the forward products, the weight gradients and
    the input gradients (none for the first layer), 2 FLOP each, plus the
    bias adds and sums (activations and the tail, under 1%, are left
    out)."""
    dense = [(op[1], op[2]) for op in ops if op[0] == "dense"]
    fwd = sum(2 * n * a * b + n * b for a, b in dense)
    return 2 * fwd + sum(2 * n * a * b for a, b in dense[1:])


def torch_func_potential(model, unravel_theta, x, y):
    """``f(thetas (C, D), sd (C,)) -> (ll, grad)``: the Gaussian
    likelihood's gradient and value through ``torch.func`` (cuBLAS batched
    products under vmap, autograd's backward), timed beside K3; the port
    never calls it on the card path."""
    from torch.func import grad_and_value, vmap

    from tensorbnn_tpu_torch.distributions import gaussian_logprob

    def loglik(theta, sd):
        preds = model.apply(unravel_theta(theta), x)
        return gaussian_logprob(torch.ones_like(preds) * sd, preds,
                                y.reshape(preds.shape))

    vg = vmap(grad_and_value(loglik))
    return lambda thetas, sd: vg(thetas, sd)[::-1]


def cuda_ms(fn, reps=10):
    """Mean milliseconds per call on the card, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    phase("1 card")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from tensorbnn_tpu_torch.ops import _build, fused_hyper, fused_mlp
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.sampler.hmc import leapfrog_batched
    from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper
    from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
        make_potentials
    from tensorbnn_tpu_torch.sampler.tempering import make_ladder

    phase("2 build")
    t0 = time.perf_counter()
    _build.load(verbose=True)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s)")

    net, lik = flagship_network(dev)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, {})
    d, h = flat.theta.numel(), flat.eta.numel()
    x, y = net.train_x, net.train_y
    program = fused_mlp.build_trajectory_program(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, h,
        n_rows=x.shape[0])
    assert program is not None
    gen = torch.Generator(device=dev).manual_seed(1)

    def k1_inputs(c, g=gen):
        # weights drawn as tests/test_fused_trajectory.py:53 draws them
        # (0.3 N(0, 1)); prior and likelihood are the Network's. From the
        # Network's He-init start, (eps, L) = (1e-2, 13) already leaves
        # the leapfrog's stable range and any two float32 orders of
        # summation drift apart there
        thetas = 0.3 * torch.randn((c, d), generator=g, device=dev)
        etas = flat.eta.expand(c, h).contiguous()
        mom = torch.randn((c, d), generator=g, device=dev)
        return thetas, etas, mom, x, y

    phase("3 K1 against its twin")
    k1_err = 0.0
    g_eps, g_l = rung_groups(512)
    cases = [(64, 1e-2, 13), (64, 1e-3, 100),
             (512, torch.tensor(g_eps, device=dev),
              torch.tensor(g_l, device=dev))]
    k1_shapes = {}
    for c, eps, steps in cases:
        args = k1_inputs(c)
        eps_c, l_c = fused_mlp.per_chain(eps, steps, c, dev)
        got = fused_mlp.fused_trajectory(program, *args, eps_c, l_c)
        want = fused_mlp.trajectory_plain(program, *args, eps_c, l_c)
        torch.cuda.synchronize()
        label = (f"K1 C={c} " + (f"(eps, L)=({eps}, {steps})" if c == 64
                                 else "per-chain (eps, L) in 4 groups"))
        k1_err = max(k1_err, compare(label, got, want, K1_TOL))
        k1_shapes[label] = (program, args, eps_c, l_c)

    # K1 variant (c): the tempered program on rung-major fleets of 4 rungs,
    # per-chain betas from the ladder and per-rung (eps, L)
    t_program = fused_mlp.build_trajectory_program(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, h,
        n_rows=x.shape[0], tempered=True)
    assert t_program is not None and t_program.tempered
    k1t_err = 0.0
    k1t_shapes = {}
    # its own generator, so the later phases draw what they drew before
    t_gen = torch.Generator(device=dev).manual_seed(3)
    for n_cold, beta_min in ((64, 0.1), (512, 0.5)):
        c = 4 * n_cold
        args = k1_inputs(c, t_gen)
        g_eps, g_l = rung_groups(c)
        eps_c, l_c = (torch.tensor(g_eps, device=dev),
                      torch.tensor(g_l, device=dev))
        betas = torch.tensor(np.repeat(make_ladder(4, beta_min), n_cold),
                             device=dev)
        got = fused_mlp.fused_trajectory(t_program, *args, eps_c, l_c, betas)
        want = fused_mlp.trajectory_plain(t_program, *args, eps_c, l_c,
                                          betas)
        torch.cuda.synchronize()
        label = (f"K1 tempered C={c} ({n_cold} x 4 rungs, beta_min "
                 f"{beta_min}) per-rung (eps, L)")
        k1t_err = max(k1t_err, compare(label, got, want, K1_TOL))
        k1t_shapes[c] = (args, eps_c, l_c, betas)

    # K1 variant (e): the U-turn-recording program, with the prior sd of
    # each chain drawn from UTURN_PRIOR_SD so that some chains turn and
    # some are censored
    u_program = fused_mlp.build_trajectory_program(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, h,
        n_rows=x.shape[0], record_uturn=True)
    assert u_program is not None and u_program.record_uturn
    k1u_err = 0.0
    k1u_counts = {}
    u_gen = torch.Generator(device=dev).manual_seed(5)
    g_eps, g_l = rung_groups(512)
    for c, eps, steps in ((64, 1e-3, 100),
                          (512, torch.tensor(g_eps, device=dev),
                           torch.tensor(g_l, device=dev))):
        args = uturn_inputs(u_program, flat, c, x, y, u_gen)
        eps_c, l_c = fused_mlp.per_chain(eps, steps, c, dev)
        got = fused_mlp.fused_trajectory(u_program, *args, eps_c, l_c)
        want = fused_mlp.trajectory_plain(u_program, *args, eps_c, l_c)
        torch.cuda.synchronize()
        label = (f"K1 record_uturn C={c} "
                 + (f"(eps, L)=({eps}, {steps})" if c == 64
                    else "per-chain (eps, L) in 4 groups"))
        k1u_err = max(k1u_err, compare(label, got[:4], want[:4], K1_TOL))
        k1u_counts[label] = check_uturns(label, u_program, args, eps_c, l_c,
                                         got[4], want[4])

    # K1 variant (d): the other tails, activations and priors, each from
    # 0.3 N(0, 1) weights and its Network's hypers, with its own generator
    def k1d_program(knet, klik, tempered=False):
        kparams, khypers = knet.init_state()
        kflat = flatten_state(kparams, khypers, klik.init_hypers(device=dev))
        prog = fused_mlp.build_trajectory_program(
            knet.model, klik, kflat.unravel_theta, kflat.unravel_eta,
            kflat.eta.numel(), n_rows=knet.train_x.shape[0],
            tempered=tempered)
        assert prog is not None, "K1 declined a model of variant (d)"
        return prog, kflat

    def k1d_inputs(knet, kflat, c, g):
        kd, kh = kflat.theta.numel(), kflat.eta.numel()
        return (0.3 * torch.randn((c, kd), generator=g, device=dev),
                kflat.eta.expand(c, kh).contiguous(),
                torch.randn((c, kd), generator=g, device=dev),
                knet.train_x, knet.train_y)

    d_gen = torch.Generator(device=dev).manual_seed(7)
    cls_net, cls_lik = classification_network(dev)
    c_eps, c_l = (np.repeat(np.asarray(CLS_GROUPS)[:, i], CLS_CHAINS // 4)
                  for i in (0, 1))
    k1d_cases = [
        ("K1 (d) classification C=128 (eps, L)=(0.0005, 50)", cls_net,
         cls_lik, CLS_CHAINS, 5e-4, 50),
        ("K1 (d) classification C=128 per-chain (eps, L) in 4 groups",
         cls_net, cls_lik, CLS_CHAINS,
         torch.tensor(c_eps, dtype=torch.float32, device=dev),
         torch.tensor(c_l, dtype=torch.int32, device=dev)),
        ("K1 (d) multiclass C=128 (eps, L)=(0.01, 20)",
         *multiclass_network(dev), CLS_CHAINS, 1e-2, 20),
        ("K1 (d) learned-sd flagship C=64 (eps, L)=(0.001, 100)",
         *flagship_network(dev, learned_sd=True), 64, 1e-3, 100),
        ("K1 (d) Cauchy-compat flagship C=64 (eps, L)=(0.001, 100)",
         *flagship_network(dev, cauchy=True), 64, 1e-3, 100),
        ("K1 (d) Prelu + LeakyRelu C=64 (eps, L)=(0.001, 100)",
         *prelu_network(dev), 64, 1e-3, 100)]
    k1d_err = 0.0
    k1d_shapes = {}
    for label, knet, klik, c, eps, steps in k1d_cases:
        prog, kflat = k1d_program(knet, klik)
        args = k1d_inputs(knet, kflat, c, d_gen)
        eps_c, l_c = fused_mlp.per_chain(eps, steps, c, dev)
        got = fused_mlp.fused_trajectory(prog, *args, eps_c, l_c)
        want = fused_mlp.trajectory_plain(prog, *args, eps_c, l_c)
        torch.cuda.synchronize()
        k1d_err = max(k1d_err, compare(label, got, want, K1_TOL))
        k1d_shapes[label] = (prog, args, eps_c, l_c)
    # one tempered Bernoulli launch: 128 chains x 4 rungs at beta_min 0.5,
    # per-rung (eps, L)
    prog, kflat = k1d_program(cls_net, cls_lik, tempered=True)
    c = 4 * CLS_CHAINS
    args = k1d_inputs(cls_net, kflat, c, d_gen)
    eps_c = torch.tensor(np.repeat(np.asarray(CLS_GROUPS)[:, 0], CLS_CHAINS),
                         dtype=torch.float32, device=dev)
    l_c = torch.tensor(np.repeat(np.asarray(CLS_GROUPS)[:, 1], CLS_CHAINS),
                       dtype=torch.int32, device=dev)
    betas = torch.tensor(np.repeat(make_ladder(4, 0.5), CLS_CHAINS),
                         dtype=torch.float32, device=dev)
    got = fused_mlp.fused_trajectory(prog, *args, eps_c, l_c, betas)
    want = fused_mlp.trajectory_plain(prog, *args, eps_c, l_c, betas)
    torch.cuda.synchronize()
    k1d_err = max(k1d_err, compare(
        "K1 (d) tempered classification C=512 (128 x 4 rungs, beta_min "
        "0.5) per-rung (eps, L)", got, want, K1_TOL))

    phase("4 K2 against its twin")
    wnet, wlik = wide_network(dev)
    wparams, whypers = wnet.init_state()
    wflat = flatten_state(wparams, whypers, wlik.init_hypers(device=dev))
    wd, wh = wflat.theta.numel(), wflat.eta.numel()
    wx, wy = wnet.train_x, wnet.train_y
    c_w = 64
    # chains spread around the Network's init; per-chain learned sd
    w_thetas = wflat.theta + 0.01 * torch.randn((c_w, wd), generator=gen,
                                                device=dev)
    w_etas = wflat.eta.expand(c_w, wh).clone()
    w_etas[:, -1] *= 1.0 + 0.05 * torch.randn(c_w, generator=gen,
                                              device=dev)
    lnet0, llik0 = flagship_network(dev, learned_sd=True)
    lparams, lhypers = lnet0.init_state()
    lflat = flatten_state(lparams, lhypers, llik0.init_hypers(device=dev))
    l_thetas = lflat.theta + 0.1 * torch.randn((64, lflat.theta.numel()),
                                               generator=gen, device=dev)
    l_etas = lflat.eta + 0.05 * torch.randn((64, lflat.eta.numel()),
                                            generator=gen, device=dev)
    # each main path's hyper block, with the stats of its own model's state
    # and its own step count; eps is the step its run starts from
    k2_cases = [(f"K2 C={c} n_steps=100", net, lik, flat, 100, 1e-3, False,
                 flat.theta + 0.1 * torch.randn((c, d), generator=gen,
                                                device=dev),
                 flat.eta + 0.05 * torch.randn((c, h), generator=gen,
                                               device=dev))
                for c in (64, 512)]
    k2_cases += [
        ("K2 coupled learned-sd flagship C=64 H=17 n_steps=30", lnet0,
         llik0, lflat, 30, 1e-2, True, l_thetas, l_etas),
        ("K2 coupled wide_deep C=64 H=41 n_steps=5", wnet, wlik, wflat, 5,
         1e-4, True, w_thetas, w_etas)]
    k2_err = 0.0
    k2_shapes = {}
    for label, knet, klik, kflat, n_steps, eps, coupled, thetas, etas in \
            k2_cases:
        c, kh = etas.shape
        prog = fused_hyper.build_hyper_program(knet.model, klik,
                                               kflat.unravel_eta, kh, n_steps)
        assert prog is not None and prog.coupled == coupled, label
        stats_fn, _, _ = make_stats_hyper(knet.model, klik, knet.train_x,
                                       knet.train_y, kflat.unravel_theta,
                                       kflat.unravel_eta, kh)
        args = (etas, stats_fn(thetas),
                torch.randn((c, kh), generator=gen, device=dev),
                torch.full((c,), eps, device=dev))
        got = fused_hyper.fused_hyper_trajectory(prog, *args)
        want = fused_hyper.hyper_trajectory_plain(prog, *args)
        torch.cuda.synchronize()
        k2_err = max(k2_err, compare(label, got, want, K2_TOL))
        k2_shapes[label] = (prog, args)

    phase("5 K3 against its twin")
    wide_ops = (("dense", 256, 256), ("tanh", 256)) * 9 + (("dense", 256,
                                                             1),)
    ragged_ops = (("dense", 3, 37), ("relu", 37), ("dense", 37, 70),
                  ("elu", 70), ("dense", 70, 1))
    _, _, d_rag = fused_mlp._program_dims(ragged_ops)
    k3_inputs = {
        "K3 wide_deep C=64 N=128": (
            wide_ops, w_thetas, w_etas[:, -1] ** 2, wx, wy),
        "K3 flagship C=64 N=11": (
            program.ops, 0.3 * torch.randn((64, d), generator=gen,
                                           device=dev),
            torch.full((64,), 0.1, device=dev), x, y),
        "K3 ragged 3-37-70-1 C=5 N=13": (
            ragged_ops, 0.3 * torch.randn((5, d_rag), generator=gen,
                                          device=dev),
            0.1 + 0.2 * torch.rand(5, generator=gen, device=dev),
            torch.randn((13, 3), generator=gen, device=dev),
            torch.randn((13, 1), generator=gen, device=dev)),
    }
    k3_err = 0.0
    k3_shapes = {}
    for label, (ops, thetas, sd_c, xs, ys) in k3_inputs.items():
        vg = fused_mlp.make_fused_potential_vg(ops, xs.shape[0])
        got = vg(thetas, sd_c, xs, ys)
        want = fused_mlp.potential_plain(ops, thetas, sd_c, xs, ys)
        torch.cuda.synchronize()
        tols = K3_TOL
        if label.startswith("K3 wide_deep"):
            scale = want[1].abs().max().item()
            tols = (K3_TOL[0], (K3_TOL[1][0],
                                K3_TOL[1][1] + K3_WIDE_ATOL * scale))
            print(f"{label}: grad atol {tols[1][1]:.3e} "
                  f"(max |grad| {scale:.3e})")
        k3_err = max(k3_err, compare(label, got, want, tols,
                                     labels=("ll", "grad")))
        k3_shapes[label] = (vg, ops, thetas, sd_c, xs, ys)

    # K3's Bernoulli and categorical tails and the slope ops, from 0.3
    # N(0, 1) weights (the tutorial's He-init start saturates the sigmoid,
    # where 1 - p keeps one or two bits and two float32 orders disagree)
    t_gen = torch.Generator(device=dev).manual_seed(9)
    tut_net, tut_lik = tutorial_network(dev)
    tut_ops = (("dense", 784, 20), ("sqprelu", 20), ("dense", 20, 20),
               ("sqprelu", 20), ("dense", 20, 1), ("sigmoid", 1))
    digit_ops = (("dense", 64, 20), ("tanh", 20), ("dense", 20, 10))
    slope_ops = (("dense", 3, 37), ("prelu", 37), ("dense", 37, 70),
                 ("leakyrelu", 70, 0.3), ("dense", 70, 1))
    dg = np.random.default_rng(6)
    k3t_inputs = {
        f"K3 Bernoulli + sqprelu tutorial C=64 N={TUTORIAL_ROWS}": (
            tut_ops, "bernoulli", 64, tut_net.train_x, tut_net.train_y),
        "K3 categorical digits 64-20-10 C=64 N=1437": (
            digit_ops, "categorical", 64,
            torch.tensor(dg.integers(0, 17, size=(1437, 64)) / 16.0,
                         dtype=torch.float32, device=dev),
            torch.tensor(dg.integers(0, 10, size=1437), dtype=torch.float32,
                         device=dev)),
        "K3 prelu + leakyrelu 3-37-70-1 C=5 N=13": (
            slope_ops, "gaussian", 5,
            torch.randn((13, 3), generator=t_gen, device=dev),
            torch.randn((13, 1), generator=t_gen, device=dev)),
    }
    k3t_err = 0.0
    for label, (ops, klik, c, xs, ys) in k3t_inputs.items():
        _, _, kd = fused_mlp._program_dims(ops)
        thetas = 0.3 * torch.randn((c, kd), generator=t_gen, device=dev)
        sd_c = 0.1 + 0.2 * torch.rand(c, generator=t_gen, device=dev)
        vg = fused_mlp.make_fused_potential_vg(ops, xs.shape[0], klik)
        got = vg(thetas, sd_c, xs, ys)
        want = fused_mlp.potential_plain(ops, thetas, sd_c, xs, ys, klik)
        torch.cuda.synchronize()
        tols = K3_TOL
        if klik == "bernoulli":
            # each weight-gradient element sums 9,585 rows: the wide_deep
            # rule (K3_WIDE_ATOL) for sums whose terms cancel
            scale = want[1].abs().max().item()
            tols = (K3_TOL[0], (K3_TOL[1][0],
                                K3_TOL[1][1] + K3_WIDE_ATOL * scale))
            print(f"{label}: grad atol {tols[1][1]:.3e} "
                  f"(max |grad| {scale:.3e})")
        k3t_err = max(k3t_err, compare(label, got, want, tols,
                                       labels=("ll", "grad")))
        k3_shapes[label] = (vg, ops, thetas, sd_c, xs, ys)
    # K1 declines the tutorial and digits shapes (their planes are past one
    # block's shared memory); the driver takes K3 for them
    tparams, thypers = tut_net.init_state()
    tflat = flatten_state(tparams, thypers, {})
    assert fused_mlp.build_trajectory_program(
        tut_net.model, tut_lik, tflat.unravel_theta, tflat.unravel_eta,
        tflat.eta.numel(), n_rows=TUTORIAL_ROWS) is None
    assert fused_mlp.TrajectoryProgram(
        digit_ops, (), 1.0, 1437, 1, lik="categorical").smem_bytes > \
        fused_mlp.SMEM_BUDGET_BYTES

    # one wide_deep trajectory through K3 (plus the priors outside it)
    # against the plain torch.func potential, from the same start and
    # momenta
    wide_vg = fused_mlp.try_build_fused_main_vg(
        wnet.model, wlik, wflat.unravel_theta, wflat.unravel_eta, wx, wy,
        eta_dim=wh)
    assert wide_vg is not None
    assert fused_mlp.try_build_fused_trajectory(
        wnet.model, wlik, wflat.unravel_theta, wflat.unravel_eta, wx, wy,
        wh) is None
    pots = make_potentials(wnet.model, wlik, wx, wy, wflat.unravel_theta,
                           wflat.unravel_eta)
    w_mom = torch.randn((c_w, wd), generator=gen, device=dev)
    trajs = []
    for vg_fn in (lambda q: wide_vg(q, w_etas, wx, wy),
                  lambda q: pots.main_vg(q, w_etas)):
        start = vg_fn(w_thetas)
        q, v, lp1, _ = leapfrog_batched(vg_fn, w_thetas, w_mom, 1e-5, 20,
                                        start=start)
        trajs.append((q, v, start[0], lp1))
    torch.cuda.synchronize()
    k3_err = max(k3_err, compare(
        "K3 wide_deep trajectory (eps, L)=(1e-05, 20) vs torch.func",
        trajs[0], trajs[1], K1_TOL))
    del trajs, pots

    phase("6 the sampler through Network.train")
    # (a) three epochs through the kernels against the same three epochs
    # on the plain path: the same seed gives both the same draws
    short = {}
    for use_fused in (True, False):
        n3, lik3 = flagship_network(dev, seed=7)
        n3.setup_mcmc(burnin=0, leapfrog_start=13, leapfrog_min=13,
                      leapfrog_max=13, step_size_start=2e-3,
                      hyper_leapfrog=30, averaging_steps=10)
        short[use_fused] = n3.train(3, 1, lik3, n_chains=8, chain_jitter=0.1,
                                    use_fused=use_fused, verbose=False)
    assert short[True].fused_main and short[True].fused_hyper
    assert not short[False].fused_main and not short[False].fused_hyper
    np.testing.assert_allclose(short[True].theta_samples,
                               short[False].theta_samples,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(short[True].eta_samples,
                               short[False].eta_samples,
                               rtol=1e-3, atol=1e-4)
    print("3 epochs: kernels agree with the plain path (rtol 1e-3, "
          "atol 1e-4)")
    # the same for a tempered fleet (8 chains x 4 rungs at beta_min 0.5):
    # tempered K1 + K2 against the plain tempered blocks, swaps included
    short_t = {}
    for use_fused in (True, False):
        n3, lik3 = flagship_network(dev, seed=7)
        n3.setup_mcmc(burnin=0, leapfrog_start=13, leapfrog_min=13,
                      leapfrog_max=13, step_size_start=2e-3,
                      hyper_leapfrog=30, averaging_steps=10)
        short_t[use_fused] = n3.train(
            3, 1, lik3, n_chains=8, chain_jitter=0.1, use_fused=use_fused,
            tempering=4, tempering_beta_min=0.5, verbose=False)
    assert short_t[True].main_path == "K1" and short_t[True].fused_hyper
    assert short_t[False].main_path == "plain"
    np.testing.assert_allclose(short_t[True].theta_samples,
                               short_t[False].theta_samples,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(short_t[True].eta_samples,
                               short_t[False].eta_samples,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(short_t[True].swap_accept_rung,
                                  short_t[False].swap_accept_rung)
    print(f"3 tempered epochs: kernels agree with the plain path (rtol "
          f"1e-3, atol 1e-4), swap rates per rung "
          f"{short_t[True].swap_accept_rung.tolist()} on both")

    counted = {"K1": fused_mlp.fused_trajectory,
               "K2": fused_hyper.fused_hyper_trajectory,
               "K3": fused_mlp.fused_potential}

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.LAUNCHES = 0

    def read_counts(path):
        torch.cuda.synchronize()
        got = {name: fn.LAUNCHES for name, fn in counted.items()}
        print(f"launches during the {path} path: {got}")
        return got

    # (b) the flagship on K1 + K2: 64 chains at the verify recipe, and the
    # 512-chain, G = 4 quality block at ess_run's settings; launches
    # counted from here
    reset_counts()
    runs = {}
    for n_chains, n_adapters, epochs, step, mcmc, seed, jitter in (
            (64, 1, 800, 10, RECIPE, 0, 0.0),
            (512, 4, ESS_EPOCHS, 2, ESS_RUN, 11, 0.05)):
        net5, lik5 = flagship_network(dev, seed=seed)
        net5.setup_mcmc(**mcmc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = net5.train(epochs, step, lik5, n_chains=n_chains,
                         n_adapters=n_adapters, chain_jitter=jitter,
                         verbose=False)
        torch.cuda.synchronize()
        runs[n_chains] = (net5, res, time.perf_counter() - t0,
                          mcmc["burnin"])
    launches = read_counts("flagship (K1 + K2)")
    if min(launches["K1"], launches["K2"]) < 1 or launches["K3"]:
        raise AssertionError(f"the flagship path did not run on K1 + K2 "
                             f"alone: {launches}")
    for n_chains, (net5, res, _, burnin) in runs.items():
        main_acc = float(res.main_accept[burnin:].mean())
        hyper_acc = float(res.hyper_accept[burnin:].mean())
        steps = float(res.leapfrog.sum()) * n_chains
        print(f"{n_chains} chains: {res.n_epochs} epochs in "
              f"{res.wall_time:.2f} s, {steps / res.wall_time:,.0f} main "
              f"leapfrog steps/sec; post-burn-in main acceptance "
              f"{main_acc:.4f}, hyper acceptance {hyper_acc:.4f}")
        assert res.main_path == "K1" and res.fused_hyper
        assert res.theta_samples.shape[1:] == (n_chains, d)
        assert np.isfinite(res.theta_samples).all()
        assert np.isfinite(res.eta_samples).all()
        assert 0.0 < main_acc < 1.0, main_acc
        assert abs(hyper_acc - 0.95) < 0.15, hyper_acc
    net512, res512, wall512, _ = runs[512]
    quality("512 chains, G = 4", net512, res512, wall512, ESS_RUN["burnin"])
    del net512, res512

    # (c) the tempered quality block: 512 cold chains x 4 rungs at beta_min
    # 0.5 (2,048 replicas, one adapter per rung) on tempered K1 + K2
    tnet, tlik = flagship_network(dev, seed=11)
    tnet.setup_mcmc(**ESS_RUN)
    reset_counts()
    t0 = time.perf_counter()
    tres = tnet.train(ESS_EPOCHS, 2, tlik, n_chains=512, tempering=4,
                      tempering_beta_min=0.5, chain_jitter=0.05,
                      verbose=False)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    tempered_launches = read_counts("tempered quality block (K1 tempered "
                                    "+ K2)")
    if (tempered_launches["K1"] != ESS_EPOCHS or tempered_launches["K3"]
            or tempered_launches["K2"] < 1):
        raise AssertionError(f"the tempered block did not run on tempered "
                             f"K1 (one launch per epoch) + K2 alone: "
                             f"{tempered_launches}")
    assert tres.main_path == "K1" and tres.fused_hyper, tres.main_path
    n_samples = (ESS_EPOCHS - ESS_RUN["burnin"]) // 2
    assert tres.theta_samples.shape == (n_samples, 512, d), \
        tres.theta_samples.shape
    assert np.isfinite(tres.theta_samples).all()
    assert np.isfinite(tres.eta_samples).all()
    tq = quality("tempered K = 4 at beta_min 0.5, 512 cold chains", tnet,
                 tres, twall, ESS_RUN["burnin"])
    swap_err = np.abs(np.asarray(tq["swap_accept_rung"])
                      - np.asarray(SWAP_RUNG_REF))
    if (swap_err > SWAP_RUNG_TOL).any():
        raise AssertionError(f"swap rates per rung {tq['swap_accept_rung']} "
                             f"are not within {SWAP_RUNG_TOL} of the JAX "
                             f"package's {SWAP_RUNG_REF}")
    assert abs(tq["hyper_accept"] - 0.95) < 0.15, tq["hyper_accept"]
    assert 0.0 < tq["main_accept"] < 1.0, tq["main_accept"]
    del tnet, tres
    net64, res64, _, _ = runs[64]
    # posterior predictive mean at the training points (reference check
    # of the verify recipe: near the 0.1 noise floor)
    thetas = torch.tensor(res64.theta_pooled, device=dev)
    preds = torch.func.vmap(
        lambda th: net64.model.apply(flat.unravel_theta(th), x))(thetas)
    rmse = float(torch.sqrt(((preds.mean(0)[:, 0] - y) ** 2).mean()))
    print(f"64 chains: posterior predictive RMSE {rmse:.4f} over "
          f"{thetas.shape[0]} networks")
    assert rmse < 0.3, rmse
    del runs, net64, res64, thetas, preds

    # (c) wide_deep on K3 + K2: 64 chains, (eps, L) = (1e-5, 20) held
    # (no adapter change within 6 epochs at averaging_steps 10), hyper
    # step 1e-4 and chain jitter 0.01 as the JAX bench runs it
    wide_mcmc = dict(burnin=3, step_size_start=1e-5, step_size_min=1e-6,
                     step_size_max=1e-4, leapfrog_start=20, leapfrog_min=20,
                     leapfrog_max=20, hyper_leapfrog=5, hyper_step_size=1e-4,
                     averaging_steps=10)
    wnet6, wlik6 = wide_network(dev)
    wnet6.setup_mcmc(**wide_mcmc)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wres = wnet6.train(6, 1, wlik6, n_chains=64, chain_jitter=0.01,
                       verbose=False)
    wide_launches = read_counts("wide_deep (K3 + K2)")
    want_k3 = int(sum(int(l) + 1 for l in wres.leapfrog))
    print(f"wide_deep: {wres.n_epochs} epochs in {wres.wall_time:.2f} s; "
          f"main acceptance {np.round(wres.main_accept, 4).tolist()}; "
          f"hyper acceptance {np.round(wres.hyper_accept, 4).tolist()}; "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    assert wres.main_path == "K3" and wres.fused_hyper, wres.main_path
    assert (wres.leapfrog == 20).all(), wres.leapfrog
    if (wide_launches["K3"] != want_k3 or wide_launches["K1"]
            or wide_launches["K2"] < 1):
        raise AssertionError(f"wide_deep: expected {want_k3} K3 launches "
                             f"(epochs x (L + 1)), none of K1 and some of "
                             f"K2; got {wide_launches}")
    assert wres.theta_samples.shape == (3, 64, wd)
    assert np.isfinite(wres.theta_samples).all()
    assert np.isfinite(wres.eta_samples).all()
    assert ((wres.main_accept >= 0) & (wres.main_accept <= 1)).all()
    # the witness of wide_deep's hyper acceptance: the plain path (no
    # kernel; tests/test_torch_sampler.py holds it against the JAX epoch)
    # from the same seed gives the same per-epoch acceptance and final
    # hyper step, and the JAX package's dual averaging replayed on the host
    # from those acceptances lands on that step
    pnet, plik = wide_network(dev)
    pnet.setup_mcmc(**wide_mcmc)
    pres = pnet.train(6, 1, plik, n_chains=64, chain_jitter=0.01,
                      use_fused=False, verbose=False)
    assert pres.main_path == "plain" and not pres.fused_hyper
    replay = dual_averaging_steps(wres.hyper_accept, 1e-4, 3)
    print(f"wide_deep hyper step after the run: {wres.final_hyper_step:.6e} "
          f"on K3 + K2, {pres.final_hyper_step:.6e} on the plain path "
          f"(hyper acceptance {np.round(pres.hyper_accept, 4).tolist()}); "
          f"the dual-averaging replay gives "
          f"{[f'{s:.6e}' for s in replay]}")
    np.testing.assert_allclose(pres.hyper_accept, wres.hyper_accept,
                               atol=0.05)
    assert math.isclose(pres.final_hyper_step, wres.final_hyper_step,
                        rel_tol=1e-3), (pres.final_hyper_step,
                                        wres.final_hyper_step)
    # the replay holds where each epoch's acceptance is all or nothing
    if (np.minimum(wres.hyper_accept, 1.0 - wres.hyper_accept) < 1e-6).all():
        assert math.isclose(replay[-1], wres.final_hyper_step,
                            rel_tol=1e-4), (replay, wres.final_hyper_step)
    del wres, pres, pnet

    # (d) the learned-sd flagship on K1 (d) + K2 (coupled)
    lnet, llik = flagship_network(dev, learned_sd=True)
    lnet.setup_mcmc(burnin=100, leapfrog_start=50, leapfrog_min=20,
                    leapfrog_max=100, leapfrog_increment=5,
                    averaging_steps=10, random_steps=5, hyper_leapfrog=30)
    reset_counts()
    lres = lnet.train(150, 5, llik, n_chains=64, verbose=False)
    learned_launches = read_counts("learned-sd flagship (K1 + K2)")
    l_acc = float(lres.main_accept[100:].mean())
    print(f"learned-sd flagship: {lres.n_epochs} epochs in "
          f"{lres.wall_time:.2f} s; post-burn-in main acceptance "
          f"{l_acc:.4f}, hyper acceptance "
          f"{float(lres.hyper_accept[100:].mean()):.4f}")
    assert lres.main_path == "K1" and lres.fused_hyper, lres.main_path
    if (learned_launches["K1"] != 150 or learned_launches["K2"] < 1
            or learned_launches["K3"]):
        raise AssertionError(f"the learned-sd flagship did not run on "
                             f"K1 (one launch per epoch) + K2 alone: "
                             f"{learned_launches}")
    assert np.isfinite(lres.theta_samples).all()
    assert np.isfinite(lres.eta_samples).all()
    assert 0.0 < l_acc < 1.0, l_acc
    del lres, lnet

    # (e) the JAX bench's classification and multiclass cells on K1 (d):
    # three epochs against the plain path on the same draws, then the
    # cell's 60 epochs with the launches counted, held to the JAX package's
    # acceptance (CLS_REF) and, for classification, a training accuracy
    cls_quality, cls_launches = {}, {}
    for cell, build in (("classification", classification_network),
                        ("multiclass", multiclass_network)):
        short_c = {}
        for use_fused in (True, False):
            n3, lik3 = build(dev)
            n3.setup_mcmc(**cls_mcmc(cell, burnin=0))
            short_c[use_fused] = n3.train(
                3, 1, lik3, n_chains=CLS_CHAINS, chain_jitter=0.01,
                use_fused=use_fused, verbose=False)
        assert short_c[True].main_path == "K1"
        assert short_c[False].main_path == "plain"
        np.testing.assert_allclose(short_c[True].theta_samples,
                                   short_c[False].theta_samples,
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(short_c[True].eta_samples,
                                   short_c[False].eta_samples,
                                   rtol=1e-3, atol=1e-4)
        print(f"{cell}: 3 epochs through the kernels agree with the plain "
              f"path (rtol 1e-3, atol 1e-4)")

        cnet, clik = build(dev)
        cnet.setup_mcmc(**cls_mcmc(cell))
        reset_counts()
        t0 = time.perf_counter()
        cres = cnet.train(CLS_EPOCHS, 1, clik, n_chains=CLS_CHAINS,
                          chain_jitter=0.01, verbose=False)
        torch.cuda.synchronize()
        cwall = time.perf_counter() - t0
        counts = read_counts(f"{cell} (K1 (d)"
                             + (" + K2)" if cell == "multiclass" else ")"))
        cls_launches[cell] = counts
        want_k2 = CLS_EPOCHS if cell == "multiclass" else 0
        if (counts["K1"] != CLS_EPOCHS or counts["K3"]
                or counts["K2"] != want_k2):
            raise AssertionError(f"{cell}: expected {CLS_EPOCHS} K1 "
                                 f"launches, {want_k2} of K2 and none of "
                                 f"K3; got {counts}")
        assert cres.main_path == "K1"
        assert cres.fused_hyper == (cell == "multiclass")
        assert np.isfinite(cres.theta_samples).all()
        assert np.isfinite(cres.eta_samples).all()
        # the steady main-chain rate: the chunk runner the driver builds,
        # after a warm-up of 2 epochs, over 10
        cfg = CLS_CELLS[cell]
        cparams, chypers = cnet.init_state()
        cflat = flatten_state(cparams, chypers, {})
        crun = chunk_runner(cnet, clik, cflat, cfg["hyper_steps"], 1e-4)
        ccarry = init_multichain_state(cflat.theta, cflat.eta, 1e-4,
                                       CLS_CHAINS, gen, jitter=0.01)
        ccarry, _ = crun(ccarry, cfg["eps"], cfg["steps"], 2, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ccarry, _ = crun(ccarry, cfg["eps"], cfg["steps"], 10, gen)
        torch.cuda.synchronize()
        steady = 10 * cfg["steps"] * CLS_CHAINS / (time.perf_counter() - t0)
        cq = {"cell": cell, "n_chains": CLS_CHAINS, "epochs": CLS_EPOCHS,
              "eps": cfg["eps"], "leapfrog": cfg["steps"],
              "wall_seconds": cwall, "steady_steps_per_sec": steady,
              "main_accept": float(cres.main_accept[CLS_BURNIN:].mean()),
              "hyper_accept": float(cres.hyper_accept[CLS_BURNIN:].mean()),
              "train_accuracy": train_accuracy(cnet, cres),
              "jax_main_accept": CLS_REF[cell]["main_accept"],
              "jax_hyper_accept": CLS_REF[cell]["hyper_accept"],
              "launches": counts}
        print(json.dumps({"cell": cq}), flush=True)
        cls_quality[cell] = cq
        gates = {
            "main acceptance": abs(cq["main_accept"]
                                   - cq["jax_main_accept"])
            <= CLS_ACCEPT_TOL,
            "hyper acceptance": abs(cq["hyper_accept"]
                                    - cq["jax_hyper_accept"])
            <= CLS_HYPER_TOL}
        if cell == "classification":
            gates["training accuracy"] = (cq["train_accuracy"]
                                          > CLS_MIN_ACCURACY)
        missed = [name for name, ok in gates.items() if not ok]
        if missed:
            raise AssertionError(f"{cell}: {missed} off the gates: {cq}")
        del cnet, cres, crun, ccarry, short_c

    # (f) the tutorial-shaped model on K3: 64 chains, (eps, L) = (1e-3, 20),
    # 6 epochs, burn-in 3, the tutorial's 30 hyper steps from 1e-5
    # (examples/digits_classification.py:114-120); its hyper block is plain
    tnet6, tlik6 = tutorial_network(dev)
    tnet6.setup_mcmc(burnin=3, step_size_start=1e-3, step_size_min=1e-3,
                     step_size_max=1e-3, leapfrog_start=20, leapfrog_min=20,
                     leapfrog_max=20, hyper_leapfrog=30,
                     hyper_step_size=1e-5, averaging_steps=10)
    reset_counts()
    tres6 = tnet6.train(6, 1, tlik6, n_chains=64, chain_jitter=0.01,
                        verbose=False)
    tut_launches = read_counts("tutorial-shaped model (K3)")
    print(f"tutorial-shaped: {tres6.n_epochs} epochs in "
          f"{tres6.wall_time:.2f} s; main acceptance "
          f"{np.round(tres6.main_accept, 4).tolist()}; hyper acceptance "
          f"{np.round(tres6.hyper_accept, 4).tolist()}")
    assert tres6.main_path == "K3" and not tres6.fused_hyper
    if (tut_launches["K3"] != 6 * 21 or tut_launches["K1"]
            or tut_launches["K2"]):
        raise AssertionError(f"tutorial-shaped: expected 126 K3 launches "
                             f"(6 epochs x (L + 1)) and none of K1 or K2; "
                             f"got {tut_launches}")
    assert tres6.theta_samples.shape == (3, 64, tflat.theta.numel())
    assert np.isfinite(tres6.theta_samples).all()
    assert np.isfinite(tres6.eta_samples).all()
    del tres6, tnet6

    # (g) the U-turn quality block: ess_run's settings with
    # trajectory="uturn" (one shared length schedule, 512 chains) on K1's
    # U-turn-recording program + K2, under the default probe and then
    # "always", each held to the JAX package's statistics (UTURN_REF)
    uturn_launches = {}
    for probe in ("alternate", "always"):
        unet, ulik = flagship_network(dev, seed=11)
        unet.setup_mcmc(**ESS_RUN)
        reset_counts()
        t0 = time.perf_counter()
        ures = unet.train(ESS_EPOCHS, 2, ulik, n_chains=512,
                          chain_jitter=0.05, trajectory="uturn",
                          uturn_probe=probe, verbose=False)
        torch.cuda.synchronize()
        uwall = time.perf_counter() - t0
        counts = read_counts(f"U-turn quality block, probe {probe} (K1 "
                             f"record_uturn + K2)")
        uturn_launches[probe] = counts
        if counts["K1"] != ESS_EPOCHS or counts["K3"] or counts["K2"] < 1:
            raise AssertionError(f"the U-turn block did not run on K1 (one "
                                 f"launch per epoch) + K2 alone: {counts}")
        assert ures.main_path == "K1" and ures.fused_hyper, ures.main_path
        assert ures.leapfrog.shape == (ESS_EPOCHS,), ures.leapfrog.shape
        assert ures.theta_samples.shape == (n_samples, 512, d), \
            ures.theta_samples.shape
        assert np.isfinite(ures.theta_samples).all()
        assert np.isfinite(ures.eta_samples).all()
        # chain-epochs whose trajectory turned within its L (the rest were
        # censored), in burn-in (what the adapter's reservoir saw) and after:
        # the burn-in work is the ratchet of an all-censored fleet, so the
        # count, not the work, shows that the path's recorded steps reach
        # the adapter
        burnin = ESS_RUN["burnin"]
        uq = quality(f"U-turn, probe {probe}, 512 chains", unet, ures, uwall,
                     burnin, probe=probe,
                     leapfrog_work=float(ures.leapfrog.sum()),
                     burnin_leapfrog_work=float(
                         ures.leapfrog[:burnin].sum()),
                     burnin_turned=int(ures.uturn_turned[:burnin].sum()),
                     sampling_turned=int(ures.uturn_turned[burnin:].sum()))
        ref = UTURN_REF[probe]
        gates = {
            "main acceptance": abs(uq["main_accept"] - ref["main_accept"])
            <= UTURN_ACCEPT_TOL,
            "hyper acceptance": abs(uq["hyper_accept"] - 0.95) < 0.15,
            "final L": uq["final_leapfrog"] == ref["final_leapfrog"],
            "total ESS": abs(uq["total_ess"] / ref["total_ess"] - 1.0)
            <= UTURN_TOTAL_ESS_TOL,
            "min-param ESS": abs(uq["min_param_ess"] / ref["min_param_ess"]
                                 - 1.0) <= UTURN_MIN_ESS_TOL,
            "turned in burn-in": uq["burnin_turned"] > 0}
        missed = [name for name, ok in gates.items() if not ok]
        if missed:
            raise AssertionError(f"U-turn block, probe {probe}: {missed} "
                                 f"off the JAX package's {ref}: {uq}")
        del unet, ures

    # (h) wide_deep in U-turn mode on K3 + K2: hmc_step_batched records the
    # U-turn steps around K3's value and gradient; L is pinned at 20
    uwnet, uwlik = wide_network(dev)
    uwnet.setup_mcmc(**wide_mcmc)
    reset_counts()
    uwres = uwnet.train(6, 1, uwlik, n_chains=64, chain_jitter=0.01,
                        trajectory="uturn", verbose=False)
    uw_launches = read_counts("wide_deep U-turn (K3 + K2)")
    print(f"wide_deep U-turn: {uwres.n_epochs} epochs in "
          f"{uwres.wall_time:.2f} s; leapfrog {uwres.leapfrog.tolist()}; "
          f"step size {uwres.final_step_size:.4e}; main acceptance "
          f"{np.round(uwres.main_accept, 4).tolist()}")
    assert uwres.main_path == "K3" and uwres.fused_hyper, uwres.main_path
    assert (uwres.leapfrog == 20).all(), uwres.leapfrog
    if (uw_launches["K3"] != 6 * 21 or uw_launches["K1"]
            or uw_launches["K2"] < 1):
        raise AssertionError(f"wide_deep U-turn: expected 126 K3 launches "
                             f"(6 epochs x (L + 1)), none of K1 and some of "
                             f"K2; got {uw_launches}")
    assert uwres.theta_samples.shape == (3, 64, wd)
    assert np.isfinite(uwres.theta_samples).all()
    assert np.isfinite(uwres.eta_samples).all()
    del uwres, uwnet

    phase("7 times")
    times = {}
    for label, (prog, args, eps_c, l_c) in k1_shapes.items():
        ms = cuda_ms(lambda: fused_mlp.fused_trajectory(prog, *args, eps_c,
                                                        l_c))
        plain = cuda_ms(lambda: fused_mlp.trajectory_plain(prog, *args,
                                                           eps_c, l_c))
        times[label] = (ms, plain, None)
    for c, (args, eps_c, l_c, betas) in k1t_shapes.items():
        ms = cuda_ms(lambda: fused_mlp.fused_trajectory(t_program, *args,
                                                        eps_c, l_c, betas))
        plain = cuda_ms(lambda: fused_mlp.trajectory_plain(
            t_program, *args, eps_c, l_c, betas))
        times[f"K1 tempered C={c} per-rung (eps, L)"] = (ms, plain, None)
    for label, (prog, args) in k2_shapes.items():
        ms = cuda_ms(lambda: fused_hyper.fused_hyper_trajectory(prog, *args))
        plain = cuda_ms(lambda: fused_hyper.hyper_trajectory_plain(prog,
                                                                   *args))
        times[label] = (ms, plain, None)
    # K3's twin is the cuBLAS path (baddbmm/bmm, float32, TF32 off): its
    # time is both plain_ms and library_ms. The same value and gradient
    # through torch.func (cuBLAS under vmap, autograd's backward) is
    # reported beside it as torch_func_ms
    for label, model, unravel in (
            ("K3 wide_deep C=64 N=128", wnet.model, wflat.unravel_theta),
            ("K3 flagship C=64 N=11", net.model, flat.unravel_theta)):
        vg, ops, thetas, sd_c, xs, ys = k3_shapes[label]
        func_vg = torch_func_potential(model, unravel, xs, ys)
        func_ll, _ = func_vg(thetas, sd_c)
        compare(f"{label} torch.func", (func_ll,),
                (vg(thetas, sd_c, xs, ys)[0],), (K3_TOL[0],), labels=("ll",))
        ms = cuda_ms(lambda: vg(thetas, sd_c, xs, ys))
        plain = cuda_ms(lambda: fused_mlp.potential_plain(ops, thetas, sd_c,
                                                          xs, ys))
        func_ms = cuda_ms(lambda: func_vg(thetas, sd_c))
        times[label] = (ms, plain, func_ms)
    # K1 (d) at each of its phase 3 shapes
    for label, (prog, args, eps_c, l_c) in k1d_shapes.items():
        ms = cuda_ms(lambda: fused_mlp.fused_trajectory(prog, *args, eps_c,
                                                        l_c))
        plain = cuda_ms(lambda: fused_mlp.trajectory_plain(prog, *args,
                                                           eps_c, l_c),
                        reps=3)
        times[label] = (ms, plain, None)
    # K3's Bernoulli tail at the tutorial shape: its twin is the cuBLAS path
    # (plain_ms and library_ms, as for wide_deep)
    tut_label = f"K3 Bernoulli + sqprelu tutorial C=64 N={TUTORIAL_ROWS}"
    for label in (tut_label, "K3 categorical digits 64-20-10 C=64 N=1437"):
        vg, ops, thetas, sd_c, xs, ys = k3_shapes[label]
        klik = vg.args[0].lik
        ms = cuda_ms(lambda: vg(thetas, sd_c, xs, ys))
        plain = cuda_ms(lambda: fused_mlp.potential_plain(
            ops, thetas, sd_c, xs, ys, klik))
        times[label] = (ms, plain, None)
    for label, (ms, plain, func_ms) in times.items():
        print(f"{label}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"({plain / ms:.1f}x)"
              + ("" if func_ms is None else f", torch.func {func_ms:.4f} ms"))
    # K1's U-turn-recording program (e) against the non-recording one (a)
    # on the same inputs, in turns (a, e, e, a): C = 64 at (1e-3, 100), and
    # C = 512 at (5e-4, 200), the U-turn block's L
    uturn_times = {}
    for c, eps, steps in ((64, 1e-3, 100), (512, 5e-4, 200)):
        args = uturn_inputs(u_program, flat, c, x, y, u_gen)
        eps_c, l_c = fused_mlp.per_chain(eps, steps, c, dev)
        got = fused_mlp.fused_trajectory(u_program, *args, eps_c, l_c)
        want = fused_mlp.trajectory_plain(u_program, *args, eps_c, l_c)
        label = f"K1 record_uturn C={c} (eps, L)=({eps}, {steps}), timed"
        k1u_err = max(k1u_err, compare(label, got[:4], want[:4], K1_TOL))
        k1u_counts[label] = check_uturns(label, u_program, args, eps_c, l_c,
                                         got[4], want[4])
        rec = []
        for prog in (program, u_program, u_program, program):
            rec.append(cuda_ms(lambda: fused_mlp.fused_trajectory(
                prog, *args, eps_c, l_c)))
        plain = cuda_ms(lambda: fused_mlp.trajectory_plain(
            u_program, *args, eps_c, l_c), reps=3)
        off_ms = (rec[0] + rec[3]) / 2
        on_ms = (rec[1] + rec[2]) / 2
        # each chain's L + 1 evaluations, plus the projection's 3 FLOP per
        # row and step; outputs q, v, lp0, lp1 and the U-turn step
        evals = float((l_c.to(torch.float64) + 1).sum())
        ub = bound(evals * (product_flops(program.ops, 11) + 10 * d),
                   4 * (4 * c * d + c * h + 11 * 2 + 5 * c))
        uturn_times[c] = dict(ms=on_ms, record_off_ms=off_ms,
                              plain_ms=plain, bound_ms=ub[0],
                              bound_by=ub[1], turns=[float(t) for t in rec])
        print(f"K1 record_uturn C={c} (eps, L)=({eps}, {steps}): kernel "
              f"{on_ms:.4f} ms against {off_ms:.4f} ms without recording "
              f"({100 * (on_ms / off_ms - 1):+.1f}%; a, e, e, a: "
              f"{', '.join(f'{t:.4f}' for t in rec)}), plain {plain:.4f} "
              f"ms, bound {ub[0]:.5f} ms ({ub[1]})")

    # steady main-chain leapfrog rate at 64 chains, (eps, L) = (1e-3, 100),
    # hyper_leapfrog 100 (the bench's shape), kernels on
    run = chunk_runner(net, lik, flat, 100, 1e-3)
    carry = init_multichain_state(flat.theta, flat.eta, 1e-3, 64, gen,
                                  jitter=0.01)
    carry, _ = run(carry, 1e-3, 100, 10, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_epochs = 0
    for _ in range(5):
        carry, trace = run(carry, 1e-3, 100, 20, gen)
        n_epochs += 20
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert torch.isfinite(trace.theta).all()
    print(f"steady rate: {n_epochs * 100 * 64 / dt:,.0f} main leapfrog "
          f"steps/sec (64 chains, L=100, {n_epochs} epochs in {dt:.3f} s, "
          f"{card})")

    # steady wide_deep epochs on K3 + K2: 64 chains, (eps, L) = (1e-5, 20),
    # hyper_leapfrog 5 (the bench's shape)
    wide_run = chunk_runner(wnet, wlik, wflat, 5, 1e-4)
    wcarry = init_multichain_state(wflat.theta, wflat.eta, 1e-4, c_w, gen,
                                   jitter=0.01)
    wcarry, _ = wide_run(wcarry, 1e-5, 20, 1, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wcarry, wtrace = wide_run(wcarry, 1e-5, 20, 5, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert torch.isfinite(wtrace.theta).all()
    print(f"wide_deep steady: {1e3 * dt / 5:.3f} ms per epoch, "
          f"{5 * 20 * c_w / dt:,.0f} main leapfrog steps/sec (64 chains, "
          f"L=20, 5 epochs in {dt:.3f} s, {card})")

    k1_ms, k1_plain, _ = times["K1 C=64 (eps, L)=(0.001, 100)"]
    k2_ms, k2_plain, _ = times["K2 C=64 n_steps=100"]
    k3_ms, k3_plain, k3_func = times["K3 wide_deep C=64 N=128"]
    hyper_program = k2_shapes["K2 C=64 n_steps=100"][0]
    # bounds from this run's shapes: K1 at C = 64, L = 100 (products,
    # priors and leapfrog updates: 7 FLOP per row and evaluation); K2 at
    # C = 64, 100 steps (~60 FLOP per prior block and 4 per hyper per step);
    # K3 at wide_deep
    k1_bound = bound(64 * 101 * (product_flops(program.ops, 11) + 7 * d),
                     4 * (4 * 64 * d + 64 * h + 11 * 2 + 4 * 64))
    n_blocks = len(hyper_program.blocks)
    k2_bound = bound(64 * 101 * (60 * n_blocks + 4 * h),
                     4 * (4 * 64 * h + 64 * hyper_program.n_stats + 3 * 64))
    k3_bound = bound(c_w * product_flops(wide_ops, 128),
                     4 * (2 * c_w * wd + 2 * c_w + 128 * (256 + 1)))
    # tempered K1 at C = 2,048 with per-rung L: each chain's own L + 1
    # evaluations (the beta products add 2 FLOP per row and evaluation);
    # inputs theta, mom, eta, x, y, eps, L, beta, outputs q, v, lp0, lp1
    k1t_ms, k1t_plain, _ = times["K1 tempered C=2048 per-rung (eps, L)"]
    t_evals = float((k1t_shapes[2048][2].to(torch.float64) + 1).sum())
    k1t_bound = bound(t_evals * (product_flops(program.ops, 11) + 7 * d),
                      4 * (4 * 2048 * d + 2048 * h + 11 * 2 + 5 * 2048))
    # K1 (d) at the classification cell's shape, C = 128, (5e-4, 50): the
    # dense products plus ~10 FLOP per theta row and evaluation (priors,
    # slopes, leapfrog); inputs theta, mom, eta, x, y, eps, L, outputs q, v,
    # lp0, lp1
    k1d_label = "K1 (d) classification C=128 (eps, L)=(0.0005, 50)"
    k1d_ms, k1d_plain, _ = times[k1d_label]
    k1d_prog = k1d_shapes[k1d_label][0]
    cd_ = k1d_prog.dims[2]
    k1d_bound = bound(CLS_CHAINS * 51 * (product_flops(k1d_prog.ops, 64)
                                         + 10 * cd_),
                      4 * (4 * CLS_CHAINS * cd_
                           + CLS_CHAINS * k1d_prog.eta_dim + 64 * 11
                           + 4 * CLS_CHAINS))
    # K3 at the tutorial shape: the products (slopes and tails under 1%);
    # theta read and grad written, x and y read once, ll written
    tut_ms, tut_plain, _ = times[tut_label]
    tut_d = tflat.theta.numel()
    tut_bound = bound(64 * product_flops(tut_ops, TUTORIAL_ROWS),
                      4 * (2 * 64 * tut_d + TUTORIAL_ROWS * 785 + 2 * 64))
    kernels = [
        {"name": "K1 fused_trajectory", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_trajectory.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:425",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "K2 fused_hyper", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_hyper.cu",
         "replaces": "tensorbnn_tpu/ops/fused_hyper.py:108",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "K3 fused_potential", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_potential.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:157",
         "launches": wide_launches["K3"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": k3_plain,
         "torch_func_ms": k3_func},
        {"name": "K1 fused_trajectory (tempered)", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_trajectory.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:451",
         "launches": tempered_launches["K1"], "max_abs_err": k1t_err,
         "ms": k1t_ms, "plain_ms": k1t_plain, "bound_ms": k1t_bound[0],
         "bound_by": k1t_bound[1], "library_ms": None},
        # ms at C = 512, L = 200; launches in the "alternate" U-turn block
        {"name": "K1 fused_trajectory (record_uturn)", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_trajectory.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:449",
         "launches": uturn_launches["alternate"]["K1"],
         "max_abs_err": k1u_err, **{k: uturn_times[512][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "record_off_ms": uturn_times[512]["record_off_ms"],
         "c64_l100": uturn_times[64],
         "uturn_counts": {k: list(v) for k, v in k1u_counts.items()}},
        # ms at the classification cell's shape; launches in the
        # classification and multiclass cells' 60 epochs each
        {"name": "K1 fused_trajectory (d)", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_trajectory.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:425",
         "launches": sum(c["K1"] for c in cls_launches.values()),
         "max_abs_err": k1d_err, "ms": k1d_ms, "plain_ms": k1d_plain,
         "bound_ms": k1d_bound[0], "bound_by": k1d_bound[1],
         "library_ms": None,
         "shapes_ms": {k: v[0] for k, v in times.items()
                       if k.startswith("K1 (d)")}},
        # ms at the tutorial shape, launches in its 6-epoch run
        {"name": "K3 fused_potential (Bernoulli tail)", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_potential.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:239",
         "launches": tut_launches["K3"], "max_abs_err": k3t_err,
         "ms": tut_ms, "plain_ms": tut_plain, "bound_ms": tut_bound[0],
         "bound_by": tut_bound[1], "library_ms": tut_plain,
         "digits_categorical_ms": times[
             "K3 categorical digits 64-20-10 C=64 N=1437"][0]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
