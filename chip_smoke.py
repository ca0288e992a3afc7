"""Drives the torch port's sampler on one NVIDIA card and checks it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (``nvcc``); it imports torch, numpy and
``tensorbnn_tpu_torch`` only. Phases, in order; any failure raises and the
script exits non-zero:

1. card: name and power limit (nvidia-smi); a CUDA device is required;
2. build: compiles the kernels from ``tensorbnn_tpu_torch/csrc`` (one
   ``nvcc`` a source, all started together) and, beside them, the host
   text store's parser (``g++``);
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
   128 chains, the moons example's stack at one chain over its longest
   trajectory (L = 2,000), the learned-sd and Cauchy-compat flagships and
   a Prelu + LeakyRelu stack at 64; every path of K1's layer table (an
   elu, a relu after it, a sigmoid and an exp) at 64 chains, L in {1, 2,
   3, 40};
4. K2 (the fused hyper-block trajectory) against its twin at the hyper
   block of each main path, from the stats of that model's own state: the
   flagship at 64 and 512 chains, 100 steps (uncoupled); the learned-sd
   flagship at 64 chains, 30 steps, and ``wide_deep`` (the 10x256 model of
   benchmarks/run_benchmarks.py) at 64 chains, 5 steps (both coupled); the
   tempered block's shape (the flagship at 2,048 chains, 30 steps) and a
   16-block stack (32 items, the widest table) at 64 chains, 100 steps;
   each line with its items and lanes a chain;
5. K3 (the per-step potential) against its twin at ``wide_deep`` (128
   rows, 64 chains, per-chain learned sd, weights from a Network's init),
   the flagship (64 chains, fixed sd) and a ragged stack; its Bernoulli
   tail and sqprelu at the tutorial shape (784-20-20-1 over 9,585 rows, 64
   chains), its categorical tail at a digits shape (64-20-10 over 1,437
   rows), its prelu and leakyrelu at a ragged stack, and its packed first
   layer and split row sums at a ragged 50-7-3-1 Bernoulli stack over
   3,001 rows (3 chains); two tutorial-shape calls bit-equal; K3 and the
   float32 twin against the twin in float64 at the tutorial's own He-init
   start (K3 within 2x the twin's error); then one ``wide_deep``
   trajectory through K3 against the plain ``torch.func`` potential;
6. the sampler through ``Network.train``: 3-epoch runs through K1 and K2,
   untempered and tempered (4 rungs), against the same runs on the plain
   path (same seed, same draws), then each main path with the kernels'
   launch counts set to 0 just before it and read just after: the flagship
   at 64 chains (one adapter, the verify recipe) and the 512-chain, G = 4
   quality block (the JAX bench's ``ess_run`` settings, 1,300 epochs,
   Network seed 11) on K1 + K2; then, counts read, the same block at
   seeds 12-20, a ``quality`` line a seed, and the ten seeds' band against
   the JAX package's seeds 11-15 (``G4_JAX_SEEDS``) as a ``{"g4_band":
   ...}`` line, failing where total ESS, min-param ESS or main acceptance
   is more than 3 standard errors from the JAX package's mean or the mean
   hyper acceptance leaves 0.925 +- 0.011; the tempered quality block
   (512 chains x 4 rungs at beta_min 0.5, ``ess_run``'s settings, one
   adapter a rung) on tempered K1 + K2, with its swap rate per rung, then,
   counts read, at seeds 12-15 and the five seeds' band against the JAX
   package's seeds 11-15 (``TEMPERED_JAX_SEEDS``) as a
   ``{"tempered_band": ...}`` line with each rung's final (eps, L) on
   both sides, failing where total ESS, min-param ESS or main acceptance
   is more than 3 standard errors from the JAX package's mean or a seed's
   swap rate on a rung is more than 0.06 from the JAX seeds' mean there;
   ``wide_deep`` on K3 + K2 (6 epochs, (eps,
   L) = (1e-5, 20)), then on the plain path as a witness of its hyper
   acceptance; the learned-sd flagship on K1 (d) + K2; the JAX bench's
   ``classification`` (K1 (d), plain hyper block) and ``multiclass``
   (K1 (d) + K2) cells, 128 chains over 60 epochs after 3 epochs against
   the plain path, held to
   the JAX package's acceptance and (classification) a training accuracy
   above 0.9, each printed as a ``{"cell": ...}`` line with its steady
   steps/sec; then the moons stack's same-state acceptance ladder (the
   moons example's 2-16-16-1 SquarePrelu + Bernoulli stack at 16 chains
   from the JAX package's warm start and from a committed equilibrium
   state, three fixed (eps, L) a state, 10 epochs each on K1 (d) and the
   plain hyper block through the graph runner), failing where the mean
   main accept probability is more than 3 standard errors from the JAX
   package's on the same state and rung (``MOONS_LADDER_JAX``), a mean
   hyper acceptance more than 0.05 from it, or K1 did not run each epoch
   alone, as a ``{"moons_ladder": ...}`` line (``--moons-only`` runs
   phases 1, 2 and the ladder alone); the tutorial-shaped model on K3 (6
   epochs); the U-turn
   quality block
   (``trajectory="uturn"``, 512 chains at ``ess_run``'s settings) under
   the "alternate" and then the "always" probe on K1's U-turn-recording
   program + K2, each at seed 11 held to the JAX package's one-seed
   statistics, and "always" then at seeds 12-15 and the five seeds' band
   against the JAX package's seeds 11-15 (``UTURN_JAX_SEEDS``) as a
   ``{"uturn_band": ...}`` line, failing where total ESS, min-param ESS or
   main acceptance is more than 3 standard errors from the JAX package's
   mean or a seed's final L leaves the JAX seeds' range (``--quality-only``
   runs phases 1, 2 and the three bands alone); ``wide_deep`` in U-turn
   mode on K3 + K2. The quality blocks report ESS (the predictive mean at
   x = 0.5 and the worst parameter) per second;
7. the sample store, resume and the Predictor on the card: the flagship
   at 64 chains on K1 + K2 with ``folder_name``, buffered and streamed
   (each store loads to the run's samples bit for bit); ``Predictor(
   device="cuda")`` over the text and npz stores (``predict`` bit-equal to
   ``model.apply`` over the run's samples); a run stopped at a checkpoint
   and resumed (bit-equal to the uninterrupted run in samples, acceptance
   and store bytes); ``reweight`` to Cauchy priors and the per-chain
   ``autocorrelation_length``; the JAX bench's predict cell (2,000
   networks x 4,096 points) on the eager route and on the graph route
   (each call after a key's first a replay of its captured forward):
   bit-equal, each route's host ms a call and its forward's device ms
   against the bound, the graph's captures (none in the timed calls),
   capture ms with and without ``torch.cuda.graph``'s preamble and pool
   bytes, eager ``train_probs`` and ``reweight`` calls of its ensemble, as
   a ``{"store": ...}`` line (``--predict-only`` runs phases 1, 2, 7 (e)
   and 11 (e) alone);
8. times: each kernel against its twin (CUDA events), K3 against the
   same value and gradient through cuBLAS (the twin) and torch.func, K1's
   U-turn-recording program against the non-recording one on the same
   inputs, K1 (d) at its phase 3 shapes (each K1 shape also in us per
   evaluation along its longest trajectory, with its barriers a step from
   its layer table and its device time with the host's time taken out),
   K2 at its phase 4 shapes (each also in device time), K3 at the
   tutorial and digits
   shapes, the steady 64-chain leapfrog rates of the flagship at (eps, L)
   = (1e-3, 100) and of ``wide_deep`` at (1e-5, 20);
9. MAP pretraining, the tensorBNN shim and the examples on the card, from
   generators of their own: pretraining at the JAX bench's surrogate shape
   (1M x 8 points, 2 x 64 tanh, batch 8,192, 4 epochs) and at the
   tutorial's first cycle (784-20-20-1 with trained slopes over the
   tutorial-shaped rows, batch 32, 10 epochs), each through the eager
   epochs and the graph of a step (``eager=True`` and the default),
   bit-equal (weights, biases, slopes, every epoch's validation loss),
   each runner with its call's seconds, its capture's seconds, a steady
   epoch's seconds, device ms, host launches and idle share; the
   configured calls through ``train_basic_regression`` (the
   surrogate's 4 epochs) and ``train_basic_classification`` (the
   tutorial's 3 cycles x 10 epochs), one capture each, the tutorial's
   first cycle held against the same call on the CPU;
   ``extended_regression --smoke`` (K1 + K2) and ``classification
   --smoke`` (K1) through their ``main``, held to the JAX examples'
   figures; the tutorial-shaped BNN warm-started from its pretraining, on
   K3; the reference-style shim script and its ``predictor``, as a
   ``{"pretrain": ...}`` line;
10. the 1M-point surrogate (the JAX bench's ``surrogate_quality_exact``,
   32 chains, ``data_chunk=125,000``, ``numerics="exact"``, 12 epochs, from
   phase 9's MAP warm start) through ``Network.train`` on the plain path,
   with no kernel launched: its epochs' wall, the main block's ms an
   evaluation, an epoch's busy time and idle share, peak memory and
   acceptance; the chunked potential against the unchunked one and
   float64 at 4 chains; the ``potential_noise`` walk at the MAP under
   precision None, "high" (TF32) and "highest"; ``surrogate_regression
   --smoke`` held to the JAX example's figures; the same model under
   default numerics (K3 over 125,000-row chunks + K2, stepped), K3 over
   row chunks and unchunked held against the plain path and each other,
   with their ms, calls and workspace, and K3's cuBLAS twin timed over the
   same row chunks; the same at 128 chains (a fleet
   whose unchunked K3 workspace, 131.6 GB, no card holds: the driver's
   gate declines it without ``data_chunk``), 4 epochs; then (g) the
   same-state acceptance ladder: from the JAX package's committed warm
   start and from a committed state at equilibrium, 8 chains at (eps, L)
   = (3.2e-5, 15) and (4.87e-5, 15) for 10 epochs on the stepped runner,
   failing where the mean main accept probability is more than 3 standard
   errors from the JAX package's on the same state and rung
   (``LADDER_JAX``) or the learned sd more than 10% from it (the chunk
   runner alone; the equilibrium state's (4.87e-5, 15) rung, 0 against 0,
   shows agreement only); as a
   ``{"surrogate": ...}`` line (``--surrogate-only`` runs phases 1, 2 and
   10 alone);
11. the ``(chains, data)`` mesh on a virtual mesh whose entries are all
   this card: the flagship at 64 chains on 4x1 (K1 and K2 on each chain
   shard, on the graph runner as in phase 13) against the mesh-less run,
   then 200 epochs of each (walls and launches an epoch); ``wide_deep``
   on 2x2 (K3 and the coupled K2) against the mesh-less run, with the
   stats' R and K summed over the data peers (and the flagship's 11 rows
   refused there); the 1M-point
   surrogate on 1x4: K3 on four 250,000-row shards against the mesh-less
   K3 and the plain path, and 4 epochs under ``numerics="exact"``; a
   tempered ``multiclass`` block on 1x2 (the plain main block) against the
   mesh-less swap decisions; the predict cell on 2x2 against the unsharded
   ``predict``, on the eager route and on graphs (a graph an entry),
   bit-equal, as phase 7 (e) holds it; as a ``{"mesh": ...}`` line
   (``--mesh-only`` runs phases
   1, 2 and 11 alone). The runs over data axes above 1 take the stepped
   runner, each part split at the data peers' sums, as phase 13 holds;
12. the graph chunk runner (parallel/graphs.py), which phases 6-11 take
   wherever K1 runs the main block on this card, against the eager
   runner in each K1 cell of phase 6 (the flagship at 64 chains, the G = 4
   block at 512, the tempered block at 512 x 4, the U-turn block at 512
   with per-epoch counts, ``classification`` and ``multiclass`` at 128):
   two chunks whose (eps, L) differ, bit-equal (carry, traces, the
   generator's state), then each runner's host ms an epoch over 100 steady
   epochs (``classification``, whose eager epoch is slow, over 5), the
   card's busy ms, the idle share, the host's launches an
   epoch, each runner's peak memory and the graph runner's captures with
   their ms; and the stepped runner (a head, a step and a tail graph of
   the epoch, the step replayed L times), which phases 6-11 take wherever
   K3 or the plain path runs the main block on this card, against the
   eager runner in the same way: ``wide_deep`` at 64 chains (K3, K2) with
   a shared count and per-chain counts in four groups, the tutorial-shaped
   classifier at 64 (K3, the plain hyper block at 30 steps), the 1M-point
   surrogate at 32 under exact numerics (the plain path, Kahan,
   ``data_chunk``, a diagonal metric) and under default numerics (K3
   over 1M rows, its peak memory within 1.1x the eager runner's), each
   with three captures, ``wide_deep`` within L + 10 host launches an
   epoch; as a ``{"graph": ...}`` line (``--graph-only`` runs phases 1, 2
   and 12 alone);
13. the graph runners over chains-only meshes of this card (a graph a
   chain shard, the stepped runner's three; parallel/graphs.py), which
   phase 11 (a) takes, against the eager mesh runner: the flagship at 64
   chains and the G = 4 block at 512 (one adapter group a shard) on 4x1,
   the U-turn block at 512, ``multiclass`` at 128 and ``wide_deep`` at 64
   (stepped) on 2x1, as phase 12 holds and times its cells (bit-equal
   over two chunks, generator state included; host ms, busy ms, idle
   share and host launches an epoch; captures, one a shard or three);
   then the stepped runner over data meshes of this card, each part split
   at its sums over the data peers (a home segment and a graph a peer a
   sum, the copies between them from the host), against the eager mesh
   runner in the same way: ``wide_deep`` at 64 chains on 2x2, a tempered
   ``multiclass`` at 64 x 4 rungs on 1x2 (the plain main block, K2), the
   1M-point surrogate at 32 chains on 1x4 under exact and default
   numerics (four epochs a runner; the default's peak memory within 1.1x
   the eager runner's), each within its derived host launches an epoch
   (``MESH_DATA_CELLS``), as a ``{"mesh_graph": ...}`` line
   (``--mesh-graph-only`` runs phases 1, 2 and 13 alone).

It prints the kernels' JSON line and the card's line before its last line,
``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import tempfile
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
QUALITY_CHAINS = 512
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
# the JAX package's seed distribution of the 512-chain, G = 4 quality block
# (ess_run(n_chains=512, n_adapters=4, epochs=1300) at Network seeds 11-15,
# the XLA path on the CPU), one entry a seed, as printed by
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py quality
# (the n_chains, epochs and cpu_seconds keys left out): statistics of the
# sampler, not of any chip. Phase 6 (b) runs the port at G4_SEEDS and fails
# where a G4_GATED statistic's mean is more than G4_BAND_Z standard errors
# from these seeds' (sqrt(sd_p^2 / n_p + sd_j^2 / n_j)), or where the
# port's mean hyper acceptance leaves HYPER_ACCEPT_REF (0.925 +- 0.011 over
# 10 seeds, benchmarks/PARITY_r04.json)
G4_JAX_SEEDS = (
    dict(seed=11, total_ess=127017.8, min_param_ess=14047.6,
         median_param_ess=20122.1, main_accept=0.6357,
         hyper_accept=0.929, final_step_size=0.003875,
         final_leapfrog=189,
         group_step_size=[0.0045, 0.0035, 0.0035, 0.004],
         group_leapfrog=[200, 185, 200, 170]),
    dict(seed=12, total_ess=136817.5, min_param_ess=14091.2,
         median_param_ess=20345.8, main_accept=0.6503,
         hyper_accept=0.9264, final_step_size=0.003625,
         final_leapfrog=191,
         group_step_size=[0.0035, 0.0035, 0.0035, 0.004],
         group_leapfrog=[185, 185, 200, 195]),
    dict(seed=13, total_ess=111508.0, min_param_ess=12609.6,
         median_param_ess=17424.2, main_accept=0.5837,
         hyper_accept=0.9263, final_step_size=0.003875,
         final_leapfrog=198,
         group_step_size=[0.004, 0.004, 0.0035, 0.004],
         group_leapfrog=[200, 190, 200, 200]),
    dict(seed=14, total_ess=140207.7, min_param_ess=14851.9,
         median_param_ess=21391.7, main_accept=0.6491,
         hyper_accept=0.9263, final_step_size=0.00375,
         final_leapfrog=200,
         group_step_size=[0.0045, 0.0035, 0.0035, 0.0035],
         group_leapfrog=[200, 200, 200, 200]),
    dict(seed=15, total_ess=105516.6, min_param_ess=12122.4,
         median_param_ess=17016.6, main_accept=0.5677,
         hyper_accept=0.9254, final_step_size=0.004625,
         final_leapfrog=196,
         group_step_size=[0.0065, 0.004, 0.0035, 0.0045],
         group_leapfrog=[200, 190, 200, 195]))
G4_SEEDS = tuple(range(11, 21))
G4_BAND = ("total_ess", "min_param_ess", "median_param_ess", "main_accept",
           "hyper_accept")
G4_GATED = ("total_ess", "min_param_ess", "main_accept")
G4_BAND_Z = 3.0
HYPER_ACCEPT_REF = (0.925, 0.011)
# the JAX package's seed distributions of the tempered block (K = 4 at
# beta_min 0.5, 512 cold chains, one adapter a rung) and the U-turn block
# under the "always" probe (512 chains), at Network seeds 11-15 on the XLA
# path on the CPU, one entry a seed, as printed by
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py quality --block tempered
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py quality --block uturn \
#       --probe always
# (the block, n_chains, epochs and cpu_seconds keys left out, the tempered
# step sizes to 12 significant digits): statistics of the sampler, not of
# any chip. Phase 6 (c) and (g) run the port at TEMPERED_SEEDS and
# UTURN_SEEDS and fail where a G4_GATED statistic's mean is more than
# G4_BAND_Z standard errors from these seeds'; the tempered band also where
# a seed's swap rate on a rung is more than SWAP_RUNG_TOL from these seeds'
# mean on that rung, the U-turn band where a seed's final L leaves these
# seeds' range
TEMPERED_JAX_SEEDS = (
    dict(seed=11, total_ess=205138.2, min_param_ess=43053.2,
         median_param_ess=55852.3, main_accept=0.751, hyper_accept=0.9291,
         final_step_size=0.0045, final_leapfrog=161,
         group_step_size=[0.0035, 0.0045, 0.0055, 0.0045],
         group_leapfrog=[200, 180, 75, 190],
         swap_accept_rung=[0.3422, 0.6877, 0.684, 0.3385]),
    dict(seed=12, total_ess=182666.8, min_param_ess=39637.6,
         median_param_ess=48807.2, main_accept=0.6193, hyper_accept=0.9305,
         final_step_size=0.002875, final_leapfrog=138,
         group_step_size=[0.004, 0.0005, 0.0005, 0.0065],
         group_leapfrog=[200, 180, 40, 130],
         swap_accept_rung=[0.3427, 0.6876, 0.6873, 0.3424]),
    dict(seed=13, total_ess=191145.0, min_param_ess=43177.2,
         median_param_ess=55019.7, main_accept=0.6218, hyper_accept=0.9291,
         final_step_size=0.00375, final_leapfrog=176,
         group_step_size=[0.004, 0.0045, 0.0015, 0.005],
         group_leapfrog=[195, 180, 130, 200],
         swap_accept_rung=[0.3423, 0.688, 0.6873, 0.3416]),
    dict(seed=14, total_ess=172928.1, min_param_ess=48687.8,
         median_param_ess=63719.6, main_accept=0.4765, hyper_accept=0.9297,
         final_step_size=0.004375, final_leapfrog=196,
         group_step_size=[0.0045, 0.0045, 0.0035, 0.005],
         group_leapfrog=[200, 185, 200, 200],
         swap_accept_rung=[0.3428, 0.6875, 0.687, 0.3423]),
    dict(seed=15, total_ess=135570.7, min_param_ess=36868.4,
         median_param_ess=46664.9, main_accept=0.3708, hyper_accept=0.93,
         final_step_size=0.003375, final_leapfrog=152,
         group_step_size=[0.0035, 0.0045, 0.0005, 0.005],
         group_leapfrog=[190, 200, 20, 200],
         swap_accept_rung=[0.3431, 0.6884, 0.6894, 0.344]))
UTURN_JAX_SEEDS = (
    dict(seed=11, total_ess=189248.9, min_param_ess=15214.5,
         median_param_ess=22034.9, main_accept=0.7935, hyper_accept=0.928,
         final_step_size=0.003345931893622231, final_leapfrog=200),
    dict(seed=12, total_ess=186674.9, min_param_ess=14647.1,
         median_param_ess=22142.3, main_accept=0.7913, hyper_accept=0.9289,
         final_step_size=0.003349720705330565, final_leapfrog=200),
    dict(seed=13, total_ess=187925.1, min_param_ess=15273.8,
         median_param_ess=22144.2, main_accept=0.8058, hyper_accept=0.9285,
         final_step_size=0.0033139196395274217, final_leapfrog=200),
    dict(seed=14, total_ess=187828.8, min_param_ess=15397.4,
         median_param_ess=22266.1, main_accept=0.7934, hyper_accept=0.929,
         final_step_size=0.003358840845612399, final_leapfrog=200),
    dict(seed=15, total_ess=186955.3, min_param_ess=14978.9,
         median_param_ess=22179.7, main_accept=0.7892, hyper_accept=0.9292,
         final_step_size=0.0033678493925288814, final_leapfrog=200))
TEMPERED_SEEDS = UTURN_SEEDS = tuple(range(11, 16))
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
# the moons example's full configuration (examples/classification.py:
# 53-96, the reference's ClassificationExample): 2-16-16-1 with
# SquarePrelu at alpha 0.55 and a sigmoid head under the Bernoulli
# likelihood over two_moons(200, seed=0), validated on two_moons(100,
# seed=1), one chain, every 10th epoch recorded
MOONS_WIDTH = 16
MOONS_MCMC = dict(step_size_start=5e-4, step_size_min=1e-5,
                  step_size_max=5e-3, step_size_options=100,
                  leapfrog_start=500, leapfrog_min=50, leapfrog_max=2000,
                  leapfrog_increment=10, hyper_step_size=0.001,
                  hyper_leapfrog=100, burnin=1000, averaging_steps=10)
MOONS_EPOCHS, MOONS_STEP, MOONS_PER_FILE = 4000, 10, 50
# K1 (d) at the full run's shape in phases 3 and 8: one chain at the
# example's first step size and its longest trajectory
MOONS_K1_LABEL = "K1 (d) moons C=1 (eps, L)=(0.0005, 2000)"
# the Network seeds of the full runs on both sides (the example's is 42)
MOONS_SEEDS = tuple(range(11, 21))
# the statistics of the full runs compared over seeds (`chip_profile.py
# classification --band`), each gated at z <= G4_BAND_Z
MOONS_BAND = ("val_accuracy", "main_accept", "total_ess", "min_param_ess")
# the JAX package's full moons runs from MOONS_WARM_START at MOONS_SEEDS on
# its XLA path on the CPU, one entry a seed, as printed by
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py classification
# (the n_chains, epochs and cpu_seconds keys left out): statistics of the
# sampler, not of any chip
MOONS_JAX_SEEDS = (
    dict(seed=11, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.39821362495422363, hyper_accept=0.9541516900062561,
         final_step_size=0.0009172727272727274, final_leapfrog=2000,
         total_ess=287.97731140028054, min_param_ess=9.511118860549928,
         median_param_ess=26.27570935394781),
    dict(seed=12, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.4009252190589905, hyper_accept=0.9120457172393799,
         final_step_size=0.003941515151515152, final_leapfrog=2000,
         total_ess=162.7519133086936, min_param_ess=8.73937201502521,
         median_param_ess=22.368927593730184),
    dict(seed=13, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.37790194153785706, hyper_accept=0.4389374256134033,
         final_step_size=0.0010684848484848488, final_leapfrog=2000,
         total_ess=300.0, min_param_ess=7.41980764474837,
         median_param_ess=10.574840190592628),
    dict(seed=14, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.3325577676296234, hyper_accept=0.9411110877990723,
         final_step_size=1e-05, final_leapfrog=1620, total_ess=300.0,
         min_param_ess=8.865211030084282, median_param_ess=29.241574757015073),
    dict(seed=15, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.0946865975856781, hyper_accept=0.9435282945632935,
         final_step_size=0.0009676767676767679, final_leapfrog=2000,
         total_ess=300.0, min_param_ess=8.786098550548942,
         median_param_ess=21.543564937629625),
    dict(seed=16, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.06668706983327866, hyper_accept=0.960991382598877,
         final_step_size=0.0025302020202020207, final_leapfrog=1030,
         total_ess=300.0, min_param_ess=9.928640731667944,
         median_param_ess=18.752818434964766),
    dict(seed=17, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.06761437654495239, hyper_accept=0.9418336749076843,
         final_step_size=0.0025302020202020207, final_leapfrog=1030,
         total_ess=300.0, min_param_ess=8.888186345472308,
         median_param_ess=25.2290712967106),
    dict(seed=18, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.2422250509262085, hyper_accept=0.9285777807235718,
         final_step_size=1e-05, final_leapfrog=50, total_ess=300.0,
         min_param_ess=10.969621003539979, median_param_ess=26.05197622592587),
    dict(seed=19, samples=300, networks=300, val_accuracy=0.99,
         main_accept=0.04214572161436081, hyper_accept=0.938606858253479,
         final_step_size=0.0024797979797979803, final_leapfrog=1020,
         total_ess=300.0, min_param_ess=8.449905826817227,
         median_param_ess=28.199843774979612),
    dict(seed=20, samples=300, networks=300, val_accuracy=0.98,
         main_accept=0.3249059319496155, hyper_accept=0.91438889503479,
         final_step_size=0.005, final_leapfrog=50, total_ess=300.0,
         min_param_ess=7.737109916031604, median_param_ess=11.135204535970392),
)
# the JAX package's warm start of the moons stack at the example's full
# pretraining (train_basic_classification, 2 cycles x 80 epochs, alpha 0.1,
# train_slopes=True), trained on the CPU by
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py classification \
#       --warm-start
# and kept as the Network's flat theta (each dense layer's b, then its
# (in, out) W; each SquarePrelu's slopes as squareprelu_warm_start makes
# them), float32
MOONS_WARM_START = "tests/data/moons_jax_warm_start.npy"
# a state at equilibrium: the last recorded theta and eta of seeds 11-14 of
# `chip_profile.py classification --full` on the card (epoch 4,000 of a run
# from MOONS_WARM_START; NVIDIA H100 80GB HBM3, 700 W), one float32 row a
# seed, theta then eta
MOONS_EQUILIBRIUM = "tests/data/moons_equilibrium.npy"
# rows of the tutorial-shaped model: 80% of MNIST's 11,982 training 3s and 8s
TUTORIAL_ROWS = 9585
# phase 7: the flagship at the verify recipe over 64 chains, recorded every
# 10 epochs after the burn-in of 200 (1,280 networks, 10 files of 128); the
# interrupted run stops at epoch 300, a chunk boundary (the adapter's cycle
# is 10 epochs), where its checkpoint (every 5 chunks) falls
STORE_EPOCHS, STORE_STOP, STORE_STEP, STORE_PER_FILE = 400, 300, 10, 128
# the JAX bench's predict cell (benchmarks/run_benchmarks.py:1182-1240):
# 2,000 networks of the flagship around a seed-0 init (sd 0.05) over 4,096
# points; 220 multiply-adds a point and network
PREDICT_NETS, PREDICT_POINTS, PREDICT_MACS = 2000, 4096, 220
# the calls a route of the predict cell is timed over, after one warm call
PREDICT_REPS = 10
# K1's U-turn comparisons draw each chain's prior sd (its scale hyper
# squared) from this range: the tight prior makes a stable oscillator whose
# half period (pi sd) falls on both sides of eps L, so some chains turn and
# some are censored (from the flagship's own prior, the trajectories that
# turn within 200 steps are those that diverge, where float32 orders drift)
UTURN_PRIOR_SD = (0.02, 0.06)
# phase 9 (a): the JAX bench's surrogate pretraining
# (benchmarks/run_benchmarks.py:893-907): 1M x 8 N(0, 1) points from
# default_rng(1), y = sin(sum x) + 0.1 N(0, 1), 8-64-64-1 tanh, batch 8,192,
# one cycle of 4 epochs without callbacks, validation on the first 4,096
# rows
SURROGATE_POINTS, SURROGATE_IN, SURROGATE_WIDTH = 1_000_000, 8, 64
SURROGATE_BATCH, SURROGATE_EPOCHS = 8192, 4
# the tutorial's pretraining (examples/digits_classification.py:78-84 at
# MNIST width): 784-20-20-1 leaky relu with trained slopes over
# tutorial_data(), batch 32, 3 cycles x 10 epochs, patience 10; validation
# on MNIST's other 20% of 3s and 8s (2,397 rows, default_rng(15)),
# labelled by the same plane
TUTORIAL_VAL_ROWS, TUTORIAL_CYCLES, TUTORIAL_EPOCHS = 2397, 3, 10
# the card's tutorial pretraining against the CPU's over the first cycle,
# from the same init and batches: the final train and validation losses
# (float64 on the host) within this relative tolerance: the two differ only
# in float32 summation orders, which this cycle does not amplify (~1e-7 on
# an H100 80GB HBM3)
PRETRAIN_LOSS_RTOL = 1e-3
# the JAX examples' own figures at --smoke (`JAX_PLATFORMS=cpu python3
# jax_reference_stats.py examples`, which runs examples/<name>.py --cpu
# --smoke, on a CPU): extended_regression's grid RMSE and classification's
# posterior-ensemble validation accuracy; statistics of the sampler, not
# of the chip. The port's runs must reach a grid RMSE of at most 1.5x the
# first and an accuracy of at least the second less 0.05
JAX_EXAMPLE_REF = {"extended_regression": 0.0549, "classification": 0.990}
EXAMPLE_RMSE_FACTOR, EXAMPLE_ACCURACY_DROP = 1.5, 0.05
# phase 10: the JAX bench's surrogate_quality_exact
# (benchmarks/run_benchmarks.py:380-640) at full width: phase 9 (a)'s data
# and MAP warm start, 8-64-64-1 tanh Gaussian dense layers,
# GaussianLikelihood(sd=0.1) with a learned sd, 32 chains without jitter,
# data_chunk=125,000, numerics="exact", the exact-numerics grid; only the
# epochs are cut (600 -> 12, burn-in 200 -> 8) to fit this script's time
SURR_CHAINS, SURR_CHUNK = 32, 125_000
SURR_EPOCHS, SURR_BURNIN, SURR_SAMPLING = 12, 8, 2
SURR_MCMC = dict(step_size_start=5e-7, step_size_min=1e-8,
                 step_size_max=5e-5, step_size_options=40, leapfrog_start=10,
                 leapfrog_min=5, leapfrog_max=15, leapfrog_increment=5,
                 hyper_step_size=1e-6, hyper_leapfrog=5, averaging_steps=10,
                 random_steps=5)
# (b) the chunked potential at 4 chains against the float64 unchunked one:
# the value's relative error and the gradient's largest error over its
# largest entry (float32 sums over 1M rows in two orders: ~1e-7 on an H100)
SURR_VALUE_RTOL, SURR_GRAD_TOL = 1e-5, 1e-4
# (f) the fleet the driver could not run on K3 before it honoured
# data_chunk: 128 chains at 1M rows under default numerics (an unchunked
# K3 call's workspace 131.6 GB), 4 epochs
WIDE_FLEET_CHAINS, WIDE_FLEET_EPOCHS = 128, 4
# (c) the potential_noise walk (run_benchmarks.py:859-960): displacements
# t along one N(0, 1) direction (numpy seed 7)
NOISE_TS = [0.0] + [float(t) for t in np.logspace(-8, -4.5, 15)]
# (d) examples/surrogate_regression.py --cpu --smoke's figures from the JAX
# package (`JAX_PLATFORMS=cpu python3 jax_reference_stats.py examples` on
# a CPU): statistics of the sampler, not of the chip. The port's --smoke on
# the card must record the same sample count, a main acceptance within
# 0.05 and a learned sd within 10% (the port gives 0.999 / 1.3898 on a
# CPU, the JAX example 0.998 / 1.3733)
JAX_SURROGATE_SMOKE = {"samples": 8, "main_accept": 0.998,
                       "learned_sd": 1.3733}
SURR_SMOKE_ACCEPT_TOL, SURR_SMOKE_SD_RTOL = 0.05, 0.10
# the TPU capture of the same configuration at full length (600 epochs,
# benchmarks/captures r5_surr_grid_exact_np): a sampler statistic to
# match, not a speed
TPU_SURROGATE_REF = {"main_accept": (0.70, 0.76), "step_size": 3.2e-5,
                     "leapfrog": 15}
# the JAX package's MAP warm start of the surrogate at the bench's
# pretraining settings (run_benchmarks.py:430-436: one cycle of 4 epochs,
# batch 8,192, alpha 0.1, validation on the first 4,096 rows), trained on
# the CPU by
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py surrogate --warm-start
# and kept as one float32 vector: each dense layer's W (out, in) and then
# its b, in layer order (4,801 numbers)
SURR_WARM_START = "tests/data/surrogate_jax_warm_start.npy"
# a state at equilibrium: the last recorded theta and eta of chains 0-3 of
# `chip_profile.py surrogate --full --seeds 12` on the card (epoch 600 of a
# run from SURR_WARM_START; NVIDIA H100 80GB HBM3, 700 W), one float32 row
# a chain, theta then eta
SURR_EQUILIBRIUM = "tests/data/surrogate_equilibrium.npy"
# phase 10 (g): the same-state acceptance ladder. From each state ("warm":
# SURR_WARM_START, every chain at it; "equilibrium": SURR_EQUILIBRIUM's 4
# chains, twice over on the card) the main block runs at each fixed (eps,
# L) of LADDER_STEPS for LADDER_EPOCHS epochs under numerics="exact" and
# data_chunk=125,000, the hyper block as in the first epochs of a run with
# burn-in LADDER_BURNIN (`ladder_mcmc`). The port runs LADDER_CHAINS chains
# on the stepped runner and fails where its mean main accept probability is
# more than LADDER_Z standard errors (over chains, both sides) from the
# JAX package's, or its learned sd more than LADDER_SD_RTOL from it. The
# card side calls the chunk runner alone, where the JAX side runs its
# driver (`sample_posterior`): the port's driver is held to the JAX
# package's by tests/test_torch_surrogate_driver_parity.py on the CPU.
# The rungs are not equal gates: from the equilibrium state at (4.87e-5,
# 15) both sides accept nothing (0 against 0, z = 0), so that rung shows
# agreement but cannot separate a precision leak; the warm state at
# (3.2e-5, 15), where the JAX package accepts 0.9997 +- 0.0003, carries
# most of the ladder's power
LADDER_STEPS = ((3.2e-5, 15), (4.87e-5, 15))
LADDER_EPOCHS, LADDER_BURNIN, LADDER_CHAINS = 10, 200, 8
LADDER_Z, LADDER_SD_RTOL = 3.0, 0.10
# the JAX package's figures at each state and rung (4 chains on the CPU), as
# printed by
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py surrogate --ladder
# (the n_chains, epochs and cpu_seconds keys left out): statistics of the
# sampler, not of any chip
LADDER_JAX = (
    dict(state="warm", eps=3.2e-05, leapfrog=15,
         main_accept=0.9997328832745552,
         main_accept_se=0.00026711672544479925, main_accept_chain=[1.0,
         0.9989315330982208, 1.0, 1.0], learned_sd=0.12909072164139718,
         hyper_accept=0.9885208010673523),
    dict(state="warm", eps=4.87e-05, leapfrog=15,
         main_accept=0.6753062149509788,
         main_accept_se=0.06295657776154807, main_accept_chain=[0.5,
         0.701224859803915, 0.7, 0.8], learned_sd=0.1328939729690991,
         hyper_accept=0.9903184771537781),
    dict(state="equilibrium", eps=3.2e-05, leapfrog=15,
         main_accept=0.35709599617618826,
         main_accept_se=0.08904569850663245,
         main_accept_chain=[0.16912454332331606, 0.2721783178858459,
         0.5812078844755888, 0.40587323902000205],
         learned_sd=0.10563142052139737, hyper_accept=0.9226871728897095),
    dict(state="equilibrium", eps=4.87e-05, leapfrog=15, main_accept=0.0,
         main_accept_se=0.0, main_accept_chain=[0.0, 0.0, 0.0, 0.0],
         learned_sd=0.10566012197257649, hyper_accept=0.9240147471427917),
)
# phase 6 (e), last: the moons stack's same-state acceptance ladder. From
# each state ("warm": MOONS_WARM_START, every chain at it; "equilibrium":
# MOONS_EQUILIBRIUM's 4 rows, each 4 times) the full-width moons stack runs
# MOONS_LADDER_CHAINS chains at each fixed (eps, L) of that state's
# MOONS_LADDER_STEPS for MOONS_LADDER_EPOCHS epochs on K1 (d) and the plain
# hyper block (100 steps from 1e-3, its dual averaging as in the first
# epochs of the full run: `moons_ladder_mcmc`), through the graph runner.
# It fails where the mean main accept probability is more than
# MOONS_LADDER_Z standard errors (over chains, both sides) from the JAX
# package's on the same state and rung, or the mean hyper acceptance more
# than MOONS_HYPER_TOL from it. Each state's rungs span the top of the
# example's step grid down to where the JAX package accepts 0.2-0.8: the
# posterior at equilibrium is far narrower than at the warm start, where
# (5e-3, 100), which the warm start accepts at 0.975, accepts nothing
MOONS_LADDER_STEPS = {"warm": ((5e-3, 100), (1e-2, 100), (2e-2, 50)),
                      "equilibrium": ((3e-4, 100), (1e-3, 100),
                                      (2e-3, 100))}
MOONS_LADDER_EPOCHS, MOONS_LADDER_CHAINS = 10, 16
MOONS_LADDER_Z, MOONS_HYPER_TOL = 3.0, 0.05
# the JAX package's figures at each state and rung (MOONS_LADDER_CHAINS chains
# on the CPU), as printed by
#   JAX_PLATFORMS=cpu python3 jax_reference_stats.py classification --ladder
# (the n_chains, epochs and cpu_seconds keys left out): statistics of the
# sampler, not of any chip
MOONS_LADDER_JAX = (
    dict(state='warm', eps=0.005, leapfrog=100, main_accept=0.9751654554158449,
         main_accept_se=0.0030416739017633905,
         main_accept_chain=[0.995827031135559, 0.966376394033432,
         0.9555021524429321, 0.978502756357193, 0.9746471226215363,
         0.9918704628944397, 0.9734610617160797, 0.9819475471973419,
         0.9826388120651245, 0.9870263159275054, 0.9740806698799134,
         0.9577146589756012, 0.9871228516101838, 0.9694081723690033,
         0.959488695859909, 0.9670325815677643],
         hyper_accept=0.513572096824646),
    dict(state='warm', eps=0.01, leapfrog=100, main_accept=0.8027366029222156,
         main_accept_se=0.04532065330495298,
         main_accept_chain=[0.9208679020404815, 0.8775564670562744,
         0.7813147503795335, 0.8732721073552966, 0.6376205861571421,
         0.9114259839057922, 0.8491260290145874, 0.8579911947250366,
         0.1736117184360251, 0.8571830570697785, 0.8786990642547607,
         0.8620548278093338, 0.8936759293079376, 0.7765651643276215,
         0.8085905075073242, 0.8842303574085235],
         hyper_accept=0.4772094786167145),
    dict(state='warm', eps=0.02, leapfrog=50, main_accept=0.4938313123350296,
         main_accept_se=0.04019062650058094,
         main_accept_chain=[0.8380506753921508, 0.44425399475730953,
         0.4851819097995758, 0.47141578793525696, 0.53418670296669,
         0.41767046935856345, 0.27438350140294515, 0.7090768694877625,
         0.2133205589838326, 0.42801597126641544, 0.40904385363683105,
         0.4069859567288631, 0.6911714792251586, 0.4137182507443214,
         0.5303255259608705, 0.6344994897139259],
         hyper_accept=0.5105018615722656),
    dict(state='equilibrium', eps=0.0003, leapfrog=100,
         main_accept=0.9495951696600432, main_accept_se=0.02389274226877794,
         main_accept_chain=[0.999327826499939, 0.9993088960647583,
         0.9998962640762329, 0.7398718558251858, 0.9884616672992707,
         0.9992522597312927, 0.9868886470794678, 0.7438876814942489,
         0.9992410898208618, 0.9985421538352967, 0.9962539553642273,
         0.9466664612293243, 0.9993544340133667, 0.9999222040176392,
         0.9996967613697052, 0.7969505568398745],
         hyper_accept=0.43870535492897034),
    dict(state='equilibrium', eps=0.001, leapfrog=100,
         main_accept=0.6586378042511607, main_accept_se=0.09951096539514284,
         main_accept_chain=[0.8577217578887939, 0.9497941613197327,
         0.7584444878622889, 0.0011450447142124175, 0.7741089154034853,
         0.9960048019886016, 0.7193891327828169, 0.0, 0.9722859978675842,
         0.98500936627388, 0.5578888778989495, 3.01072446973194e-08,
         0.9342168509960175, 0.9757546305656433, 0.9674826860427856,
         0.08895812630653381], hyper_accept=0.44433221220970154),
    dict(state='equilibrium', eps=0.002, leapfrog=100,
         main_accept=0.226575619314143, main_accept_se=0.06065412148087222,
         main_accept_chain=[0.4695008537605858, 0.4599957799335243,
         0.0024138990254684244, 0.0, 0.29203150540326517, 0.7090729501098394,
         0.1, 0.0, 0.3432535719256219, 0.4507952188083436,
         5.353245846606569e-10, 0.0, 0.13533923838658057, 0.5714171776548028,
         0.09138971348293126, 0.0], hyper_accept=0.4499245285987854),
)
# phase 11: the (chains, data) mesh on a virtual mesh of this card. (a) the
# flagship on 4x1 against the mesh-less run: the same MH decisions and
# samples within this fraction of their largest entry (a chain shard's 16
# chains run K1's and K2's per-chain arithmetic as the fleet's 64 do; only
# the glue's row sums, such as the kinetic energies, may take another
# order for a smaller batch)
MESH_FLAGSHIP_ATOL = 1e-6
# (b) wide_deep on 2x2 against the mesh-less K3 run: the same main and
# hyper MH decisions and theta within this fraction of its largest entry
# (the likelihood summed in two halves, K3 planned for 64 rows and 32
# chains: 2.4e-7 apart at 3 epochs), the main block's move over the run
# above MESH_MOVE_OVER_TOL times that tolerance (so a frozen main block
# or a wrong gradient leaves it), the stats' R within this relative
# tolerance at the final state, and K exactly 128
MESH_DATA_ATOL = 1e-5
MESH_MOVE_OVER_TOL = 10.0
MESH_STATS_RTOL = 1e-6
# (c) the exact-numerics surrogate on 1x4 against the same
# MESH_EXACT_EPOCHS epochs (burn-in MESH_EXACT_BURNIN) without the mesh:
# mean main and hyper acceptance within this distance (the two sum the
# likelihood in other orders, so the chains part by ulps)
MESH_ACCEPT_TOL = 0.05
MESH_EXACT_EPOCHS, MESH_EXACT_BURNIN = 4, 2
# (e) the predict cell on 2x2 against the unsharded predict: each block's
# batched products have other shapes, which may sum in another order
MESH_PREDICT_TOL = 1e-6
# phase 12: the steady epochs each runner is timed over in each K1 cell
GRAPH_STEADY = 100
# phase 12's stepped cells: wide_deep's per-chain (eps, L) in four groups
# of 16 chains; the host launches an epoch the stepped runner may issue
# at wide_deep over L (head and tail replays and the trace's row copies);
# the default-numerics surrogate's peak memory over the eager runner's
WIDE_GROUPS = ((1e-5, 20), (5e-6, 25), (2e-5, 15), (1e-5, 10))
STEPPED_LAUNCHES_OVER_L = 10
STEPPED_PEAK_OVER_EAGER = 1.1
# phase 13: the cells of phase 12 that run over a chains-only mesh of this
# card, and its chains axis (the G = 4 block one adapter group a shard)
MESH_GRAPH_CELLS = {"flagship 64": 4, "G = 4 512": 4,
                    "U-turn 512 alternate": 2, "multiclass 128": 2,
                    "wide_deep 64": 2}
# phase 13's data-mesh cells (the stepped runner, each part split at its
# sums over the data peers) and their (chains, data) meshes of this card.
# An epoch's head and each leapfrog step reach one sum (the main block's
# evaluation), its tail DATA_TAIL_SUMS (the stats' (R, K) of a coupled
# hyper block, or the tempered swap's log-likelihood). The host launches
# an epoch a chain shard may issue there: L + 2 part replays (the head,
# the L steps, the tail); at each sum a home segment, a replay a peer and
# at most DATA_COPIES_A_PEER tensors copied between the home and each
# other peer (the argument's two, the part's two);
# STEPPED_LAUNCHES_OVER_L an epoch (the head's generator fills, the
# trace's row copies) and DATA_CHUNK_LAUNCHES a chunk (filling the static
# buffers, the result's copies), spread over its epochs
MESH_DATA_CELLS = {"wide_deep 64": (2, 2),
                   "multiclass tempered 64 x 4": (1, 2),
                   "surrogate 32 exact": (1, 4),
                   "surrogate 32 default": (1, 4)}
DATA_TAIL_SUMS = 1
DATA_COPIES_A_PEER = 4
DATA_CHUNK_LAUNCHES = 20


_START = time.perf_counter()


def phase(name):
    """Prints a phase's heading with the script's seconds so far."""
    print(f"\n== {name} (at {time.perf_counter() - _START:.1f} s)",
          flush=True)


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


def fused_paths_network(device, seed=0):
    """1-6-5-4-1 on the flagship data under a fixed-sd Gaussian likelihood,
    through every path of K1's layer table: an Elu (its derivative reads
    the pre-activation plane) followed by a Relu (an op that does not
    follow a dense layer: a layer of its own), a Sigmoid and an Exp fused
    into their dense layers."""
    from tensorbnn_tpu_torch import Elu, Exp, FixedGaussianLikelihood, \
        GaussianDenseLayer, Relu, Sigmoid
    net = trig_network(device, seed)
    net.add(GaussianDenseLayer(1, 6)).add(Elu()).add(Relu())
    net.add(GaussianDenseLayer(6, 5)).add(Sigmoid())
    net.add(GaussianDenseLayer(5, 4)).add(Exp())
    net.add(GaussianDenseLayer(4, 1))
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


def moons_data():
    """The moons example's rows: ``(x_train, y_train, x_val, y_val)``,
    two_moons(200, seed=0) and two_moons(100, seed=1)."""
    from tensorbnn_tpu_torch.examples.classification import two_moons
    return (*two_moons(200, seed=0), *two_moons(100, seed=1))


def moons_template() -> tuple:
    """The moons stack's params as zeros, one dict a layer (the sigmoid's
    empty), in the Network's layer order."""
    dims, layers = [2, MOONS_WIDTH, MOONS_WIDTH, 1], []
    for i in range(3):
        layers.append({"b": np.zeros(dims[i + 1], np.float32),
                       "w": np.zeros((dims[i], dims[i + 1]), np.float32)})
        layers.append({"slopes": np.zeros(MOONS_WIDTH, np.float32)}
                      if i < 2 else {})
    return tuple(layers)


def moons_parameters(flat) -> list:
    """A flat moons theta (``MOONS_WARM_START``'s order) as the
    ``parameters=`` of each layer ``Network.add`` takes (None for the
    sigmoid)."""
    from tensorbnn_tpu_torch.sampler.potential import _make_unravel

    unravel = _make_unravel(moons_template())
    if np.size(flat) != unravel.size:
        raise ValueError(f"a moons theta holds {unravel.size} numbers, "
                         f"not {np.size(flat)}")
    return [{k: np.asarray(v, np.float32) for k, v in p.items()} or None
            for p in unravel(np.asarray(flat, np.float32))]


def flat_moons(parameters) -> np.ndarray:
    """``moons_parameters``' inverse: the layers' override dicts (None for
    the sigmoid) as one float32 theta."""
    from tensorbnn_tpu_torch.sampler.potential import tree_leaves
    return np.concatenate([np.ravel(np.asarray(a, np.float32))
                           for a in tree_leaves([p or {} for p in
                                                 parameters])])


def moons_jax_warm_start() -> list:
    """The committed JAX warm start (``MOONS_WARM_START``) as each layer's
    ``parameters=``."""
    return moons_parameters(np.load(repo_file(MOONS_WARM_START)))


def moons_equilibrium() -> tuple:
    """``MOONS_EQUILIBRIUM`` as ``(theta (4, D), eta (4, H))``."""
    rows = np.load(repo_file(MOONS_EQUILIBRIUM))
    d = flat_moons(moons_template()).size
    return rows[:, :d], rows[:, d:]


def moons_probs(parameters, x) -> np.ndarray:
    """The moons stack's sigmoid output at the rows ``x`` (float64 on the
    host) for one set of ``moons_parameters``."""
    h = np.asarray(x, np.float64)
    for i in range(3):
        h = h @ parameters[2 * i]["w"] + parameters[2 * i]["b"]
        if i < 2:
            h = np.where(h < 0, parameters[2 * i + 1]["slopes"].astype(
                np.float64) ** 2 * h, h)
    return 0.5 * (1.0 + np.tanh(0.5 * h[:, 0]))


def moons_network(device, seed=42, parameters=None):
    """The moons example's Network (examples/classification.py:70-82) on
    ``device`` at Network seed ``seed`` (the example's 42), each layer
    warm-started from ``parameters`` (``moons_parameters``; None: the
    Network's init), with ``MOONS_MCMC``, and its Bernoulli likelihood."""
    from tensorbnn_tpu_torch import BernoulliLikelihood, GaussianDenseLayer, \
        Network, Sigmoid, SquarePrelu

    x, y, xv, yv = moons_data()
    parameters = parameters or [None] * 5
    net = Network(torch.float32, 2, x, y, xv, yv, seed=seed, device=device)
    dims = [2, MOONS_WIDTH, MOONS_WIDTH, 1]
    for i in range(3):
        net.add(GaussianDenseLayer(dims[i], dims[i + 1]),
                parameters=parameters[2 * i])
        if i < 2:
            net.add(SquarePrelu(MOONS_WIDTH, alpha=0.55),
                    parameters=parameters[2 * i + 1])
    net.add(Sigmoid())
    net.setup_mcmc(**MOONS_MCMC)
    return net, BernoulliLikelihood()


def tutorial_data():
    """``TUTORIAL_ROWS`` rows of uniform [0, 1) pixels (``default_rng(5)``;
    MNIST is not in the repository) labelled by a fixed random hyperplane
    through the pixels' mean; returns the rows, labels and the plane's
    normal."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(TUTORIAL_ROWS, 784)).astype(np.float32)
    plane = rng.normal(size=784)
    y = ((x - 0.5) @ plane > 0).astype(np.float32)
    return x, y, plane


def tutorial_network(device, seed=0, warm=None):
    """The reference's classification tutorial stack at MNIST 3-vs-8 width
    (examples/digits_classification.py:18-20, :81-103 with 784 inputs):
    GaussianDense(784, 20), SquarePrelu(20, alpha=sqrt(0.1)),
    GaussianDense(20, 20), SquarePrelu(20), GaussianDense(20, 1), Sigmoid,
    Bernoulli, over ``tutorial_data()``. ``warm``, pretraining's
    ``(weights, biases, activations)``, warm-starts the dense layers and
    the slopes, as the tutorial does."""
    from tensorbnn_tpu_torch import BernoulliLikelihood, GaussianDenseLayer, \
        Network, Sigmoid, SquarePrelu
    from tensorbnn_tpu_torch.training.pretrain import dense_warm_start, \
        squareprelu_warm_start

    starts = [None] * 5
    if warm is not None:
        w, b, a = warm
        starts = [dense_warm_start(w, b, 0), squareprelu_warm_start(a, 0),
                  dense_warm_start(w, b, 1), squareprelu_warm_start(a, 1),
                  dense_warm_start(w, b, 2)]
    x, y, _ = tutorial_data()
    net = Network(torch.float32, 784, x, y, x, y, seed=seed, device=device)
    net.add(GaussianDenseLayer(784, 20), parameters=starts[0])
    net.add(SquarePrelu(20, alpha=math.sqrt(0.1)), parameters=starts[1])
    net.add(GaussianDenseLayer(20, 20), parameters=starts[2])
    net.add(SquarePrelu(20), parameters=starts[3])
    net.add(GaussianDenseLayer(20, 1), parameters=starts[4]).add(Sigmoid())
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


def stack_network(device, n_blocks, learned_sd=False, seed=0):
    """``n_blocks`` Gaussian dense layers, 1-4-...-4-1 tanh, on the flagship
    data: K2's widest tables, 32 items uncoupled at 16 blocks (64 hypers)
    and 31 with a learned sd at 15 (61)."""
    from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
        GaussianDenseLayer, GaussianLikelihood, Tanh
    net = trig_network(device, seed)
    net.add(GaussianDenseLayer(1, 4)).add(Tanh())
    for _ in range(n_blocks - 2):
        net.add(GaussianDenseLayer(4, 4)).add(Tanh())
    net.add(GaussianDenseLayer(4, 1))
    if learned_sd:
        return net, GaussianLikelihood(sd=0.1)
    return net, FixedGaussianLikelihood(sd=0.1)


def chunk_runner(net, lik, flat, hyper_steps, hyper_eps, tempering_beta=None,
                 record_uturn=False, eager=False, per_epoch_leapfrog=False,
                 mesh=None, n_chains=None, data_chunk=None):
    """The chunk runner of ``(net, lik)`` with the kernels that
    ``sample_posterior`` picks (K1, else K3, for the main block; K2 for the
    hyper block where the stats layout applies, else the plain block),
    ``hyper_steps`` hyper leapfrog steps from ``hyper_eps``,
    tempered by ``tempering_beta = (K, per-chain betas)`` when given (K1's
    tempered program, never K3), recording U-turn steps with
    ``record_uturn`` (K1's recording program): the steady rates here and
    the profile of chip_profile.py. It is a graph runner where one
    applies (K1's graph of the chunk, else the stepped runner, on this
    card), unless ``eager``; ``per_epoch_leapfrog`` takes a U-turn run's
    per-epoch counts (the driver's) for a shared one; over ``mesh`` (a
    chains-only one) when given; ``n_chains`` the fleet the stepped
    runner's workspace gate is decided for (None: not gated);
    ``data_chunk`` the row chunks of K3 and of the stats potential. Over a
    data axis above 1 no K1 is built (it cannot sum over the data peers),
    and K3 is built for a peer's rows (chunked there), as the driver
    builds them."""
    from tensorbnn_tpu_torch.ops import fused_hyper, fused_mlp
    from tensorbnn_tpu_torch.parallel.chains import \
        make_multichain_chunk_runner
    from tensorbnn_tpu_torch.parallel.mesh import DATA_AXIS

    h = flat.eta.numel()
    x, y = net.train_x, net.train_y
    tempered = tempering_beta is not None
    n_data = 1 if mesh is None else mesh.shape[DATA_AXIS]
    traj = None if n_data > 1 else fused_mlp.try_build_fused_trajectory(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h,
        tempered=tempered, record_uturn=record_uturn)
    vg = None if traj or tempered else fused_mlp.try_build_fused_main_vg(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, x, y, h,
        n_rows=x.shape[0] // n_data, data_chunk=data_chunk)
    hyper = fused_hyper.try_build_fused_hyper_trajectory(
        net.model, lik, flat.unravel_eta, h, hyper_steps)
    # a tempered run over data peers runs the plain main block
    assert traj or vg or tempered and n_data > 1, \
        "the main-block kernels declined the model"
    return make_multichain_chunk_runner(
        net.model, lik, x, y, flat.unravel_theta, flat.unravel_eta,
        adjust_hypers=True, hyper_leapfrog=hyper_steps, burnin=100.0,
        hyper_step_size_init=hyper_eps, eta_dim=h, batched_main_traj=traj,
        batched_main_vg=vg, batched_hyper_traj=hyper,
        tempering_beta=tempering_beta, record_uturn=record_uturn,
        per_epoch_leapfrog=per_epoch_leapfrog, eager=eager, mesh=mesh,
        n_chains=n_chains, data_chunk=data_chunk)


def rung_groups(c, n_rungs=4):
    """Per-chain ``(eps (C,), L (C,))`` of ``K1_GROUPS``, one group per
    rung of a rung-major fleet of ``c`` replicas."""
    groups = np.repeat(np.asarray(K1_GROUPS[:n_rungs]), c // n_rungs, axis=0)
    return groups[:, 0].astype(np.float32), groups[:, 1].astype(np.int32)


def quality(label, net, res, wall, burnin, xq=None, **extra):
    """``quality_figures``, printed as one JSON line."""
    out = quality_figures(label, net, res, wall, burnin, xq, **extra)
    print(json.dumps({"quality": out}), flush=True)
    return out


def quality_figures(label, net, res, wall, burnin, xq=None, **extra):
    """The quality figures of ``ess_run``: total ESS of the predictive mean
    at x = 0.5 (or at the input row ``xq``;
    ``effective_sample_size_batch`` over chains), the worst
    parameter's pooled ESS, both per second of ``wall``, and the
    post-burn-in main and hyper acceptance, the final (eps, L) of each
    adapter group (rung) and their means (and the swap rate per rung of a
    tempered run, and ``extra``)."""
    from tensorbnn_tpu_torch.sampler.potential import flatten_state
    from tensorbnn_tpu_torch.utils.autocorr import \
        effective_sample_size_batch

    params, hypers = net.init_state()
    unravel = flatten_state(params, hypers, {}).unravel_theta
    s, c, d = res.theta_samples.shape
    xq = torch.tensor([[0.5]] if xq is None else xq, device=net.device)
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
           "final_leapfrog": res.final_leapfrog,
           "group_step_size": list(res.group_step_size),
           "group_leapfrog": list(res.group_leapfrog)}
    if res.swap_accept_rung is not None:
        out["swap_accept_rung"] = res.swap_accept_rung.mean(axis=0).tolist()
    out.update(extra)
    return out


def g4_run(dev, seed):
    """The 512-chain, G = 4 quality block (``ess_run``'s settings) through
    ``Network.train`` at Network seed ``seed``: ``(net, res, wall)``."""
    return quality_run(dev, seed, n_adapters=4)


def tempered_run(dev, seed):
    """The tempered quality block (512 cold chains x 4 rungs at beta_min
    0.5, one adapter a rung) at Network seed ``seed``."""
    return quality_run(dev, seed, tempering=4, tempering_beta_min=0.5)


def uturn_run(dev, seed, probe):
    """The U-turn quality block (512 chains, one shared length schedule)
    under ``probe`` at Network seed ``seed``."""
    return quality_run(dev, seed, trajectory="uturn", uturn_probe=probe)


def quality_run(dev, seed, **train):
    """A quality block of ``QUALITY_CHAINS`` chains at ``ess_run``'s
    settings through ``Network.train`` at Network seed ``seed``, with the
    further ``train`` keywords: ``(net, res, wall)``."""
    net, lik = flagship_network(dev, seed=seed)
    net.setup_mcmc(**ESS_RUN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net.train(ESS_EPOCHS, 2, lik, n_chains=QUALITY_CHAINS,
                    chain_jitter=0.05, verbose=False, **train)
    torch.cuda.synchronize()
    return net, res, time.perf_counter() - t0


def uturn_extra(res, probe) -> dict:
    """A U-turn block's own figures for its ``quality`` line: the probe,
    the executed leapfrog work in all and in burn-in, and the chain-epochs
    whose trajectory turned within its L (the rest were censored) in
    burn-in (what the adapter's reservoir saw) and after."""
    burnin = ESS_RUN["burnin"]
    return dict(probe=probe, leapfrog_work=float(res.leapfrog.sum()),
                burnin_leapfrog_work=float(res.leapfrog[:burnin].sum()),
                burnin_turned=int(res.uturn_turned[:burnin].sum()),
                sampling_turned=int(res.uturn_turned[burnin:].sum()))


def seed_band(port, ref, keys=G4_BAND) -> dict:
    """For each statistic in ``keys`` over the port's seed lines ``port``
    and the JAX package's ``ref``: each side's mean and sample sd, and
    ``z = |mean_p - mean_j| / sqrt(sd_p^2 / n_p + sd_j^2 / n_j)`` (0 where
    every seed on both sides gives the same value)."""
    band = {}
    for key in keys:
        p = np.asarray([line[key] for line in port], np.float64)
        j = np.asarray([line[key] for line in ref], np.float64)
        sp, sj = p.std(ddof=1), j.std(ddof=1)
        se = math.sqrt(sp ** 2 / p.size + sj ** 2 / j.size)
        diff = abs(p.mean() - j.mean())
        z = diff / se if se > 0 else 0.0 if diff == 0 else math.inf
        band[key] = {"port_mean": p.mean(), "port_sd": sp,
                     "jax_mean": j.mean(), "jax_sd": sj, "z": z}
    return band


def seed_lines(label, run, seeds, first, extra=lambda res: {}) -> list:
    """The ``quality`` lines of a block over ``seeds``: ``first`` (the
    first seed's, already printed), then ``run(seed) -> (net, res, wall)``
    at each later seed, each on K1 + K2 with finite samples, its line
    printed with ``extra(res)``. The runs come first, so that no wall
    shares the host; then their diagnostics (numpy's, ~10 s a seed at this
    size, ~7 GB of host memory) five at a time, printed in seed order."""
    runs = []
    for seed in seeds[1:]:
        net, res, wall = run(seed)
        assert res.main_path == "K1" and res.fused_hyper, res.main_path
        assert np.isfinite(res.theta_samples).all()
        runs.append((net, res, wall, seed))
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        lines = [first, *pool.map(
            lambda r: quality_figures(label, *r[:3], ESS_RUN["burnin"],
                                      seed=r[3], **extra(r[1])), runs)]
    del runs
    for line in lines[1:]:
        print(json.dumps({"quality": line}), flush=True)
    return lines


def band_gate(name, lines, ref, failed, keys=G4_BAND, **more) -> dict:
    """Prints ``{name: ...}``: the seeds of both sides, the band of the
    statistics ``keys`` over ``lines`` against ``ref``, and ``more``. Adds
    to ``failed`` each ``G4_GATED`` statistic whose z exceeds
    ``G4_BAND_Z``, and raises where ``failed`` is not empty."""
    band = seed_band(lines, ref, keys)
    failed[:0] = [k for k in G4_GATED if not band[k]["z"] <= G4_BAND_Z]
    print(json.dumps({name: {
        "port_seeds": [line["seed"] for line in lines],
        "jax_seeds": [line["seed"] for line in ref],
        "z_limit": G4_BAND_Z, **more, "failed": failed, **band}}),
        flush=True)
    if failed:
        raise AssertionError(f"{name}: the port's seeds miss the JAX "
                             f"package's band in {failed}")
    return band


def g4_band(dev, first) -> dict:
    """Phase 6 (b)'s seed band: the G = 4 block at each seed of
    ``G4_SEEDS`` after the first (whose ``quality`` line is ``first``), a
    ``quality`` line each, then the band against ``G4_JAX_SEEDS`` as a
    ``{"g4_band": ...}`` line. Raises where a gated statistic's z exceeds
    ``G4_BAND_Z`` or the seeds' mean hyper acceptance leaves
    ``HYPER_ACCEPT_REF``."""
    lines = seed_lines("512 chains, G = 4", lambda s: g4_run(dev, s),
                       G4_SEEDS, first)
    mid, half = HYPER_ACCEPT_REF
    port_hyper = np.mean([line["hyper_accept"] for line in lines])
    failed = [] if abs(port_hyper - mid) <= half else ["hyper_accept"]
    return band_gate("g4_band", lines, G4_JAX_SEEDS, failed,
                     hyper_accept_ref=HYPER_ACCEPT_REF)


def finals(lines, keys) -> list:
    """Each line's final (eps, L) under ``keys``, in seed order."""
    return [[line[k] for k in keys] for line in lines]


def tempered_band(dev, first) -> dict:
    """Phase 6 (c)'s seed band: the tempered block at each seed of
    ``TEMPERED_SEEDS`` after the first (``first``), a ``quality`` line
    each, then the band against ``TEMPERED_JAX_SEEDS`` as a
    ``{"tempered_band": ...}`` line with each rung's final (eps, L) over
    the seeds on both sides. Raises where a gated statistic's z exceeds
    ``G4_BAND_Z`` or a seed's swap rate on a rung is more than
    ``SWAP_RUNG_TOL`` from the JAX seeds' mean on that rung."""
    lines = seed_lines("tempered K = 4 at beta_min 0.5, 512 cold chains",
                       lambda s: tempered_run(dev, s), TEMPERED_SEEDS,
                       first)
    jax_swap = np.mean([line["swap_accept_rung"]
                        for line in TEMPERED_JAX_SEEDS], axis=0)
    port_swap = np.asarray([line["swap_accept_rung"] for line in lines])
    failed = ([] if (np.abs(port_swap - jax_swap) <= SWAP_RUNG_TOL).all()
              else ["swap_accept_rung"])
    rungs = ("group_step_size", "group_leapfrog")
    return band_gate(
        "tempered_band", lines, TEMPERED_JAX_SEEDS, failed,
        swap_rung_tol=SWAP_RUNG_TOL, jax_swap_accept_rung=jax_swap.tolist(),
        port_swap_accept_rung=port_swap.tolist(),
        port_rungs=finals(lines, rungs),
        jax_rungs=finals(TEMPERED_JAX_SEEDS, rungs))


def uturn_band(dev, first) -> dict:
    """Phase 6 (g)'s seed band: the U-turn block under the "always" probe
    at each seed of ``UTURN_SEEDS`` after the first (``first``), a
    ``quality`` line each, then the band against ``UTURN_JAX_SEEDS`` as a
    ``{"uturn_band": ...}`` line with the final (eps, L) over the seeds on
    both sides and the band of the final eps. Raises where a gated statistic's z exceeds ``G4_BAND_Z``
    or a seed's final L leaves the JAX seeds' range."""
    lines = seed_lines("U-turn, probe always, 512 chains",
                       lambda s: uturn_run(dev, s, "always"), UTURN_SEEDS,
                       first, lambda res: uturn_extra(res, "always"))
    jax_l = [line["final_leapfrog"] for line in UTURN_JAX_SEEDS]
    l_range = [min(jax_l), max(jax_l)]
    failed = ([] if all(l_range[0] <= line["final_leapfrog"] <= l_range[1]
                        for line in lines) else ["final_leapfrog"])
    fin = ("final_step_size", "final_leapfrog")
    # the frozen step size varies over seeds on both sides: its band too,
    # not gated
    return band_gate("uturn_band", lines, UTURN_JAX_SEEDS, failed,
                     keys=G4_BAND + fin[:1],
                     jax_final_leapfrog_range=l_range,
                     port_finals=finals(lines, fin),
                     jax_finals=finals(UTURN_JAX_SEEDS, fin))


def tempered_block(dev, d, reset_counts, read_counts) -> dict:
    """Phase 6 (c): the tempered quality block at ``TEMPERED_SEEDS[0]``
    with the kernels' launches counted (one tempered K1 launch an epoch,
    some of K2, none of K3), its samples' shape (``d`` weights), its swap
    rates per rung against ``SWAP_RUNG_REF``, then ``tempered_band``.
    Returns the counts."""
    reset_counts()
    net, res, wall = tempered_run(dev, TEMPERED_SEEDS[0])
    counts = read_counts("tempered quality block (K1 tempered + K2)")
    if counts["K1"] != ESS_EPOCHS or counts["K3"] or counts["K2"] < 1:
        raise AssertionError(f"the tempered block did not run on tempered "
                             f"K1 (one launch per epoch) + K2 alone: "
                             f"{counts}")
    assert res.main_path == "K1" and res.fused_hyper, res.main_path
    n_samples = (ESS_EPOCHS - ESS_RUN["burnin"]) // 2
    assert res.theta_samples.shape == (n_samples, QUALITY_CHAINS, d), \
        res.theta_samples.shape
    assert np.isfinite(res.theta_samples).all()
    assert np.isfinite(res.eta_samples).all()
    tq = quality("tempered K = 4 at beta_min 0.5, 512 cold chains", net,
                 res, wall, ESS_RUN["burnin"], seed=TEMPERED_SEEDS[0])
    del net, res
    swap_err = np.abs(np.asarray(tq["swap_accept_rung"])
                      - np.asarray(SWAP_RUNG_REF))
    if (swap_err > SWAP_RUNG_TOL).any():
        raise AssertionError(f"swap rates per rung {tq['swap_accept_rung']} "
                             f"are not within {SWAP_RUNG_TOL} of the JAX "
                             f"package's {SWAP_RUNG_REF}")
    assert abs(tq["hyper_accept"] - 0.95) < 0.15, tq["hyper_accept"]
    assert 0.0 < tq["main_accept"] < 1.0, tq["main_accept"]
    tempered_band(dev, tq)
    return counts


def uturn_block(dev, d, probe, reset_counts, read_counts) -> dict:
    """Phase 6 (g): the U-turn quality block under ``probe`` at
    ``UTURN_SEEDS[0]`` with the kernels' launches counted (one K1
    launch an epoch, some of K2, none of K3), held to the JAX package's
    one-seed statistics (``UTURN_REF``); under "always" then
    ``uturn_band``. Returns the counts."""
    reset_counts()
    net, res, wall = uturn_run(dev, UTURN_SEEDS[0], probe)
    counts = read_counts(f"U-turn quality block, probe {probe} (K1 "
                         f"record_uturn + K2)")
    if counts["K1"] != ESS_EPOCHS or counts["K3"] or counts["K2"] < 1:
        raise AssertionError(f"the U-turn block did not run on K1 (one "
                             f"launch per epoch) + K2 alone: {counts}")
    assert res.main_path == "K1" and res.fused_hyper, res.main_path
    assert res.leapfrog.shape == (ESS_EPOCHS,), res.leapfrog.shape
    n_samples = (ESS_EPOCHS - ESS_RUN["burnin"]) // 2
    assert res.theta_samples.shape == (n_samples, QUALITY_CHAINS, d), \
        res.theta_samples.shape
    assert np.isfinite(res.theta_samples).all()
    assert np.isfinite(res.eta_samples).all()
    # the turned counts, not the burn-in work (the ratchet of an
    # all-censored fleet), show that the path's recorded steps reach the
    # adapter
    uq = quality(f"U-turn, probe {probe}, 512 chains", net, res, wall,
                 ESS_RUN["burnin"], seed=UTURN_SEEDS[0],
                 **uturn_extra(res, probe))
    del net, res
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
    if probe == "always":
        uturn_band(dev, uq)
    return counts


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


def k1_shape_bound(prog, args, l_c):
    """K1 (d)'s bound at a shape: each chain's L + 1 evaluations of the
    dense products plus ~10 FLOP per theta row and evaluation (priors,
    slopes, leapfrog); inputs theta, mom, eta, x, y, eps, L read once,
    outputs q, v, lp0, lp1 written once."""
    theta, eta, _, x, _ = args
    c, d = theta.shape
    n, d_in = x.shape
    evals = float((l_c.to(torch.float64) + 1).sum())
    return bound(evals * (product_flops(prog.ops, n) + 10 * d),
                 4 * (4 * c * d + c * eta.shape[1] + n * (d_in + 1)
                      + 4 * c))


def k3_shape_bound(ops, thetas, xs):
    """K3's bound at a shape: the products (activations and tails under
    1%); theta read and grad written, x and y read once, ll written."""
    c, d = thetas.shape
    n, d_in = xs.shape
    return bound(c * product_flops(ops, n),
                 4 * (2 * c * d + n * (d_in + 1) + 2 * c))


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


def he_init_check(net, lik, flat, dev, c=64):
    """K3's Bernoulli tail at the tutorial's own start: ``c`` chains of the
    Network's He-init state, jittered as ``train(chain_jitter=0.01)`` does.
    The sigmoid saturates there, so K3 and the float32 twin are each held
    against the twin run in float64; fails if K3's max error in ll or grad
    is more than twice the float32 twin's. Returns K3's max grad error."""
    from tensorbnn_tpu_torch.ops import fused_mlp
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state

    gen = torch.Generator(device=dev).manual_seed(12)
    thetas = init_multichain_state(flat.theta, flat.eta, 1e-5, c, gen,
                                   jitter=0.01).theta.contiguous()
    ops, tail = fused_mlp._model_program(net.model, lik)
    vg = fused_mlp.make_fused_potential_vg(ops, net.train_x.shape[0], tail)
    sd_c = torch.ones(c, device=dev)
    x, y = net.train_x, net.train_y
    got = vg(thetas, sd_c, x, y)
    twin = fused_mlp.potential_plain(ops, thetas, sd_c, x, y, tail)
    oracle = fused_mlp.potential_plain(ops, thetas.double(), sd_c.double(),
                                       x.double(), y.double(), tail)
    torch.cuda.synchronize()
    errs = {}
    for name, out in (("K3", got), ("float32 twin", twin)):
        errs[name] = [(o.double() - w).abs().max().item()
                      for o, w in zip(out, oracle)]
    print(f"K3 Bernoulli tail at the He-init start (C={c}, N="
          f"{x.shape[0]}): max abs err against float64, ll / grad: K3 "
          f"{errs['K3'][0]:.3e} / {errs['K3'][1]:.3e}, float32 twin "
          f"{errs['float32 twin'][0]:.3e} / {errs['float32 twin'][1]:.3e}")
    for i, label in enumerate(("ll", "grad")):
        if errs["K3"][i] > 2.0 * errs["float32 twin"][i]:
            raise AssertionError(f"He-init start: K3's {label} is farther "
                                 f"from float64 than twice the twin's")
    return errs["K3"][1]


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


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(fn, reps=1):
    """Every event with a duration of ``reps`` calls of ``fn``, from a
    chrome trace of ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            return [e for e in json.load(f)["traceEvents"] if "dur" in e]


def device_events(fn, reps=1, events=None):
    """Device events (kernels and copies) of ``reps`` calls of ``fn``,
    from a chrome trace of ``torch.profiler`` (or of ``events``, one
    already taken)."""
    events = [e for e in (trace_events(fn, reps) if events is None
                          else events) if e.get("cat") in DEVICE_CATS]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    return events


#: the host's calls that put work on the card: kernel and graph launches,
#: copies and fills (the CUDA runtime's and the driver's names)
HOST_LAUNCH_NAMES = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")


def host_launches(events) -> int:
    """The host's calls in ``events`` that put work on the card."""
    return sum(1 for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and any(k in e.get("name", "") for k in HOST_LAUNCH_NAMES))


def host_launch_calls(events, reps=1) -> dict:
    """``host_launches`` by the call's name, a call of ``reps``."""
    calls = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and any(
                k in name for k in HOST_LAUNCH_NAMES):
            calls[name] = calls.get(name, 0) + 1
    return {k: v / reps for k, v in sorted(calls.items())}


def busy_ms(events) -> float:
    """Milliseconds in which the card ran any of ``events`` (the union of
    their intervals)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (busy + hi - lo) / 1e3


def device_ms(fn, reps=10):
    """Mean milliseconds per call on the card with the host's time taken
    out: the stream is held by a sleeping kernel while the host enqueues
    the calls, so they run back to back (a short K1 call's ``cuda_ms`` is
    its host's). The hold doubles until it outlasts the enqueueing."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 2


def predict_cell(dev, directory):
    """The JAX bench's predict cell (benchmarks/run_benchmarks.py:1196-
    1214): ``PREDICT_NETS`` flagship networks around a seed-0 init (sd
    0.05, numpy seed 0), stored as an npz store in ``directory``, and
    ``PREDICT_POINTS`` inputs from the same numpy generator. Returns the
    ``Predictor`` on ``dev``, the inputs and the model."""
    from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
        GaussianDenseLayer, Predictor, Sequential, Tanh
    from tensorbnn_tpu_torch.io import checkpoint
    from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
        host_unraveler

    model = Sequential([GaussianDenseLayer(1, 10), Tanh(),
                        GaussianDenseLayer(10, 10), Tanh(),
                        GaussianDenseLayer(10, 10), Tanh(),
                        GaussianDenseLayer(10, 1)])
    params, hypers = model.init(torch.Generator().manual_seed(0))
    flat = flatten_state(params, hypers, {})
    rng = np.random.default_rng(0)
    thetas = (flat.theta.numpy()[None] + 0.05 * rng.normal(
        size=(PREDICT_NETS, flat.theta.numel()))).astype(np.float32)
    hyper_samples = tuple(
        {k: np.broadcast_to(v.numpy(), (PREDICT_NETS,)) for k, v in
         h.items()} for h in hypers)
    checkpoint.save_samples(directory, host_unraveler(params)(thetas),
                            hyper_samples, {})
    with open(os.path.join(directory, "architecture.txt"), "w") as f:
        f.write("\n".join(model.layer_names) + "\n")
    pred = Predictor(directory, likelihood=FixedGaussianLikelihood(sd=0.1),
                     device=dev)
    x = rng.normal(size=(PREDICT_POINTS, 1)).astype(np.float32)
    return pred, x, model


def predict_routes(pred, x, mesh=None) -> dict:
    """The predict cell's ``Predictor.predict`` on its two routes on the
    card (over ``mesh``, None: none): the eager forward (``pred._eager``)
    and the graph route (the forward a replay of a captured graph after a
    key's first call), in the order eager, graph, graph again, eager
    again. For each: the first call's host ms (the graph's warm-up and
    capture, the first time), the reserved bytes it added and those still
    reserved after emptying the cache (a graph pool's), ``graphs.COUNTS``
    of that call and of ``PREDICT_REPS`` timed calls after it (no capture
    there, a replay an entry and call on the graph route), their host ms a
    call, and the forward's device ms. Raises unless the two routes'
    predictions are equal bit for bit."""
    from tensorbnn_tpu_torch.parallel import graphs

    x_dev = torch.as_tensor(x, device=pred.device)
    kw = {} if mesh is None else {"mesh": mesh}
    entries = 1 if mesh is None else len(mesh.devices) * len(mesh.devices[0])

    def forward():
        if mesh is None:
            return pred._forward(x_dev, 1)
        return pred._forward_sharded(x_dev, 1, mesh)

    out, got = {}, {}
    for label in ("eager", "graph", "graph again", "eager again"):
        route = label.split()[0]
        pred._eager = route == "eager"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        graphs.COUNTS.reset()
        t0 = time.perf_counter()
        got[label] = pred.predict(x, **kw)
        first_ms = 1e3 * (time.perf_counter() - t0)
        r1 = torch.cuda.memory_reserved()
        first = graphs.COUNTS.as_dict()
        torch.cuda.empty_cache()
        r2 = torch.cuda.memory_reserved()
        graphs.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PREDICT_REPS):
            pred.predict(x, **kw)
        host_ms = 1e3 * (time.perf_counter() - t0) / PREDICT_REPS
        timed = graphs.COUNTS.as_dict()
        out[label] = {"first_call_ms": first_ms, "first_call": first,
                      "reserved_added": r1 - r0,
                      "reserved_after_empty_cache": r2 - r0,
                      "host_ms": host_ms, "timed": timed,
                      "forward_device_ms": device_ms(forward)}
    pred._eager = False
    for label, pred_out in got.items():
        if not np.array_equal(pred_out.view(np.int32),
                              got["eager"].view(np.int32)):
            raise AssertionError(f"predict: the {label} route differs from "
                                 f"the eager route")
    want_first = {"graph": entries, "graph again": 0}
    for label, n_cap in want_first.items():
        first, timed = out[label]["first_call"], out[label]["timed"]
        if (first["captures"] != n_cap or first["warmups"] != n_cap
                or timed["captures"] or timed["warmups"]
                or timed["replays"] != PREDICT_REPS * entries):
            raise AssertionError(f"predict, {label}: {out[label]}")
    for label in ("eager", "eager again"):
        if out[label]["first_call"]["replays"] or out[label]["timed"][
                "replays"]:
            raise AssertionError(f"predict, {label}: {out[label]}")
    return out


def predict_phase(dev, directory, train_x, train_y, lik) -> dict:
    """Phase 7 (e): the JAX bench's predict cell, 2,000 networks x 4,096
    points, in ``directory``: ``predict_routes``; one capture of a new key
    by ``CudaGraph.segment`` (no preamble; the route's) and one through
    ``torch.cuda.graph`` (its preamble: a synchronize, ``gc.collect`` and
    emptying the cache); the forward's ms by events and its bound; the
    output's copy to pageable and to pinned host memory; the predictions
    against the same forward in float64; two ``train_probs`` calls (the
    first pays the card's first use of its kernels) and one ``reweight``
    (to Cauchy priors, the flagship's ``train_x``, ``train_y`` and
    ``lik``) of the cell's ensemble, eager. Returns the dict."""
    from tensorbnn_tpu_torch import CauchyDenseLayer, Tanh
    from tensorbnn_tpu_torch.parallel import graphs

    class PreambleGraph(graphs.CudaGraph):
        """``CudaGraph`` whose segments take ``torch.cuda.graph``'s
        preamble."""

        @classmethod
        def segment(cls, fn, device, pool):
            return cls(fn, None, device, pool=pool)

    pred, x, model = predict_cell(dev, directory)
    routes = predict_routes(pred, x)
    capture_ms = {}
    for label, graph_type, rows in (
            ("open/close", None, PREDICT_POINTS - 1),
            ("torch.cuda.graph preamble", PreambleGraph,
             PREDICT_POINTS - 2)):
        pred._graph_type = graph_type
        graphs.COUNTS.reset()
        pred.predict(x[:rows])
        capture_ms[label] = graphs.COUNTS.capture_seconds[0] * 1e3
    pred._graph_type = None
    got = pred.predict(x)
    x_dev = torch.as_tensor(x, device=dev)
    fwd_ms = cuda_ms(lambda: pred._forward(x_dev, 1))
    # the output's copy to the host: to pageable memory (the parent's) and
    # into a pinned buffer
    y_dev = pred.predict_tensor(x_dev)
    pinned = torch.empty(y_dev.shape, dtype=y_dev.dtype, pin_memory=True)
    copy_ms = {}
    for label, copy in (("pageable", lambda: y_dev.cpu()),
                        ("pinned", lambda: pinned.copy_(y_dev))):
        copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PREDICT_REPS):
            copy()
            torch.cuda.synchronize()
        copy_ms[label] = 1e3 * (time.perf_counter() - t0) / PREDICT_REPS
    # the predictions against the same forward in float64 on the card
    assert got.shape == (PREDICT_NETS, PREDICT_POINTS, 1)
    assert np.isfinite(got).all()
    ens64 = tuple({k: v.double() for k, v in p.items()}
                  for p in pred.ensemble(1))
    want = torch.func.vmap(model.apply, in_dims=(0, None))(
        ens64, torch.as_tensor(x, dtype=torch.float64, device=dev))
    err = float(np.abs(got - want.cpu().numpy()).max())
    assert err < 1e-5, err
    del ens64, want, y_dev, pinned
    # the reweighting pass, eager, one call each
    cauchy = [CauchyDenseLayer(1, 10), Tanh(), CauchyDenseLayer(10, 10),
              Tanh(), CauchyDenseLayer(10, 10), Tanh(),
              CauchyDenseLayer(10, 1)]
    reweight_ms = {}
    for label in ("train_probs", "train_probs again", "reweight"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "reweight":
            w = pred.reweight(cauchy, train_x, train_y, likelihood=lik)
        else:
            pred.train_probs(train_x, train_y, likelihood=lik)
        reweight_ms[label] = 1e3 * (time.perf_counter() - t0)
    assert w.shape == (PREDICT_NETS,) and np.isfinite(w).all(), w
    assert abs(float(w.sum()) - 1.0) < 1e-5, w.sum()
    n_pred = PREDICT_NETS * PREDICT_POINTS
    n_params = sum(v.numel() for p in pred.ensemble(1)
                   for v in p.values())
    pb = bound(n_pred * 2 * PREDICT_MACS,
               4 * (n_pred + n_params + PREDICT_POINTS))
    host_ms = routes["graph again"]["host_ms"]
    out = {"networks": PREDICT_NETS, "points": PREDICT_POINTS,
           "host_ms": host_ms,
           "eager_host_ms": routes["eager again"]["host_ms"],
           "forward_ms": fwd_ms,
           "forward_device_ms": routes["graph again"]["forward_device_ms"],
           "eager_forward_device_ms": routes["eager again"][
               "forward_device_ms"],
           "routes": routes, "capture_ms": capture_ms,
           "copy_to_host_ms": copy_ms["pageable"],
           "copy_to_pinned_ms": copy_ms["pinned"], "bound_ms": pb[0],
           "bound_by": pb[1],
           "predictions_per_sec": n_pred / (host_ms / 1e3),
           "forward_predictions_per_sec": n_pred / (
               routes["graph again"]["forward_device_ms"] / 1e3),
           "output_mb": got.nbytes / 1e6, "predict_max_abs_err": err,
           "reweighting_ms": reweight_ms}
    print(f"(e) predict, {PREDICT_NETS} networks x {PREDICT_POINTS} "
          f"points, graph route == eager route bit for bit: a call "
          f"{routes['eager']['host_ms']:.3f} / "
          f"{routes['eager again']['host_ms']:.3f} host-ms eager, "
          f"{routes['graph']['host_ms']:.3f} / "
          f"{routes['graph again']['host_ms']:.3f} on the graph (to numpy "
          f"through pinned memory, {got.nbytes / 1e6:.1f} MB), "
          f"{n_pred / (host_ms / 1e3):,.0f} network-predictions/sec; the "
          f"forward {routes['eager again']['forward_device_ms']:.4f} "
          f"device-ms eager, "
          f"{routes['graph again']['forward_device_ms']:.4f} a replay "
          f"({fwd_ms:.4f} ms by events), bound {pb[0]:.5f} ms ({pb[1]}); "
          f"first graph call {routes['graph']['first_call_ms']:.1f} ms "
          f"(capture {routes['graph']['first_call']['capture_ms']} ms; "
          f"another key's by open/close {capture_ms['open/close']:.1f} ms, "
          f"through torch.cuda.graph "
          f"{capture_ms['torch.cuda.graph preamble']:.1f} ms), pool "
          f"{routes['graph']['reserved_after_empty_cache'] / 1e6:.1f} MB "
          f"(reserved +{routes['graph']['reserved_added'] / 1e6:.1f} MB); "
          f"timed graph calls {routes['graph again']['timed']}; the copy "
          f"to the host {copy_ms['pageable']:.3f} host-ms pageable, "
          f"{copy_ms['pinned']:.3f} pinned; max abs err against float64 "
          f"{err:.3e}; the reweighting pass (eager, a call each) "
          f"{json.dumps(reweight_ms)} ms", flush=True)
    return out


def predict_mesh_phase(dev) -> dict:
    """Phase 11 (e): the predict cell on a 2x2 virtual mesh of ``dev``
    against the unsharded ``predict`` (within ``MESH_PREDICT_TOL``), and
    ``predict_routes`` without the mesh and on it, each on a Predictor of
    its own (so that each pool's bytes are its own). Returns the dict."""
    from tensorbnn_tpu_torch import FixedGaussianLikelihood, Predictor
    from tensorbnn_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp_dir:
        pred, xp, _ = predict_cell(dev, tmp_dir)
        sharded = Predictor(tmp_dir, likelihood=FixedGaussianLikelihood(
            sd=0.1), device=dev)
        m = make_mesh(2, 2, devices=[dev] * 4)
        routes = {"meshless": predict_routes(pred, xp),
                  "2x2": predict_routes(sharded, xp, m)}
        want = pred.predict(xp)
        got = sharded.predict(xp, mesh=m)
    diff = float(np.abs(got - want).max())
    out = {"networks": PREDICT_NETS, "points": PREDICT_POINTS,
           "bit_equal_to_meshless": bool((got == want).all()),
           "max_abs_diff": diff, "max_abs": float(np.abs(want).max()),
           "host_ms": {f"{mesh} {label}": r["host_ms"]
                       for mesh, rs in routes.items()
                       for label, r in rs.items()},
           "forward_device_ms": {f"{mesh} {label}": r["forward_device_ms"]
                                 for mesh, rs in routes.items()
                                 for label, r in rs.items()},
           "routes": routes}
    print(f"(e) the predict cell on 2x2, graph route == eager route bit "
          f"for bit: host-ms a call {json.dumps(out['host_ms'])}; forward "
          f"device-ms {json.dumps(out['forward_device_ms'])}; 2x2 first "
          f"graph call {routes['2x2']['graph']['first_call_ms']:.1f} ms "
          f"(captures {routes['2x2']['graph']['first_call']['capture_ms']}"
          f" ms), pool "
          f"{routes['2x2']['graph']['reserved_after_empty_cache'] / 1e6:.1f}"
          f" MB; against the unsharded predict max abs diff {diff:.3e}",
          flush=True)
    if got.shape != want.shape or diff > MESH_PREDICT_TOL * max(
            1.0, out["max_abs"]):
        raise AssertionError(f"predict on 2x2: {out}")
    return out


def store_phase(dev, reset_counts, read_counts) -> dict:
    """Phase 7: the sample store, resume and the Predictor on the card, at
    the flagship's full width over 64 chains (K1 (a) + K2). (a) a buffered
    run with ``folder_name`` and the same run streamed (``keep_samples=
    False``) write the same samples: each store (text, npz, streamed)
    loads to the run's ensemble bit for bit; (b) ``Predictor`` on the card
    reads the text store (``samples.npz`` moved aside) and the npz store,
    and its ``predict`` equals ``model.apply`` over the run's samples bit
    for bit; (c) a run stopped at a checkpoint (``checkpoint_every``) and
    resumed is the uninterrupted run, in samples, acceptance and store
    bytes; (d) ``reweight`` to Cauchy priors gives finite weights summing
    to 1, ``autocorrelation_length`` is finite and per chain; (e) the JAX
    bench's predict cell on both routes and the reweighting pass
    (``predict_phase``)."""
    from tensorbnn_tpu_torch import CauchyDenseLayer, Predictor, Tanh
    from tensorbnn_tpu_torch.io import fast_text
    from tensorbnn_tpu_torch.ops import _build
    from tensorbnn_tpu_torch.utils import autocorr

    out = {"native_text": fast_text.native_available()}
    print(f"native text store (fast_text.native_available()): "
          f"{out['native_text']}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        d = {k: os.path.join(tmp, k) for k in
             ("buffered", "streamed", "resumed", "ckpt", "aside", "predict")}

        def run(epochs, **kw):
            net, lik = flagship_network(dev)
            net.setup_mcmc(**RECIPE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = net.train(epochs, STORE_STEP, lik, n_chains=64,
                            networks_per_file=STORE_PER_FILE, verbose=False,
                            **kw)
            torch.cuda.synchronize()
            assert res.main_path == "K1" and res.fused_hyper, res.main_path
            return net, lik, res, time.perf_counter() - t0

        reset_counts()
        net, lik, res, out["buffered_s"] = run(STORE_EPOCHS,
                                               folder_name=d["buffered"])
        _, _, res_s, out["streamed_s"] = run(
            STORE_EPOCHS, folder_name=d["streamed"], keep_samples=False)
        _, _, res_1, out["interrupted_s"] = run(
            STORE_STOP, checkpoint_dir=d["ckpt"], checkpoint_every=5)
        _, _, res_r, out["resumed_s"] = run(
            STORE_EPOCHS, folder_name=d["resumed"], checkpoint_dir=d["ckpt"],
            checkpoint_every=5)
        out["launches"] = read_counts("store and resume (K1 + K2)")
        # one K1 launch an epoch: 400 + 400 + 300 + 100 epochs
        if (out["launches"]["K1"] != 3 * STORE_EPOCHS
                or out["launches"]["K2"] < 1 or out["launches"]["K3"]):
            raise AssertionError(f"the store runs did not take K1 (one "
                                 f"launch an epoch) + K2 alone: "
                                 f"{out['launches']}")

        # (a) two stores, one sample set
        n_nets = (STORE_EPOCHS - RECIPE["burnin"]) // STORE_STEP * 64
        assert res.theta_samples.shape[:2] == (n_nets // 64, 64)
        assert np.isfinite(res.theta_samples).all()
        assert res_s.theta_samples.shape[0] == 0
        np.testing.assert_array_equal(res_s.main_accept, res.main_accept)
        chains = np.repeat(np.arange(64), n_nets // 64)
        os.makedirs(d["aside"])
        os.replace(os.path.join(d["buffered"], "samples.npz"),
                   os.path.join(d["aside"], "samples.npz"))
        preds = {"text": Predictor(d["buffered"], likelihood=lik,
                                   device=dev)}
        os.replace(os.path.join(d["aside"], "samples.npz"),
                   os.path.join(d["buffered"], "samples.npz"))
        preds["npz"] = Predictor(d["buffered"], likelihood=lik, device=dev)
        preds["streamed"] = Predictor(d["streamed"], likelihood=lik,
                                      device=dev)
        for name, pred in preds.items():
            assert pred.n_networks == n_nets, (name, pred.n_networks)
            np.testing.assert_array_equal(pred.chain_index, chains)
            for got, want in zip(pred.param_samples, res.param_samples):
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
        print(f"(a) {n_nets} networks: the text, npz and streamed stores "
              f"load to the run's chain-major ensemble bit for bit "
              f"(buffered run {out['buffered_s']:.2f} s, streamed "
              f"{out['streamed_s']:.2f} s)")

        # (b) the Predictor on the card against model.apply over the run's
        # samples
        xs = torch.linspace(-2.0, 2.0, 101, device=dev)[:, None]
        ens = tuple({k: torch.as_tensor(v, device=dev) for k, v in p.items()}
                    for p in res.param_samples)
        want = torch.func.vmap(net.model.apply, in_dims=(0, None))(
            ens, xs).cpu().numpy()
        for name in ("text", "npz"):
            np.testing.assert_array_equal(preds[name].predict(xs), want)
        print(f"(b) Predictor(device='cuda').predict over the text and npz "
              f"stores equals model.apply over the run's samples bit for "
              f"bit ({want.shape})")

        # (c) resume at a chunk boundary
        assert res_1.n_epochs == STORE_STOP and res_r.resume_epoch == \
            STORE_STOP
        np.testing.assert_array_equal(res_r.theta_samples,
                                      res.theta_samples)
        np.testing.assert_array_equal(res_r.eta_samples, res.eta_samples)
        for field in ("main_accept", "hyper_accept", "sjd"):
            full = getattr(res, field)
            np.testing.assert_array_equal(getattr(res_1, field),
                                          full[:STORE_STOP])
            np.testing.assert_array_equal(getattr(res_r, field),
                                          full[STORE_STOP:])
        burnin = RECIPE["burnin"]
        np.testing.assert_array_equal(
            res_r.after_epoch(res_r.main_accept, burnin + 150),
            res.main_accept[burnin + 150:])
        names = sorted(n for n in os.listdir(d["buffered"])
                       if n.endswith(".txt"))
        for n in names:
            with open(os.path.join(d["buffered"], n), "rb") as f_a, \
                    open(os.path.join(d["resumed"], n), "rb") as f_b:
                assert f_a.read() == f_b.read(), n
        out["post_burnin_main_accept"] = float(
            res.after_epoch(res.main_accept, burnin).mean())
        print(f"(c) stopped at epoch {STORE_STOP} by checkpoint_every and "
              f"resumed: samples, acceptance (post-burn-in main "
              f"{out['post_burnin_main_accept']:.4f}) and the {len(names)} "
              f"text files bit-equal to the uninterrupted run")

        # (d) diagnostics
        pred = preds["npz"]
        cauchy = [CauchyDenseLayer(1, 10), Tanh(), CauchyDenseLayer(10, 10),
                  Tanh(), CauchyDenseLayer(10, 10), Tanh(),
                  CauchyDenseLayer(10, 1)]
        w = pred.reweight(cauchy, net.train_x, net.train_y, likelihood=lik)
        assert w.shape == (n_nets,) and np.isfinite(w).all(), w
        assert abs(float(w.sum()) - 1.0) < 1e-5, w.sum()
        xq = xs[::10]
        tau = pred.autocorrelation_length(xq, 1000)
        blocks = pred._chain_blocks()
        assert len(blocks) == 64
        series = pred.predict(xq)[..., 0].T
        taus = np.concatenate([autocorr.integrated_time_batch(
            series[:, a:b]) for a, b in blocks])
        assert np.isfinite(tau) and tau == float(
            taus[~np.isnan(taus)].mean()), tau
        out["reweight_ess"] = float(1.0 / np.sum(w.astype(np.float64) ** 2))
        out["tau_per_chain"] = tau
        print(f"(d) reweight to Cauchy priors: finite, sum "
              f"{float(w.sum()):.7f}, ESS {out['reweight_ess']:.2f} of "
              f"{n_nets}; autocorrelation length {tau:.4f} (per chain, "
              f"{len(blocks)} chains)")

        # (e) the predict cell on both routes, and the reweighting pass
        out["predict"] = predict_phase(dev, d["predict"], net.train_x,
                                       net.train_y, lik)
        del preds, pred, ens, want
    print(json.dumps({"store": out}), flush=True)
    return out


def host_loss(out, x, y, classification, tanh=False):
    """The pretraining loss of returned parameters ``(weights, biases,
    activations)`` (leaky relu at the activations' slopes, or tanh) over
    ``(x, y)``, in float64 on the host."""
    w, b, a = out
    h = np.asarray(x, np.float64)
    for i in range(len(w)):
        h = h @ np.asarray(w[i], np.float64).T + np.asarray(
            b[i], np.float64).reshape(-1)
        if i < len(w) - 1:
            h = np.tanh(h) if tanh else np.where(
                h < 0, np.asarray(a[i], np.float64) * h, h)
    y = np.asarray(y, np.float64).reshape(h.shape)
    if not classification:
        return float(np.mean((h - y) ** 2))
    p = np.clip(1.0 / (1.0 + np.exp(-h)), 1e-7, 1 - 1e-7)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log1p(-p)))


def first_difference(got, want):
    """The first of two ``(weights, biases, activations)`` results whose
    arrays differ in their bits, as ``(name, largest difference)``, or
    None."""
    for part, g_list, w_list in zip(("weights", "biases", "activations"),
                                    got, want):
        for i, (g, w) in enumerate(zip(g_list, w_list)):
            g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
            if not np.array_equal(g.view(np.uint32), w.view(np.uint32)):
                return (f"{part}[{i}]", float(np.max(np.abs(
                    g.astype(np.float64) - w))))
    return None


class EpochClock:
    """A pretraining epoch hook: each epoch's validation loss and the host
    clock after it (the loss was read from the card, so the epoch's work
    is done); with ``profiled=(first, n)``, ``torch.profiler`` records
    epochs ``first`` to ``first + n - 1`` (from 0) into ``events``."""

    def __init__(self, profiled=None):
        self.vals, self.times, self.events = [], [time.perf_counter()], None
        self.profiled, self.prof = profiled, None

    def __call__(self, val: float) -> None:
        self.vals.append(val)
        self.times.append(time.perf_counter())
        if self.profiled is None:
            return
        first, n = self.profiled
        if len(self.vals) == first:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        elif len(self.vals) == first + n:
            torch.cuda.synchronize()
            self.prof.stop()
            with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
                path = os.path.join(tmp, "trace.json")
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = [e for e in json.load(f)["traceEvents"]
                                   if "dur" in e]

    def epoch_s(self, first: int) -> list:
        """The seconds of each epoch from ``first`` on."""
        return list(np.diff(self.times)[first:])


#: pretraining's steady epochs start at the third: the graph path's first
#: is its warm-up, its second holds the capture
PRETRAIN_STEADY_FROM = 2


def pretrain_runners(label, run, epochs, n_batches, card) -> tuple:
    """One cycle of ``epochs`` epochs at one shape through the eager epoch
    and the graph of a step: ``run(epochs, eager, hook)`` calls
    ``_train_mlp`` with the shape's configuration and ``epoch_hook=hook``.
    Raises unless the two give the same bits (every returned array, every
    epoch's validation loss, the epochs run). For each runner: the call's
    seconds, its capture's seconds, the seconds of each steady epoch (from
    the third: the graph's first is its warm-up and its second holds the
    capture; the host clock between epochs) and, from ``torch.profiler``
    over two steady epochs of a 4-epoch call, a steady epoch's device ms
    (the sum of its device events; the six largest by name), device ops,
    host launches (kernel and graph launches, copies and fills) and idle
    share (1 - device ms / the mean steady epoch). Returns the rows and
    the graph runner's result."""
    from tensorbnn_tpu_torch.parallel import graphs

    row, results = {"epochs": epochs, "steps_per_epoch": n_batches}, {}
    for kind in ("eager", "graph"):
        eager = kind == "eager"
        graphs.COUNTS.reset()
        clock = EpochClock()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(epochs, eager, clock)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        counts = graphs.COUNTS.as_dict()
        results[kind] = (res, clock.vals)
        steady = clock.epoch_s(PRETRAIN_STEADY_FROM)
        epoch_s = float(np.mean(steady))
        prof = EpochClock(profiled=(PRETRAIN_STEADY_FROM, 2))
        run(PRETRAIN_STEADY_FROM + 2, eager, prof)
        dev_events = device_events(None, events=prof.events)
        device_s = sum(float(e["dur"]) for e in dev_events) / 2e6
        # a steady epoch's device time by kernel or copy
        top = {}
        for e in dev_events:
            ms, n = top.get(e["name"][:60], (0.0, 0))
            top[e["name"][:60]] = (ms + float(e["dur"]) / 2e3, n + 0.5)
        row[kind] = {
            "call_s": call_s, "epoch_s": epoch_s, "steady_epoch_s": steady,
            "first_epochs_s": clock.epoch_s(0)[:PRETRAIN_STEADY_FROM],
            "steps_per_sec": n_batches / epoch_s,
            "device_ms_per_epoch": 1e3 * device_s,
            "idle_share": 1.0 - device_s / epoch_s,
            "host_launches_per_epoch": host_launches(prof.events) / 2,
            "device_ops_per_epoch": len(dev_events) / 2,
            "captures": counts["captures"],
            "capture_s": [ms / 1e3 for ms in counts["capture_ms"]],
            "top_device_ms_and_ops_per_epoch": [
                [name, ms, n] for name, (ms, n) in sorted(
                    top.items(), key=lambda kv: -kv[1][0])[:6]]}
        r = row[kind]
        print(f"pretraining, {label}, {kind} epochs: the call "
              f"({epochs} epochs) {call_s:.4f} s, the set-up and first "
              f"epoch, the second "
              f"{', '.join(f'{t:.4f}' for t in r['first_epochs_s'])} s, "
              f"captures {r['captures']} "
              f"({', '.join(f'{t:.4f}' for t in r['capture_s']) or '-'} s);"
              f" a steady epoch {epoch_s:.4f} s ({min(steady):.4f}-"
              f"{max(steady):.4f}; {r['steps_per_sec']:,.1f} optimizer "
              f"steps/sec), device {r['device_ms_per_epoch']:.3f} ms in "
              f"{r['device_ops_per_epoch']:.1f} ops, idle share "
              f"{r['idle_share']:.4f}, {r['host_launches_per_epoch']:.1f} "
              f"host launches ({card})", flush=True)
    (g_res, g_vals), (e_res, e_vals) = results["graph"], results["eager"]
    diff = first_difference(g_res, e_res)
    if diff is not None or g_vals != e_vals:
        raise AssertionError(
            f"pretraining, {label}: the graph and the eager epochs differ: "
            f"first differing tensor {diff}; validation losses graph "
            f"{g_vals}, eager {e_vals}")
    if row["graph"]["captures"] != 1 or row["eager"]["captures"]:
        raise AssertionError(f"pretraining, {label}: expected one capture "
                             f"on the graph path alone: {row}")
    row["bit_equal"], row["val_losses"] = True, g_vals
    print(f"pretraining, {label}: graph and eager epochs bit-equal over "
          f"{len(g_vals)} epochs (weights, biases, slopes, each epoch's "
          f"validation loss, the last {g_vals[-1]:.8f}) ({card})",
          flush=True)
    return row, g_res


def tutorial_pretrain_data():
    """The tutorial's pretraining data: the tutorial-shaped rows and
    labels, and the validation rows (MNIST's other 20% of 3s and 8s,
    default_rng(15)) labelled by the same plane."""
    tx, ty, plane = tutorial_data()
    vx = np.random.default_rng(15).uniform(
        size=(TUTORIAL_VAL_ROWS, 784)).astype(np.float32)
    vy = ((vx - 0.5) @ plane > 0).astype(np.float32)
    return tx, ty, vx, vy


def pretrain_shapes(dev, x, y) -> list:
    """Phase 9 (a)'s two shapes at one cycle, each ``(label, run, epochs,
    steps an epoch)``: ``run(epochs, eager, hook, device=dev, **kw)`` calls
    ``_train_mlp`` as ``train_basic_regression`` calls it for the JAX
    bench's surrogate pretraining (over the surrogate's ``(x, y)``) and
    as ``train_basic_classification`` calls it for the tutorial's first
    cycle, with ``eager``, ``epoch_hook=hook`` and ``kw`` (such as a
    ``graph_type``). The init is drawn on the host from the seed: the
    same on every device."""
    from tensorbnn_tpu_torch.training import pretrain

    def surrogate(epochs, eager, hook, device=dev, **kw):
        return pretrain._train_mlp(
            2, SURROGATE_IN, 1, SURROGATE_WIDTH, 1, epochs, 0.1, x, y,
            x[:4096], y[:4096], classification=False, base_lr=0.01,
            batch_size=SURROGATE_BATCH, callbacks=False,
            hidden_activation="tanh", device=device, eager=eager,
            epoch_hook=hook, **kw)

    tx, ty, vx, vy = tutorial_pretrain_data()

    def tutorial(epochs, eager, hook, device=dev, **kw):
        return pretrain._train_mlp(
            2, 784, 1, 20, 1, epochs, 0.1, tx, ty, vx, vy,
            classification=True, base_lr=0.001, patience=10,
            train_slopes=True, device=device, eager=eager, epoch_hook=hook,
            **kw)

    return [(f"surrogate {SURROGATE_POINTS:,} x {SURROGATE_IN}, 2 x "
             f"{SURROGATE_WIDTH} tanh, batch {SURROGATE_BATCH}", surrogate,
             SURROGATE_EPOCHS, SURROGATE_POINTS // SURROGATE_BATCH),
            (f"tutorial {TUTORIAL_ROWS:,} x 784, 20-20 leaky relu with "
             f"slopes, batch 32, first cycle", tutorial, TUTORIAL_EPOCHS,
             TUTORIAL_ROWS // 32)]


def pretrain_phase(dev, card, x, y, reset_counts, read_counts) -> tuple:
    """Phase 9: MAP pretraining, the tensorBNN shim and the examples on the
    card, from generators of its own. (a) pretraining at the JAX bench's
    surrogate shape and at the tutorial's first cycle through the eager
    epochs and the graph of a step, held bit for bit and timed
    (``pretrain_runners``), then the configured calls through the public
    entry points (one capture each), the tutorial's first cycle held
    against the same call on the CPU (same init, same batches); (b)
    ``extended_regression --smoke`` and ``classification --smoke``
    through their ``main`` on the card, their
    launches counted and their figures held against the JAX examples'; (c)
    the tutorial-shaped BNN warm-started from (a)'s weights and slopes, on
    K3; (d) the reference-style shim script (the JAX shim's test script
    with its import prefix changed) and its ``predictor`` on the card.
    ``(x, y)`` is the surrogate's data (``surrogate_data``). Returns the
    statistics and the surrogate's pretrained ``(weights, biases,
    activations)``, phase 10's warm start."""
    from tensorbnn_tpu_torch.examples import classification, \
        extended_regression
    from tensorbnn_tpu_torch.ops import _build
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.training import pretrain

    out = {"card": card}

    # (a) one cycle of each shape through both runners, then the
    # configured calls through the public entry points (graphs)
    (s_label, surrogate, s_epochs, s_steps), \
        (t_label, tutorial, t_epochs, t_steps) = pretrain_shapes(dev, x, y)
    out["surrogate"], res = pretrain_runners(s_label, surrogate, s_epochs,
                                             s_steps, card)
    graphs.COUNTS.reset()
    surrogate_warm = surrogate_pretrain(dev, x, y)
    if first_difference(surrogate_warm, res) or graphs.COUNTS.captures != 1:
        raise AssertionError("the surrogate's pretraining through "
                             "train_basic_regression is not the graph "
                             "runner's")
    # the fit against the data's noise floor (sd 0.1: an MSE of 0.01)
    out["surrogate"]["val_mse"] = host_loss(res, x[:4096], y[:4096], False,
                                            tanh=True)
    print(f"surrogate pretraining: validation MSE "
          f"{out['surrogate']['val_mse']:.5f} ({card})")

    tx, ty, vx, vy = tutorial_pretrain_data()
    out["tutorial"], card_res = pretrain_runners(t_label, tutorial, t_epochs,
                                                 t_steps, card)
    # the configured call (3 cycles) through the public entry point
    graphs.COUNTS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = pretrain.train_basic_classification(
        2, 784, 1, 20, TUTORIAL_CYCLES, TUTORIAL_EPOCHS, 0.1, tx, ty, vx, vy,
        patience=10, train_slopes=True, device=dev)
    torch.cuda.synchronize()
    call = {"call_s": time.perf_counter() - t0, **graphs.COUNTS.as_dict()}
    out["tutorial"]["configured_call"] = call
    print(f"tutorial pretraining through train_basic_classification, "
          f"{TUTORIAL_CYCLES} x {TUTORIAL_EPOCHS} epochs: "
          f"{call['call_s']:.3f} s, {call['captures']} capture "
          f"({call['capture_ms']} ms), {call['replays']} replays ({card})",
          flush=True)
    if call["captures"] != 1 or call["warmups"] != 1:
        raise AssertionError(f"the tutorial's call: expected one warm-up "
                             f"and one capture: {call}")
    # the first cycle on the card (the graph's) and on the CPU
    t0 = time.perf_counter()
    cpu_res = tutorial(t_epochs, False, None, device="cpu")
    first = {"card": {"wall_s": out["tutorial"]["graph"]["call_s"]},
             "cpu": {"wall_s": time.perf_counter() - t0}}
    for label, res in (("card", card_res), ("cpu", cpu_res)):
        first[label].update(train_loss=host_loss(res, tx, ty, True),
                            val_loss=host_loss(res, vx, vy, True))
        assert all(np.isfinite(a).all() for part in res for a in part)
    card_first, cpu_first = first["card"], first["cpu"]
    rel = {k: abs(card_first[k] - cpu_first[k]) / abs(cpu_first[k])
           for k in ("train_loss", "val_loss")}
    out["tutorial_first_cycle"] = {"card": card_first, "cpu": cpu_first,
                                   "rel_diff": rel}
    print(f"tutorial pretraining, first cycle ({TUTORIAL_EPOCHS} epochs) "
          f"from the same init and batches: train / validation loss card "
          f"{card_first['train_loss']:.8f} / {card_first['val_loss']:.8f} "
          f"({card_first['wall_s']:.2f} s), CPU "
          f"{cpu_first['train_loss']:.8f} / {cpu_first['val_loss']:.8f} "
          f"({cpu_first['wall_s']:.2f} s); relative differences "
          f"{rel['train_loss']:.3e} / {rel['val_loss']:.3e} (tolerance "
          f"{PRETRAIN_LOSS_RTOL}) ({card})", flush=True)
    if max(rel.values()) > PRETRAIN_LOSS_RTOL:
        raise AssertionError(f"tutorial pretraining: the card's losses are "
                             f"off the CPU's: {first}")
    out["tutorial"].update(train_loss=host_loss(warm, tx, ty, True),
                           val_loss=host_loss(warm, vx, vy, True))

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        # (b) the two examples through their main on the card
        examples = {}
        for name, module, want in (
                ("extended_regression", extended_regression,
                 {"K1": 800, "K2": 800, "K3": 0}),
                ("classification", classification,
                 {"K1": 500, "K2": 0, "K3": 0})):
            reset_counts()
            t0 = time.perf_counter()
            stats = module.main(["--smoke", "--folder",
                                 os.path.join(tmp, name)])
            torch.cuda.synchronize()
            stats["main_wall_s"] = time.perf_counter() - t0
            stats["launches"] = read_counts(f"{name} --smoke")
            examples[name] = stats
            if stats["main_path"] != "K1" or stats["launches"] != want:
                raise AssertionError(f"{name} --smoke did not run on "
                                     f"{want} launches: {stats}")
        rmse = examples["extended_regression"]["grid_rmse"]
        acc = examples["classification"]["accuracy"]
        rmse_max = EXAMPLE_RMSE_FACTOR * JAX_EXAMPLE_REF[
            "extended_regression"]
        acc_min = JAX_EXAMPLE_REF["classification"] - EXAMPLE_ACCURACY_DROP
        print(f"examples --smoke on the card: extended_regression grid RMSE "
              f"{rmse:.4f} (JAX example {JAX_EXAMPLE_REF['extended_regression']}"
              f", gate <= {rmse_max:.4f}), "
              f"{examples['extended_regression']['main_wall_s']:.2f} s; "
              f"classification posterior-ensemble validation accuracy "
              f"{acc:.3f} (JAX example {JAX_EXAMPLE_REF['classification']}, "
              f"gate >= {acc_min:.3f}), "
              f"{examples['classification']['main_wall_s']:.2f} s ({card})",
              flush=True)
        out["examples"] = examples
        if rmse > rmse_max or acc < acc_min:
            raise AssertionError(f"examples off the JAX examples' figures: "
                                 f"{examples}")

        # (c) the tutorial-shaped BNN warm-started from (a)
        tnet, tlik = tutorial_network(dev, warm=warm)
        params, _ = tnet.init_state()
        np.testing.assert_array_equal(params[0]["w"].cpu().numpy(),
                                      warm[0][0].T)
        tnet.setup_mcmc(burnin=3, step_size_start=1e-3, step_size_min=1e-3,
                        step_size_max=1e-3, leapfrog_start=20,
                        leapfrog_min=20, leapfrog_max=20, hyper_leapfrog=30,
                        hyper_step_size=1e-5, averaging_steps=10)
        reset_counts()
        tres = tnet.train(6, 1, tlik, n_chains=64, chain_jitter=0.01,
                          verbose=False)
        counts = read_counts("warm-started tutorial-shaped model (K3)")
        out["warm_tutorial"] = {
            "main_path": tres.main_path, "launches": counts,
            "main_accept": tres.main_accept.tolist(),
            "train_accuracy": train_accuracy(tnet, tres),
            "wall_s": tres.wall_time}
        print(f"warm-started tutorial-shaped BNN: main_path "
              f"{tres.main_path!r}, K3 launches {counts['K3']}, main "
              f"acceptance {np.round(tres.main_accept, 4).tolist()}, "
              f"training accuracy of the posterior mean "
              f"{out['warm_tutorial']['train_accuracy']:.4f}, "
              f"{tres.wall_time:.2f} s ({card})", flush=True)
        if (tres.main_path != "K3" or counts["K3"] != 6 * 21
                or counts["K1"] or counts["K2"]):
            raise AssertionError(f"warm-started tutorial: expected K3 "
                                 f"alone, 126 launches: {out['warm_tutorial']}")
        assert np.isfinite(tres.theta_samples).all()
        del tnet, tres

        # (d) the reference-style shim script, its import prefix changed
        folder = os.path.join(tmp, "TrigRegression")
        reset_counts()
        net = reference_shim_script(folder)
        shim_counts = read_counts("reference-style shim script")
        from tensorbnn_tpu_torch.tensorBNN.likelihood import \
            FixedGaussianLikelihood
        from tensorbnn_tpu_torch.tensorBNN.predictor import predictor
        pred = predictor(folder + "/", likelihood=FixedGaussianLikelihood(
            sd=0.1))
        train_in = np.linspace(-2, 2, num=11)
        results = pred.predict(train_in[:, None], n=1)
        assert isinstance(results, list) and all(
            r.shape == (1, 11) for r in results), [r.shape for r in results]
        assert np.isfinite(np.stack(results)).all()
        tau = pred.autoCorrelationLength(train_in[:, None], 50)
        assert np.isfinite(tau), tau
        mats = pred.extractParameters()
        own = net.results.param_samples
        dense = [i for i, p in enumerate(own) if "w" in p]
        assert len(mats) == 2 * len(dense)
        for j, i in enumerate(dense):
            np.testing.assert_array_equal(mats[2 * j],
                                          np.swapaxes(own[i]["w"], -1, -2))
            np.testing.assert_array_equal(mats[2 * j + 1],
                                          own[i]["b"][..., None])
        out["shim"] = {"networks": len(results), "tau": tau,
                       "launches": shim_counts,
                       "main_path": net.results.main_path}
        print(f"reference-style shim script on the card: {len(results)} "
              f"networks, predict -> list of {results[0].shape} arrays, "
              f"autoCorrelationLength {tau:.4f}, extractParameters equal "
              f"to the run's samples bit for bit; launches {shim_counts} "
              f"({card})", flush=True)
        if shim_counts["K1"] != 120 or shim_counts["K3"]:
            raise AssertionError(f"shim script: expected K1 once an epoch: "
                                 f"{shim_counts}")
        del pred, net
    print(json.dumps({"pretrain": out}), flush=True)
    return out, surrogate_warm


def reference_shim_script(folder):
    """The reference-style script of tests/test_compat_shim.py:11-59 with
    its import prefix changed to ``tensorbnn_tpu_torch.``; runs on the card
    (the shim's default device). Returns its network."""
    from tensorbnn_tpu_torch.tensorBNN.activationFunctions import Tanh
    from tensorbnn_tpu_torch.tensorBNN.layer import GaussianDenseLayer
    from tensorbnn_tpu_torch.tensorBNN.networkFinal import network
    from tensorbnn_tpu_torch.tensorBNN.likelihood import \
        FixedGaussianLikelihood
    from tensorbnn_tpu_torch.tensorBNN.metrics import SquaredError, \
        PercentError

    trainIn = np.linspace(-2, 2, num=11)
    valIn = np.linspace(-2 + 2 / 30, 2.0 - 2 / 30, num=30)
    trainOut = np.sin(trainIn * math.pi * 2) * trainIn \
        - np.cos(trainIn * math.pi)
    valOut = np.sin(valIn * math.pi * 2) * valIn - np.cos(valIn * math.pi)
    dtype = np.float32

    likelihood = FixedGaussianLikelihood(sd=0.1)
    metricList = [SquaredError(mean=0, sd=1), PercentError(mean=0, sd=1)]

    neuralNet = network(dtype, 1, trainIn, trainOut.T, valIn, valOut.T)
    seed = 1000
    neuralNet.add(GaussianDenseLayer(1, 10, seed=seed, dtype=dtype))
    neuralNet.add(Tanh())
    neuralNet.add(GaussianDenseLayer(10, 10, seed=seed + 1000, dtype=dtype))
    neuralNet.add(Tanh())
    neuralNet.add(GaussianDenseLayer(10, 1, seed=seed + 2000, dtype=dtype))

    neuralNet.setupMCMC(
        stepSizeStart=1e-3, stepSizeMin=1e-4, stepSizeMax=1e-2,
        stepSizeOptions=20, leapfrogStart=30, leapfogMin=10,
        leapFrogMax=60, leapfrogIncrement=2, hyperStepSize=0.001,
        hyperLeapfrog=15, burnin=40, cores=4, averagingSteps=5,
        randomSteps=3)

    neuralNet.train(
        120, 4, likelihood, metricList=metricList, adjustHypers=True,
        folderName=folder, networksPerFile=10, displaySkip=60)
    return neuralNet


def surrogate_data():
    """The JAX bench's surrogate data (benchmarks/run_benchmarks.py:406-
    410): 1M x 8 N(0, 1) points from default_rng(1), y = sin(sum x) + 0.1
    N(0, 1)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(SURROGATE_POINTS, SURROGATE_IN)).astype(np.float32)
    y = (np.sin(x.sum(axis=1)) + 0.1 * rng.normal(
        size=SURROGATE_POINTS)).astype(np.float32)
    return x, y


def surrogate_pretrain(dev, x, y, cycles=1, epochs=SURROGATE_EPOCHS):
    """The surrogate's MAP pretraining (phase 9 (a)'s configuration):
    ``(weights, biases, activations)``."""
    from tensorbnn_tpu_torch.training import pretrain
    return pretrain.train_basic_regression(
        2, SURROGATE_IN, 1, SURROGATE_WIDTH, cycles=cycles, epochs=epochs,
        alpha=0.1, train_in=x, train_out=y, val_in=x[:4096],
        val_out=y[:4096], batch_size=SURROGATE_BATCH, callbacks=False,
        hidden_activation="tanh", device=dev)


def repo_file(path: str) -> str:
    """``path`` (relative to the checkout's root) as an absolute path."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), path)


def surrogate_dims() -> list:
    """The surrogate's layer widths, input to output."""
    return [SURROGATE_IN, SURROGATE_WIDTH, SURROGATE_WIDTH, 1]


def flat_warm_start(weights, biases) -> np.ndarray:
    """Pretrained ``(W (out, in), b)`` per dense layer as one float32
    vector in ``SURR_WARM_START``'s order."""
    return np.concatenate([np.ravel(np.asarray(a, np.float32))
                           for wb in zip(weights, biases) for a in wb])


def surrogate_jax_warm_start():
    """The committed JAX warm start (``SURR_WARM_START``) as ``(weights,
    biases, activations)`` in ``train_basic_regression``'s layout (W (out,
    in), b (out, 1), no activations: the hidden layers are tanh)."""
    flat = np.load(repo_file(SURR_WARM_START))
    dims, weights, biases, at = surrogate_dims(), [], [], 0
    for a, o in zip(dims[:-1], dims[1:]):
        weights.append(flat[at:at + o * a].reshape(o, a))
        biases.append(flat[at + o * a:at + o * a + o].reshape(o, 1))
        at += o * a + o
    if at != flat.size:
        raise ValueError(f"{SURR_WARM_START}: {flat.size} numbers, the "
                         f"surrogate's layers take {at}")
    return weights, biases, []


def surrogate_equilibrium() -> tuple:
    """``SURR_EQUILIBRIUM`` as ``(theta (4, D), eta (4, H))``."""
    rows = np.load(repo_file(SURR_EQUILIBRIUM))
    d = sum(a * b + b for a, b in zip(surrogate_dims()[:-1],
                                      surrogate_dims()[1:]))
    return rows[:, :d], rows[:, d:]


def ladder_mcmc(eps: float, steps: int) -> dict:
    """``setup_mcmc``'s keywords for a ladder rung: the surrogate's, the
    step grid and the leapfrog options one point, burn-in
    ``LADDER_BURNIN``."""
    return dict(SURR_MCMC, step_size_start=eps, step_size_min=eps,
                step_size_max=eps, leapfrog_start=steps, leapfrog_min=steps,
                leapfrog_max=steps, burnin=LADDER_BURNIN)


def moons_ladder_mcmc(eps: float, steps: int) -> dict:
    """``setup_mcmc``'s keywords for a rung of the moons ladder:
    ``MOONS_MCMC`` with the step grid and the leapfrog options one
    point."""
    return dict(MOONS_MCMC, step_size_start=eps, step_size_min=eps,
                step_size_max=eps, leapfrog_start=steps, leapfrog_min=steps,
                leapfrog_max=steps)


def ladder_figures(accept, eta=None) -> dict:
    """A ladder run's figures from its per-epoch, per-chain main accept
    probabilities ``(E, C)`` and etas ``(E, C, H)``: the mean accept
    probability, its standard error over chains (each chain's mean over
    the epochs), each chain's mean, and, given ``eta``, the learned sd
    (``eta[..., -1] ** 2``) over every chain and epoch."""
    per_chain = np.asarray(accept, np.float64).mean(axis=0)
    out = {"main_accept": float(per_chain.mean()),
           "main_accept_se": float(per_chain.std(ddof=1)
                                   / math.sqrt(per_chain.size)),
           "main_accept_chain": per_chain.tolist()}
    if eta is not None:
        out["learned_sd"] = float(np.mean(np.asarray(eta, np.float64)[..., -1]
                                          ** 2))
    return out


def surrogate_network(dev, x, y, warm, burnin, precision=None, seed=3):
    """The bench's ``_surrogate_net`` (run_benchmarks.py:445-455) on
    ``dev``: 8-64-64-1 tanh Gaussian dense layers warm-started from
    ``warm``, Network seed ``seed`` (the bench's 3), the first 256 rows as
    validation, ``SURR_MCMC`` with ``burnin``; with the learned-sd
    ``GaussianLikelihood(sd=0.1)``."""
    from tensorbnn_tpu_torch import GaussianDenseLayer, GaussianLikelihood, \
        Network, Tanh
    from tensorbnn_tpu_torch.training.pretrain import dense_warm_start

    w, b, _ = warm
    net = Network(torch.float32, SURROGATE_IN, x, y, x[:256], y[:256],
                  seed=seed, device=dev)
    dims = surrogate_dims()
    for i in range(3):
        net.add(GaussianDenseLayer(dims[i], dims[i + 1],
                                   matmul_precision=precision),
                parameters=dense_warm_start(w, b, i))
        if i < 2:
            net.add(Tanh())
    net.setup_mcmc(burnin=burnin, **SURR_MCMC)
    return net, GaussianLikelihood(sd=0.1)


def surrogate_runner(net, lik, flat, model, data_chunk, compensated,
                     eager=False, n_chains=None, mesh=None):
    """The chunk runner ``sample_posterior`` builds for the surrogate on
    the plain path (``model`` with the preset's precisions), over
    ``mesh`` when given: the stepped runner on the card, unless
    ``eager``."""
    from tensorbnn_tpu_torch.parallel.chains import \
        make_multichain_chunk_runner
    return make_multichain_chunk_runner(
        model, lik, net.train_x, net.train_y, flat.unravel_theta,
        flat.unravel_eta, adjust_hypers=True,
        hyper_leapfrog=SURR_MCMC["hyper_leapfrog"],
        burnin=float(net.config.burnin),
        hyper_step_size_init=SURR_MCMC["hyper_step_size"],
        eta_dim=flat.eta.numel(), data_chunk=data_chunk,
        compensated=compensated, eager=eager, n_chains=n_chains, mesh=mesh)


def last_state(res, dev, c=None):
    """The last recorded ``(thetas (c, D), etas (c, H))`` of a run."""
    c = c or res.theta_samples.shape[1]
    return (torch.tensor(res.theta_samples[-1, :c], device=dev),
            torch.tensor(res.eta_samples[-1, :c], device=dev))


def route_errors(got, want) -> dict:
    """``got``'s value and gradient against ``want``'s: the value's
    largest relative error and the gradient's largest error over its
    largest entry."""
    gmax = float(want[1].abs().max())
    return {"value_rel": float(((got[0].double() - want[0].double()).abs()
                                / want[0].double().abs()).max()),
            "grad_over_max": float((got[1].double() - want[1].double())
                                   .abs().max()) / gmax}


def k3_route(net, lik, flat, thetas, etas, data_chunk, reset_counts,
             library=False) -> dict:
    """The main block's K3 route at the surrogate's 1M rows, built as the
    driver builds it (over ``data_chunk``-row chunks, or unchunked with
    None), at ``thetas``, ``etas``: its calls an evaluation, ms an
    evaluation (CUDA events), a call's workspace bytes, one evaluation's
    peak memory above what was held before, and its ``(value, grad)``
    under ``out``; with ``library``, also the ms of K3's cuBLAS twin
    (``potential_plain``: baddbmm and bmm, TF32 off) over the same row
    chunks (the likelihood's value and gradient a chunk, not summed)."""
    from tensorbnn_tpu_torch.ops import fused_mlp
    vg = fused_mlp.try_build_fused_main_vg(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, net.train_x,
        net.train_y, flat.eta.numel(), data_chunk=data_chunk)
    args = (thetas, etas, net.train_x, net.train_y)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got = vg(*args)
    torch.cuda.synchronize()
    out = {"launches_per_eval": fused_mlp.fused_potential.LAUNCHES,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
           "workspace_bytes": vg.workspace_bytes(thetas.shape[0]),
           "ms": cuda_ms(lambda: vg(*args), reps=3), "out": got}
    if library:
        ops = fused_mlp._model_program(net.model, lik)[0]
        n = net.train_x.shape[0]
        chunk = data_chunk or n
        sd_c = etas[:, -1] ** 2

        def twin():
            return [fused_mlp.potential_plain(
                ops, thetas, sd_c, net.train_x[i:i + chunk],
                net.train_y[i:i + chunk]) for i in range(0, n, chunk)]
        out["library_ms"] = cuda_ms(twin, reps=3)
    return out


def wide_fleet_cell(dev, card, x, y, warm, flat, reset_counts,
                    read_counts) -> dict:
    """Phase 10 (f): the 1M-point surrogate under default numerics at
    ``WIDE_FLEET_CHAINS`` chains with ``data_chunk=SURR_CHUNK``, 4 epochs
    through ``Network.train`` (K3 over row chunks on the stepped runner,
    K2): finite samples, K3's launches, the run's peak memory and wall an
    epoch (its first chunk's warm-up and captures included), K3's chunked
    value and gradient at the run's last state against the plain chunked
    path; and the driver's gate for the same fleet without ``data_chunk``
    (``sampler.driver._gate_k3``), decided without running it. Returns the
    cell's dict."""
    from tensorbnn_tpu_torch.ops import fused_mlp
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.sampler.driver import _gate_k3
    from tensorbnn_tpu_torch.sampler.potential import make_potentials

    c = WIDE_FLEET_CHAINS
    net, lik = surrogate_network(dev, x, y, warm, 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = net.train(WIDE_FLEET_EPOCHS, 2, lik, n_chains=c, chain_jitter=0.0,
                    data_chunk=SURR_CHUNK, verbose=True)
    counts = read_counts(f"surrogate {c} chains, default numerics, "
                         f"data_chunk {SURR_CHUNK:,} ({res.main_path})")
    cell = {"card": card, "chains": c, "points": SURROGATE_POINTS,
            "data_chunk": SURR_CHUNK, "epochs": WIDE_FLEET_EPOCHS,
            "main_path": res.main_path, "fused_hyper": res.fused_hyper,
            "chunk_runner": res.chunk_runner, "launches": counts,
            "wall_s": res.wall_time,
            "wall_s_per_epoch": res.wall_time / WIDE_FLEET_EPOCHS,
            "leapfrog": res.leapfrog.tolist(),
            "main_accept": res.main_accept.tolist(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated() - held,
            "held_before_bytes": held,
            "samples": list(res.theta_samples.shape)}
    finite = bool(np.isfinite(res.theta_samples).all())
    thetas, etas = last_state(res, dev)
    del res
    plain = make_potentials(net.model, lik, net.train_x, net.train_y,
                            flat.unravel_theta, flat.unravel_eta,
                            data_chunk=SURR_CHUNK)
    want = plain.main_vg(thetas, etas)
    del plain
    route = k3_route(net, lik, flat, thetas, etas, SURR_CHUNK, reset_counts)
    cell["k3"] = dict(route_errors(route.pop("out"), want), **route)
    del want
    # the same fleet without data_chunk: the driver's gate, not run
    whole = fused_mlp.try_build_fused_main_vg(
        net.model, lik, flat.unravel_theta, flat.unravel_eta, net.train_x,
        net.train_y, flat.eta.numel())
    takes = _gate_k3(whole, c, None, net.train_x.device, True)
    cell["unchunked_gate"] = {
        "workspace_bytes": whole.workspace_bytes(c),
        "card_memory_bytes": graphs.card_memory(net.train_x.device.index),
        "takes_k3": takes is not None}
    print(f"(f) surrogate {c} chains x {SURROGATE_POINTS:,} points, default "
          f"numerics, data_chunk {SURR_CHUNK:,}: {json.dumps(cell)}",
          flush=True)
    if (not finite or cell["main_path"] != "K3"
            or cell["chunk_runner"] != "stepped" or counts["K3"] == 0
            or counts["K3"] % cell["k3"]["launches_per_eval"]
            or cell["k3"]["value_rel"] > SURR_VALUE_RTOL
            or cell["k3"]["grad_over_max"] > SURR_GRAD_TOL
            or cell["unchunked_gate"]["takes_k3"]):
        raise AssertionError(f"surrogate at {c} chains: {cell}")
    del net
    torch.cuda.empty_cache()
    return cell


def surrogate_phase(dev, card, x, y, warm, reset_counts, read_counts):
    """Phase 10: the 1M-point surrogate (the JAX bench's
    ``surrogate_quality_exact``) on the card. (a) ``Network.train`` at full
    width under ``numerics="exact"`` with ``data_chunk``, on the plain path
    (no kernel launches); its pretraining MSE, its epochs' wall, the main
    block's ms an evaluation (CUDA events), an epoch's device busy ms,
    idle share and top kernels (``chip_profile.cell``), the peak of
    ``torch.cuda.max_memory_allocated``, post-burn-in acceptance and finite
    samples; (b) the chunked value and gradient at 4 chains against the
    unchunked one in float32 and float64; (c) the ``potential_noise`` walk
    at the MAP under precision None, "high" and "highest", with each
    precision's value-and-gradient ms at 32 chains; (d)
    ``surrogate_regression --smoke`` through its ``main``, held to the JAX
    example's figures; (e) the same model under default numerics through
    ``Network.train`` with ``data_chunk``: the path and runner that take
    its main block (K3 over row chunks, stepped), the run's peak memory,
    and K3 at the run's last state over row chunks (the driver's route)
    and unchunked (the parent's), each against the plain chunked path and
    against each other (value, gradient, calls, ms and peak memory an
    evaluation, workspace bytes; K3's cuBLAS twin over the same row
    chunks); (f) the same at 128 chains (``wide_fleet_cell``); (g) the
    same-state acceptance ladder against the JAX package's
    (``ladder_cell``). Prints a ``{"surrogate": ...}`` line and returns its
    dict."""
    import dataclasses

    import chip_profile
    from tensorbnn_tpu_torch.examples import surrogate_regression
    from tensorbnn_tpu_torch.ops import fused_mlp
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.sampler.driver import exact_numerics_model
    from tensorbnn_tpu_torch.sampler.gibbs import ChainState
    from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
        make_potentials, tree_leaves

    out = {"card": card, "points": SURROGATE_POINTS,
           "chains": SURR_CHAINS, "data_chunk": SURR_CHUNK,
           "epochs": SURR_EPOCHS, "burnin": SURR_BURNIN,
           "pretrain_mse": host_loss(warm, x, y, False, tanh=True)}
    print(f"surrogate pretraining (phase 9 (a)'s): MSE over the "
          f"{SURROGATE_POINTS:,} rows {out['pretrain_mse']:.5f} (the "
          f"noise floor 0.01) ({card})", flush=True)

    # (a) the full-width run on the plain path
    net, lik = surrogate_network(dev, x, y, warm, SURR_BURNIN)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
    exact = exact_numerics_model(net.model)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    # the run's own peak: what earlier phases still hold is taken out
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = net.train(SURR_EPOCHS, SURR_SAMPLING, lik, n_chains=SURR_CHAINS,
                    chain_jitter=0.0, data_chunk=SURR_CHUNK,
                    numerics="exact", display_skip=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts("surrogate, numerics='exact' (plain)")
    peak = torch.cuda.max_memory_allocated() - held
    main_acc = float(res.main_accept[SURR_BURNIN:].mean())
    hyper_acc = float(res.hyper_accept[SURR_BURNIN:].mean())
    thetas, etas = last_state(res, dev)
    pots = make_potentials(exact, lik, net.train_x, net.train_y,
                           flat.unravel_theta, flat.unravel_eta,
                           data_chunk=SURR_CHUNK)
    eval_ms = cuda_ms(lambda: pots.main_vg(thetas, etas), reps=3)
    # the flat layout's own cost an evaluation: unravelling theta into the
    # layers' views and assembling the flat gradient, under the same
    # vmap(grad_and_value) (what the JAX package's state_layout="tree"
    # exists to avoid)
    layout_vg = torch.func.vmap(torch.func.grad_and_value(
        lambda th: sum(leaf.sum() for leaf in tree_leaves(
            flat.unravel_theta(th)))))
    layout_ms = cuda_ms(lambda: layout_vg(thetas), reps=3)
    # an epoch at the run's last (eps, L) and state, profiled
    run = surrogate_runner(net, lik, flat, exact, SURR_CHUNK, True)
    carry = ChainState(thetas, etas, torch.full_like(
        thetas[:, 0], res.final_hyper_step), *(torch.full_like(
            thetas[:, 0], v) for v in (0.0, 0.0, float(SURR_EPOCHS))))
    gen = torch.Generator(device=dev).manual_seed(10)
    cell = chip_profile.cell(
        f"surrogate {SURR_CHAINS} x {SURROGATE_POINTS:,}, exact, chunk "
        f"{SURR_CHUNK:,}", run, carry, res.final_step_size,
        res.final_leapfrog, 1, 1, 1, gen, card)
    evals = res.final_leapfrog + 1
    flops = SURR_CHAINS * product_flops(fused_mlp._model_program(
        net.model, lik)[0], SURROGATE_POINTS)
    eval_bound = bound(flops, 4 * (SURROGATE_POINTS * (SURROGATE_IN + 1)
                                   + 2 * thetas.numel()))
    out["exact"] = {
        "main_path": res.main_path, "fused_hyper": res.fused_hyper,
        "launches": counts, "train_wall_s": wall,
        "epoch_wall_s": wall / SURR_EPOCHS, "eval_ms": eval_ms,
        "eval_bound_ms": eval_bound[0], "eval_bound_by": eval_bound[1],
        "flat_layout_ms": layout_ms,
        "evals_per_epoch": evals, "profiled_epoch": {
            k: cell[k] for k in ("wall_ms_per_epoch",
                                 "device_busy_ms_per_epoch", "idle_share",
                                 "top_kernels")},
        "peak_memory_bytes": peak, "held_before_bytes": held,
        "main_accept": main_acc,
        "hyper_accept": hyper_acc, "final_step_size": res.final_step_size,
        "final_leapfrog": res.final_leapfrog,
        "learned_sd": float(np.mean(res.eta_samples[:, :, -1] ** 2)),
        "samples": list(res.theta_samples.shape)}
    print(f"surrogate, numerics='exact', {SURR_CHAINS} chains x "
          f"{SURROGATE_POINTS:,} points, data_chunk {SURR_CHUNK:,}: main_path "
          f"{res.main_path!r}, K2 {res.fused_hyper}, launches {counts}; "
          f"{wall:.2f} s for {SURR_EPOCHS} epochs ({wall / SURR_EPOCHS:.3f} s "
          f"an epoch); main block {eval_ms:.3f} ms an evaluation at C="
          f"{SURR_CHAINS} (bound {eval_bound[0]:.3f} ms, "
          f"{eval_bound[1]}; the flat layout's unravel and gradient "
          f"assembly {layout_ms:.4f} ms of it); profiled epoch at (eps, L) = "
          f"({res.final_step_size:.3g}, {res.final_leapfrog}): busy "
          f"{cell['device_busy_ms_per_epoch']:.2f} ms, idle share "
          f"{cell['idle_share']:.4f}; peak memory {peak / 2**30:.2f} GiB "
          f"above the {held / 2**30:.2f} GiB held before; "
          f"post-burn-in acceptance main {main_acc:.4f} / hyper "
          f"{hyper_acc:.4f} ({card})", flush=True)
    if (res.main_path != "plain" or res.fused_hyper or any(counts.values())
            or not np.isfinite(res.theta_samples).all()
            or not 0.0 < main_acc <= 1.0):
        raise AssertionError(f"surrogate (exact): {out['exact']}")
    del run, carry, cell

    # (b) chunked against unchunked at 4 chains, both against float64
    th4, et4 = thetas[:4].contiguous(), etas[:4].contiguous()
    got = {}
    for label, chunk, dt in (("chunked", SURR_CHUNK, torch.float32),
                             ("unchunked", None, torch.float32),
                             ("float64", None, torch.float64)):
        p = make_potentials(exact, lik, net.train_x.to(dt),
                            net.train_y.to(dt), flat.unravel_theta,
                            flat.unravel_eta, data_chunk=chunk)
        v, g = p.main_vg(th4.to(dt), et4.to(dt))
        got[label] = (v.double(), g.double())
        del p
    v64, g64 = got.pop("float64")
    gmax = float(g64.abs().max())
    errs = {label: {"value_rel": float(((v - v64).abs() / v64.abs()).max()),
                    "grad_over_max": float((g - g64).abs().max()) / gmax}
            for label, (v, g) in got.items()}
    errs["chunked_vs_unchunked"] = {
        "value_rel": float(((got["chunked"][0] - got["unchunked"][0]).abs()
                            / v64.abs()).max()),
        "grad_over_max": float((got["chunked"][1] - got["unchunked"][1])
                               .abs().max()) / gmax}
    out["chunked_c4"] = errs
    print(f"chunked ({SURR_CHUNK:,} rows) against unchunked value and "
          f"gradient at C=4 over {SURROGATE_POINTS:,} rows, each against "
          f"float64: {errs} (gates {SURR_VALUE_RTOL} / {SURR_GRAD_TOL}) "
          f"({card})", flush=True)
    if any(e["value_rel"] > SURR_VALUE_RTOL or e["grad_over_max"]
           > SURR_GRAD_TOL for e in errs.values()):
        raise AssertionError(f"chunked potential off: {errs}")
    del got

    # (c) the potential_noise walk at the MAP, and each precision's cost
    theta0, eta0 = flat.theta, flat.eta
    u = torch.tensor(np.random.default_rng(7).normal(
        size=theta0.numel()).astype(np.float32), device=dev)
    walk, costs = {}, {}
    for prec in (None, "high", "highest"):
        model = net.model if prec is None else type(net.model)([
            dataclasses.replace(layer, matmul_precision=prec)
            if hasattr(layer, "matmul_precision") else layer
            for layer in net.model.layers])
        p = make_potentials(model, lik, net.train_x, net.train_y,
                            flat.unravel_theta, flat.unravel_eta,
                            data_chunk=SURR_CHUNK)
        walk[str(prec)] = [float(p.main(theta0 + t * u, eta0))
                           for t in NOISE_TS]
        if prec == "highest":
            slope = float(p.main_vg(theta0[None], eta0[None])[1][0] @ u)
        thb = theta0.expand(SURR_CHAINS, -1).contiguous()
        etb = eta0.expand(SURR_CHAINS, -1).contiguous()
        costs[str(prec)] = cuda_ms(lambda: p.main_vg(thb, etb), reps=3)
        del p
    rows = [{"t": t, **{f"dlp_{k}": v[i] - v[0] for k, v in walk.items()},
             "dlp_linear": slope * t}
            for i, t in enumerate(NOISE_TS) if t > 0]
    small = [r for r in rows if r["t"] <= 1e-6]
    stair = [abs(r["dlp_high"] - r["dlp_highest"]) for r in small]
    out["potential_noise"] = {
        "staircase_high_median_nats": float(np.median(stair)),
        "staircase_high_max_nats": float(np.max(stair)),
        "none_vs_highest_max_nats": max(
            abs(r["dlp_None"] - r["dlp_highest"]) for r in rows),
        "highest_residual_max_nats": max(
            abs(r["dlp_highest"] - r["dlp_linear"]) for r in small),
        "directional_slope": slope, "lp0": {k: v[0] for k, v in walk.items()},
        "curves": rows, "vg_ms_c32": costs}
    print(f"potential_noise at the MAP ({card}): " + json.dumps(
        {k: v for k, v in out["potential_noise"].items() if k != "curves"}),
        flush=True)
    if not all(np.isfinite(v).all() for v in walk.values()):
        raise AssertionError("potential_noise: a non-finite value")

    # (d) surrogate_regression --smoke through its main
    reset_counts()
    smoke = surrogate_regression.main(["--smoke"])
    smoke["launches"] = read_counts("surrogate_regression --smoke")
    out["example_smoke"] = smoke
    ref = JAX_SURROGATE_SMOKE
    print(f"surrogate_regression --smoke on the card: {smoke['samples']} "
          f"samples, main acceptance {smoke['main_accept']:.4f}, learned sd "
          f"{smoke['learned_sd']:.4f}, {smoke['wall_s']:.2f} s (JAX example "
          f"{ref}; gates: the same count, acceptance within "
          f"{SURR_SMOKE_ACCEPT_TOL}, sd within {SURR_SMOKE_SD_RTOL:.0%}) "
          f"({card})", flush=True)
    if (smoke["samples"] != ref["samples"] or smoke["main_path"] != "plain"
            or any(smoke["launches"].values())
            or abs(smoke["main_accept"] - ref["main_accept"])
            > SURR_SMOKE_ACCEPT_TOL
            or abs(smoke["learned_sd"] - ref["learned_sd"])
            > SURR_SMOKE_SD_RTOL * ref["learned_sd"]):
        raise AssertionError(f"surrogate_regression --smoke off the JAX "
                             f"example's figures: {smoke}")

    # (e) default numerics: K3 over row chunks (the driver's route with
    # data_chunk) and unchunked (the parent's), each against the plain path
    net_d, lik_d = surrogate_network(dev, x, y, warm, 2)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res_d = net_d.train(4, 2, lik_d, n_chains=SURR_CHAINS, chain_jitter=0.0,
                        data_chunk=SURR_CHUNK, verbose=True)
    counts_d = read_counts(f"surrogate, default numerics "
                           f"({res_d.main_path})")
    default = {"main_path": res_d.main_path, "fused_hyper":
               res_d.fused_hyper, "chunk_runner": res_d.chunk_runner,
               "launches": counts_d,
               "main_accept": res_d.main_accept.tolist(),
               "wall_s": res_d.wall_time,
               "peak_memory_bytes": torch.cuda.max_memory_allocated() - held}
    assert np.isfinite(res_d.theta_samples).all()
    th_d, et_d = last_state(res_d, dev)
    plain = make_potentials(net_d.model, lik_d, net_d.train_x,
                            net_d.train_y, flat.unravel_theta,
                            flat.unravel_eta, data_chunk=SURR_CHUNK)
    default["plain_ms"] = cuda_ms(lambda: plain.main_vg(th_d, et_d), reps=3)
    want = plain.main_vg(th_d, et_d)
    del plain
    if res_d.main_path != "K3" or counts_d["K3"] == 0:
        raise AssertionError(f"surrogate, default numerics: {default}")
    routes = {}
    for label, chunk in (("chunked", SURR_CHUNK), ("unchunked", None)):
        routes[label] = k3_route(net_d, lik_d, flat, th_d, et_d, chunk,
                                 reset_counts, library=chunk is not None)
    k3 = {label: r.pop("out") for label, r in routes.items()}
    for label, r in routes.items():
        r.update(route_errors(k3[label], want))
    routes["chunked"]["vs_unchunked"] = route_errors(k3["chunked"],
                                                     k3["unchunked"])
    default["k3"] = routes
    # the parent's keys: the driver's route, now chunked
    default.update(k3_ms=routes["chunked"]["ms"],
                   k3_library_ms=routes["chunked"]["library_ms"],
                   k3_workspace_bytes=routes["chunked"]["workspace_bytes"])
    del want, k3
    print(f"surrogate, default numerics: {json.dumps(default)} ({card})",
          flush=True)
    if (res_d.chunk_runner != "stepped"
            or counts_d["K3"] % routes["chunked"]["launches_per_eval"]
            or routes["chunked"]["launches_per_eval"]
            != SURROGATE_POINTS // SURR_CHUNK
            or routes["unchunked"]["launches_per_eval"] != 1
            or any(e["value_rel"] > SURR_VALUE_RTOL
                   or e["grad_over_max"] > SURR_GRAD_TOL
                   for e in (routes["chunked"], routes["unchunked"],
                             routes["chunked"]["vs_unchunked"]))):
        raise AssertionError(f"K3 at the surrogate's shape: {default}")
    out["default_numerics"] = default
    del net_d, res_d
    torch.cuda.empty_cache()

    # (f) the fleet the parent could not run: 128 chains over the 1M rows
    # under default numerics, K3 over row chunks on the stepped runner
    out["default_128"] = wide_fleet_cell(dev, card, x, y, warm, flat,
                                         reset_counts, read_counts)

    # (g) the same-state acceptance ladder against the JAX package
    out["ladder"] = ladder_cell(dev, card, x, y)
    print(json.dumps({"surrogate": out}), flush=True)
    if not out["ladder"]["passed"]:
        raise AssertionError(f"ladder off the JAX package's: "
                             f"{out['ladder']}")
    return out


def ladder_cell(dev, card, x, y) -> dict:
    """Phase 10 (g): the same-state acceptance ladder (``LADDER_STEPS``)
    on the card against the JAX package's figures (``LADDER_JAX``): for
    each of its lines, the surrogate from the JAX package's warm start
    (``SURR_WARM_START``) at ``LADDER_CHAINS`` chains, all at the warm
    start or ``SURR_EQUILIBRIUM``'s 4 chains twice over, through the chunk
    runner ``sample_posterior`` builds for ``numerics="exact"`` and
    ``data_chunk=125,000`` (the stepped runner on the card) for
    ``LADDER_EPOCHS`` epochs at the line's (eps, L), the hyper block's
    dual averaging as in a run's first epochs (``ladder_mcmc``). Each
    rung's ``ladder_figures``, hyper acceptance and z against the JAX
    package's mean accept probability (the difference over the root of
    both standard errors squared); fails where a z exceeds ``LADDER_Z`` or
    a learned sd is more than ``LADDER_SD_RTOL`` from the JAX package's.
    The ladder exercises the chunk runner only (the driver is held on the
    CPU), and its rungs differ in power (see ``LADDER_STEPS``). Returns
    ``{"rungs": [...], "passed": ...}``."""
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.sampler.driver import exact_numerics_model
    from tensorbnn_tpu_torch.sampler.potential import flatten_state

    net, lik = surrogate_network(dev, x, y, surrogate_jax_warm_start(),
                                 LADDER_BURNIN)
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
    run = surrogate_runner(net, lik, flat, exact_numerics_model(net.model),
                           SURR_CHUNK, True, n_chains=LADDER_CHAINS)
    gen = torch.Generator(device=dev).manual_seed(23)
    rungs = []
    for ref in LADDER_JAX:
        eps, steps = ref["eps"], ref["leapfrog"]
        carry = init_multichain_state(flat.theta, flat.eta,
                                      SURR_MCMC["hyper_step_size"],
                                      LADDER_CHAINS)
        if ref["state"] == "equilibrium":
            theta, eta = surrogate_equilibrium()
            reps = LADDER_CHAINS // theta.shape[0]
            carry = carry._replace(
                theta=torch.tensor(np.tile(theta, (reps, 1)), device=dev),
                eta=torch.tensor(np.tile(eta, (reps, 1)), device=dev))
        t0 = time.perf_counter()
        carry, trace = run(carry, eps, steps, LADDER_EPOCHS, gen)
        torch.cuda.synchronize()
        got = dict(ladder_figures(trace.main_accept.cpu().numpy(),
                                  trace.eta.cpu().numpy()),
                   state=ref["state"], eps=eps, leapfrog=steps,
                   n_chains=LADDER_CHAINS, epochs=LADDER_EPOCHS,
                   runner=run.runner,
                   hyper_accept=float(trace.hyper_accept.mean()),
                   wall_s=time.perf_counter() - t0,
                   finite=bool(torch.isfinite(carry.theta).all()))
        se = math.hypot(got["main_accept_se"], ref["main_accept_se"])
        diff = abs(got["main_accept"] - ref["main_accept"])
        got["z"] = diff / se if se > 0 else 0.0 if diff == 0 else math.inf
        got["sd_rel"] = (abs(got["learned_sd"] - ref["learned_sd"])
                         / ref["learned_sd"])
        got["jax"] = {k: ref[k] for k in ("main_accept", "main_accept_se",
                                          "learned_sd", "hyper_accept")}
        got["passed"] = (got["finite"] and got["z"] <= LADDER_Z
                         and got["sd_rel"] <= LADDER_SD_RTOL)
        print(f"(g) ladder, {ref['state']} state, (eps, L) = ({eps:g}, "
              f"{steps}), {LADDER_CHAINS} chains x {LADDER_EPOCHS} epochs "
              f"on the {run.runner} runner: main accept "
              f"{got['main_accept']:.4f} +- {got['main_accept_se']:.4f} "
              f"(JAX {ref['main_accept']:.4f} +- "
              f"{ref['main_accept_se']:.4f}, z {got['z']:.2f}, gate "
              f"{LADDER_Z}), learned sd {got['learned_sd']:.5f} (JAX "
              f"{ref['learned_sd']:.5f}, gate {LADDER_SD_RTOL:.0%}), hyper "
              f"accept {got['hyper_accept']:.4f} ({card})", flush=True)
        rungs.append(got)
    del net, run, carry, trace
    torch.cuda.empty_cache()
    return {"rungs": rungs, "passed": all(r["passed"] for r in rungs)}


def moons_ladder_cell(dev, card, reset_counts, read_counts) -> dict:
    """Phase 6 (e), last: the moons stack's same-state acceptance ladder
    (``MOONS_LADDER_STEPS``) on the card against the JAX package's figures
    (``MOONS_LADDER_JAX``): for each of its lines, the full-width moons
    stack from the JAX package's warm start (``MOONS_WARM_START``) at
    ``MOONS_LADDER_CHAINS`` chains, all at the warm start or
    ``MOONS_EQUILIBRIUM``'s 4 rows each 4 times, through the chunk runner
    ``sample_posterior`` builds (``chunk_runner``: K1 (d), the plain hyper
    block, the graph runner) for ``MOONS_LADDER_EPOCHS`` epochs at the
    line's (eps, L), the hyper block's dual averaging as in the full run's
    first epochs (its burn-in only ends the averaging, past these epochs
    at either run's). Each rung's ``ladder_figures``, hyper acceptance and z
    against the JAX package's mean accept probability (the difference over
    the root of both standard errors squared); fails where a z exceeds
    ``MOONS_LADDER_Z``, a mean hyper acceptance is more than
    ``MOONS_HYPER_TOL`` from the JAX package's, or the rungs did not launch
    K1 once an epoch and nothing else. The driver over the same
    likelihoods is held on the CPU by
    tests/test_torch_classification_driver_parity.py. Returns ``{"rungs":
    [...], "launches": ..., "passed": ...}``."""
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.sampler.potential import flatten_state

    net, lik = moons_network(dev, parameters=moons_jax_warm_start())
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
    c = MOONS_LADDER_CHAINS
    run = chunk_runner(net, lik, flat, net.config.hyper_leapfrog,
                       net.config.hyper_step_size, n_chains=c)
    gen = torch.Generator(device=dev).manual_seed(24)
    rungs = []
    reset_counts()
    t_ladder = time.perf_counter()
    for ref in MOONS_LADDER_JAX:
        eps, steps = ref["eps"], ref["leapfrog"]
        carry = init_multichain_state(flat.theta, flat.eta,
                                      net.config.hyper_step_size, c)
        if ref["state"] == "equilibrium":
            theta_eq, eta_eq = moons_equilibrium()
            reps = c // theta_eq.shape[0]
            carry = carry._replace(
                theta=torch.tensor(np.tile(theta_eq, (reps, 1)), device=dev),
                eta=torch.tensor(np.tile(eta_eq, (reps, 1)), device=dev))
        t0 = time.perf_counter()
        carry, trace = run(carry, eps, steps, MOONS_LADDER_EPOCHS, gen)
        torch.cuda.synchronize()
        got = dict(ladder_figures(trace.main_accept.cpu().numpy()),
                   state=ref["state"], eps=eps, leapfrog=steps, n_chains=c,
                   epochs=MOONS_LADDER_EPOCHS, runner=run.runner,
                   hyper_accept=float(trace.hyper_accept.mean()),
                   wall_s=time.perf_counter() - t0,
                   finite=bool(torch.isfinite(carry.theta).all()))
        se = math.hypot(got["main_accept_se"], ref["main_accept_se"])
        diff = abs(got["main_accept"] - ref["main_accept"])
        got["z"] = diff / se if se > 0 else 0.0 if diff == 0 else math.inf
        got["hyper_diff"] = abs(got["hyper_accept"] - ref["hyper_accept"])
        got["jax"] = {k: ref[k] for k in ("main_accept", "main_accept_se",
                                          "hyper_accept")}
        got["passed"] = (got["finite"] and got["z"] <= MOONS_LADDER_Z
                         and got["hyper_diff"] <= MOONS_HYPER_TOL)
        print(f"(e) moons ladder, {ref['state']} state, (eps, L) = "
              f"({eps:g}, {steps}), {c} chains x {MOONS_LADDER_EPOCHS} "
              f"epochs on the {run.runner} runner: main accept "
              f"{got['main_accept']:.4f} +- {got['main_accept_se']:.4f} "
              f"(JAX {ref['main_accept']:.4f} +- "
              f"{ref['main_accept_se']:.4f}, z {got['z']:.2f}, gate "
              f"{MOONS_LADDER_Z}), hyper accept {got['hyper_accept']:.4f} "
              f"(JAX {ref['hyper_accept']:.4f}, gate {MOONS_HYPER_TOL}) "
              f"({card})", flush=True)
        rungs.append(got)
    wall = time.perf_counter() - t_ladder
    launches = read_counts("moons ladder (K1 (d))")
    want = len(MOONS_LADDER_JAX) * MOONS_LADDER_EPOCHS
    routed = (launches["K1"] == want and not launches["K2"]
              and not launches["K3"])
    out = {"rungs": rungs, "launches": launches, "wall_s": wall,
           "passed": routed and all(r["passed"] for r in rungs)}
    print(json.dumps({"moons_ladder": out}), flush=True)
    if not out["passed"]:
        raise AssertionError(f"the moons ladder missed a gate (K1 launches "
                             f"{launches}, {want} expected): {rungs}")
    del net, run, carry, trace
    torch.cuda.empty_cache()
    return out


def mesh_phase(dev, card, x, y, warm, reset_counts, read_counts) -> dict:
    """Phase 11: the ``(chains, data)`` mesh on a virtual mesh whose entries
    are all this card (``make_mesh(..., devices=[dev] * n)``), which runs
    the code that would run over distinct cards. (a) the flagship at 64
    chains on 4x1 through ``Network.train`` (K1 and K2 on each chain
    shard, a graph a shard): 3 epochs against the mesh-less run from the
    same seed (the MH decisions and the samples), then 200 epochs of each,
    their walls and launches an epoch (four shards' graphs on one card);
    (b)
    the flagship refused on 2x2 (11 rows), ``wide_deep`` on 2x2 (K3 and
    the coupled K2): 3 epochs against the mesh-less K3 run, and the stats
    columns R and K at the final state against the mesh-less ones; (c)
    the 1M-point surrogate at full width on 1x4: under default numerics
    one main-block evaluation (K3 on four 250,000-row shards and the sum)
    against the mesh-less K3 evaluation and the plain path in float64
    (the float32 plain path's own distance from it reported beside), its
    ms and peak memory; under ``numerics="exact"`` with
    ``data_chunk=125,000`` (two chunks a shard) ``MESH_EXACT_EPOCHS``
    epochs, the ms an
    evaluation and the acceptance against the same epochs without the
    mesh; (d) ``multiclass`` tempered (64 chains x 4 rungs, beta_min
    0.5) on 1x2, 3 epochs on the plain path against the mesh-less run (the
    swap decisions), and with the kernels the driver picks there (the
    plain main block, K2); (e) the predict cell on 2x2 against the
    unsharded ``predict``, on both routes (``predict_mesh_phase``). Prints
    a ``{"mesh": ...}`` line and returns its dict."""
    from tensorbnn_tpu_torch.ops import fused_mlp
    from tensorbnn_tpu_torch.parallel.mesh import DataPeers, make_mesh
    from tensorbnn_tpu_torch.sampler.driver import exact_numerics_model
    from tensorbnn_tpu_torch.sampler.hyper_stats import make_stats_hyper
    from tensorbnn_tpu_torch.sampler.potential import flatten_state, \
        make_potentials

    t_phase = time.perf_counter()

    def mesh(n_chain, n_data):
        return make_mesh(n_chain, n_data, devices=[dev] * (n_chain * n_data))

    def moves(samples):
        """The MH decisions of epochs 2.. of a run recorded every epoch:
        (epochs - 1, C), True where the state moved."""
        return (samples[1:] != samples[:-1]).any(-1)

    def train(label, make, mcmc, epochs, m, **kw):
        net, lik = make(dev)
        net.setup_mcmc(**mcmc)
        reset_counts()
        t0 = time.perf_counter()
        res = net.train(epochs, 1, lik, mesh=m, verbose=False, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, read_counts(label), wall

    out = {"card": card}

    # (a) the flagship on 4x1: K1 + K2 on each chain shard
    flag = {}
    for label, m in (("meshless", None), ("4x1", mesh(4, 1))):
        flag[label] = train(f"flagship 3 epochs, {label}", flagship_network,
                            RECIPE | dict(burnin=0), 3, m, n_chains=64,
                            chain_jitter=0.01)
    (r0, c0, _), (r1, c1, _) = flag["meshless"], flag["4x1"]
    same_moves = bool(
        (moves(r1.theta_samples) == moves(r0.theta_samples)).all()
        and (moves(r1.eta_samples) == moves(r0.eta_samples)).all())
    scale = float(np.abs(r0.theta_samples).max())
    diff = float(np.abs(r1.theta_samples - r0.theta_samples).max())
    out["flagship_4x1"] = {
        "main_path": r1.main_path, "fused_hyper": r1.fused_hyper,
        "launches": c1, "meshless_launches": c0,
        "decisions_equal": same_moves,
        "samples_bit_equal": bool((r1.theta_samples == r0.theta_samples)
                                  .all() and (r1.eta_samples
                                              == r0.eta_samples).all()),
        "theta_max_abs_diff": diff, "theta_max_abs": scale,
        "main_accept": r1.main_accept.tolist(),
        "meshless_main_accept": r0.main_accept.tolist()}
    if (r1.main_path != "K1" or not r1.fused_hyper or not same_moves
            or c1 != {"K1": 12, "K2": 12, "K3": 0}
            or c0 != {"K1": 3, "K2": 3, "K3": 0}
            or diff > MESH_FLAGSHIP_ATOL * scale):
        raise AssertionError(f"flagship on 4x1: {out['flagship_4x1']}")
    steady = {}
    for label, m in (("meshless", None), ("4x1", mesh(4, 1))):
        res, counts, wall = train(f"flagship 200 epochs, {label}",
                                  flagship_network, RECIPE, 200, m,
                                  n_chains=64, chain_jitter=0.01)
        assert np.isfinite(res.main_accept).all()
        steady[label] = {"wall_s": wall, "ms_per_epoch": 5.0 * wall,
                         "launches_per_epoch": {k: v / 200 for k, v in
                                                counts.items()},
                         "final_leapfrog": res.final_leapfrog}
    out["flagship_4x1"]["steady_200"] = steady
    print(f"(a) flagship 64 chains on 4x1 ({card}): {r1.main_path} + K2, "
          f"launches {c1} in 3 epochs (mesh-less {c0}); MH decisions "
          f"equal {same_moves}, samples bit-equal "
          f"{out['flagship_4x1']['samples_bit_equal']} (max |diff| "
          f"{diff:.3g} of {scale:.3g}); 200 epochs: "
          + "; ".join(f"{k} {v['wall_s']:.3f} s ({v['ms_per_epoch']:.3f} ms "
                      f"an epoch, launches an epoch "
                      f"{v['launches_per_epoch']})"
                      for k, v in steady.items()), flush=True)

    # (b) the flagship's 11 rows refused on 2x2; wide_deep on 2x2
    fnet, flik = flagship_network(dev)
    fnet.setup_mcmc(**RECIPE)
    try:
        fnet.train(1, 1, flik, n_chains=64, mesh=mesh(2, 2), verbose=False)
        raise AssertionError("the flagship's 11 rows ran on a data axis "
                             "of 2")
    except ValueError as err:
        refusal = str(err)
    if refusal != ("training rows 11 must divide the data axis (2); pad "
                   "the dataset"):
        raise AssertionError(f"flagship on 2x2: {refusal}")
    wide_mcmc = dict(burnin=0, step_size_start=1e-5, step_size_min=1e-6,
                     step_size_max=1e-4, leapfrog_start=20, leapfrog_min=20,
                     leapfrog_max=20, hyper_leapfrog=5, hyper_step_size=1e-4,
                     averaging_steps=10)
    wide = {label: train(f"wide_deep 3 epochs, {label}", wide_network,
                         wide_mcmc, 3, m, n_chains=64, chain_jitter=0.01)
            for label, m in (("meshless", None), ("2x2", mesh(2, 2)))}
    (w0, wc0, _), (w1, wc1, _) = wide["meshless"], wide["2x2"]
    wnet, wlik = wide_network(dev)
    params, hypers = wnet.init_state()
    wflat = flatten_state(params, hypers, wlik.init_hypers(device=dev))
    h = wflat.eta.numel()
    thetas = torch.tensor(w1.theta_samples[-1], device=dev)
    peers = DataPeers.split([dev] * 2, wnet.train_x, wnet.train_y)
    stats_mesh = make_stats_hyper(
        wnet.model, wlik, *peers.shards[0], wflat.unravel_theta,
        wflat.unravel_eta, h, peers=peers)[0](thetas)
    stats_0 = make_stats_hyper(
        wnet.model, wlik, wnet.train_x, wnet.train_y, wflat.unravel_theta,
        wflat.unravel_eta, h)[0](thetas)
    r_rel = float(((stats_mesh[:, -2] - stats_0[:, -2]).abs()
                   / stats_0[:, -2].abs()).max())
    k_vals = sorted(set(stats_mesh[:, -1].tolist()))
    w_scale = float(np.abs(w0.theta_samples).max())
    w_diff = float(np.abs(w1.theta_samples - w0.theta_samples).max())
    w_move = float(np.abs(w0.theta_samples[-1]
                          - w0.theta_samples[0]).max())
    theta_ok = w_diff <= MESH_DATA_ATOL * w_scale
    main_moves = bool((moves(w1.theta_samples)
                       == moves(w0.theta_samples)).all())
    hyper_moves = bool((moves(w1.eta_samples)
                        == moves(w0.eta_samples)).all())
    want_k3 = 4 * 3 * 21
    out["wide_deep_2x2"] = {
        "flagship_refusal": refusal, "main_path": w1.main_path,
        "fused_hyper": w1.fused_hyper, "launches": wc1,
        "meshless_launches": wc0, "theta_within_tol": bool(theta_ok),
        "theta_max_abs_diff": w_diff, "theta_max_abs": w_scale,
        "theta_max_move": w_move, "main_decisions_equal": main_moves,
        "hyper_decisions_equal": hyper_moves,
        "hyper_accept": w1.hyper_accept.tolist(),
        "meshless_hyper_accept": w0.hyper_accept.tolist(),
        "main_accept": w1.main_accept.tolist(),
        "meshless_main_accept": w0.main_accept.tolist(),
        "r_max_rel_diff": r_rel, "k_values": k_vals,
        "k_meshless": sorted(set(stats_0[:, -1].tolist()))}
    print(f"(b) wide_deep 64 chains on 2x2 ({card}): "
          f"{json.dumps(out['wide_deep_2x2'])}", flush=True)
    if (w1.main_path != "K3" or not w1.fused_hyper or not theta_ok
            or not main_moves or not hyper_moves
            or w_move < MESH_MOVE_OVER_TOL * MESH_DATA_ATOL * w_scale
            or wc1 != {"K1": 0, "K2": 6, "K3": want_k3}
            or r_rel > MESH_STATS_RTOL or k_vals != [128.0]
            or out["wide_deep_2x2"]["k_meshless"] != [128.0]):
        raise AssertionError(f"wide_deep on 2x2: {out['wide_deep_2x2']}")
    del wide, stats_mesh, stats_0, peers, thetas

    # (c) the 1M-point surrogate on 1x4: K3 on four 250,000-row shards
    net_d, lik_d = surrogate_network(dev, x, y, warm, SURR_BURNIN)
    params, hypers = net_d.init_state()
    sflat = flatten_state(params, hypers, lik_d.init_hypers(device=dev))
    h = sflat.eta.numel()
    g = torch.Generator(device=dev).manual_seed(11)
    th = (sflat.theta.expand(SURR_CHAINS, -1) + 1e-4 * torch.randn(
        (SURR_CHAINS, sflat.theta.numel()), generator=g, device=dev))
    et = sflat.eta.expand(SURR_CHAINS, -1).contiguous()
    n_local = SURROGATE_POINTS // 4
    peers = DataPeers.split([dev] * 4, net_d.train_x, net_d.train_y)
    k3_mesh = fused_mlp.try_build_fused_main_vg(
        net_d.model, lik_d, sflat.unravel_theta, sflat.unravel_eta,
        *peers.shards[0], h, n_rows=n_local)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got = k3_mesh(th, et, *peers.shards[0], peers=peers)
    k3_counts = read_counts("surrogate, one K3 evaluation on 1x4")
    peak = torch.cuda.max_memory_allocated() - held
    mesh_ms = cuda_ms(lambda: k3_mesh(th, et, *peers.shards[0],
                                      peers=peers), reps=3)
    k3_whole = fused_mlp.try_build_fused_main_vg(
        net_d.model, lik_d, sflat.unravel_theta, sflat.unravel_eta,
        net_d.train_x, net_d.train_y, h)
    want = k3_whole(th, et, net_d.train_x, net_d.train_y)
    whole_ms = cuda_ms(lambda: k3_whole(th, et, net_d.train_x,
                                        net_d.train_y), reps=3)
    # the plain path in float32 and in float64 (phase 10 (b)'s reference):
    # at this state the float32 one is itself ~1e-5 from float64 in value
    plain = {}
    for dt in (torch.float32, torch.float64):
        pots = make_potentials(net_d.model, lik_d, net_d.train_x.to(dt),
                               net_d.train_y.to(dt), sflat.unravel_theta,
                               sflat.unravel_eta, data_chunk=SURR_CHUNK)
        plain[dt] = tuple(t.double() for t in pots.main_vg(th.to(dt),
                                                           et.to(dt)))
        del pots
    ops, tail = fused_mlp._model_program(net_d.model, lik_d)
    program = fused_mlp.make_fused_potential_vg(ops, n_local, tail).args[0]
    errs = {}
    for label, a, b in (
            ("vs_meshless_k3", got, want),
            ("vs_float64", got, plain[torch.float64]),
            ("meshless_k3_vs_float64", want, plain[torch.float64]),
            ("plain_float32_vs_float64", plain[torch.float32],
             plain[torch.float64])):
        gmax = float(b[1].abs().max())
        errs[label] = {
            "value_rel": float(((a[0].double() - b[0]).abs()
                                / b[0].abs()).max()),
            "grad_over_max": float((a[1].double() - b[1]).abs().max())
            / gmax}
    default = {"launches": k3_counts, "shards": 4, "rows_a_shard": n_local,
               "chains": SURR_CHAINS, "ms": mesh_ms,
               "meshless_k3_ms": whole_ms, "peak_memory_bytes": peak,
               "held_before_bytes": held,
               "workspace_bytes_a_shard": 4 * program.workspace_floats(
                   SURR_CHAINS), **errs}
    del got, want, plain, k3_whole
    torch.cuda.empty_cache()
    print(f"(c) surrogate {SURR_CHAINS} chains x {SURROGATE_POINTS:,} rows "
          f"on 1x4, default numerics ({card}): {json.dumps(default)}",
          flush=True)
    if (k3_counts != {"K1": 0, "K2": 0, "K3": 4}
            or any(errs[k]["value_rel"] > SURR_VALUE_RTOL
                   or errs[k]["grad_over_max"] > SURR_GRAD_TOL
                   for k in ("vs_meshless_k3", "vs_float64"))):
        raise AssertionError(f"surrogate K3 on 1x4: {default}")
    # MESH_EXACT_EPOCHS epochs under the exact preset (the plain path: no
    # kernel), burn-in MESH_EXACT_BURNIN so that epoch 4 is recorded, on
    # 1x4 and without the mesh from the same seed (the likelihood summed in
    # another order, so the acceptance is compared, not the bits)
    exact_runs = {}
    for label, m in (("meshless", None), ("1x4", mesh(1, 4))):
        net_e, lik_e = surrogate_network(dev, x, y, warm, MESH_EXACT_BURNIN)
        reset_counts()
        t0 = time.perf_counter()
        res_e = net_e.train(MESH_EXACT_EPOCHS, 2, lik_e,
                            n_chains=SURR_CHAINS,
                            chain_jitter=0.0, data_chunk=SURR_CHUNK,
                            numerics="exact", mesh=m, verbose=False)
        torch.cuda.synchronize()
        exact_runs[label] = (res_e, time.perf_counter() - t0, read_counts(
            f"surrogate, numerics='exact', {label} (plain)"))
    res_0 = exact_runs["meshless"][0]
    res_e, wall_e, counts_e = exact_runs["1x4"]
    peers_e = DataPeers.split([dev] * 4, net_e.train_x, net_e.train_y)
    pots = make_potentials(exact_numerics_model(net_e.model), lik_e,
                           *peers_e.shards[0], sflat.unravel_theta,
                           sflat.unravel_eta, data_chunk=SURR_CHUNK,
                           peers=peers_e)
    th_e, et_e = last_state(res_e, dev)
    exact = {"main_path": res_e.main_path, "fused_hyper": res_e.fused_hyper,
             "launches": counts_e, "train_wall_s": wall_e,
             "epoch_wall_s": wall_e / MESH_EXACT_EPOCHS,
             "eval_ms": cuda_ms(lambda: pots.main_vg(th_e, et_e), reps=3),
             "meshless_wall_s": exact_runs["meshless"][1],
             "main_accept": float(res_e.main_accept.mean()),
             "hyper_accept": float(res_e.hyper_accept.mean()),
             "main_accept_epochs": res_e.main_accept.tolist(),
             "hyper_accept_epochs": res_e.hyper_accept.tolist(),
             "meshless_main_accept_epochs": res_0.main_accept.tolist(),
             "meshless_hyper_accept_epochs": res_0.hyper_accept.tolist(),
             "final_step_size": res_e.final_step_size,
             "final_leapfrog": res_e.final_leapfrog,
             "samples": list(res_e.theta_samples.shape)}
    out["surrogate_1x4"] = {"default_numerics": default, "exact": exact}
    print(f"(c) surrogate on 1x4, numerics='exact', data_chunk "
          f"{SURR_CHUNK:,} (two chunks a shard) ({card}): "
          f"{json.dumps(exact)}", flush=True)
    if (res_e.main_path != "plain" or res_e.fused_hyper
            or any(counts_e.values())
            or not np.isfinite(res_e.theta_samples).all()
            or not 0.0 < exact["main_accept"] <= 1.0
            or any(abs(getattr(res_e, k).mean() - getattr(res_0, k).mean())
                   > MESH_ACCEPT_TOL for k in ("main_accept",
                                               "hyper_accept"))):
        raise AssertionError(f"surrogate exact on 1x4: {exact}")
    del net_d, net_e, res_e, res_0, exact_runs, pots, peers, peers_e, \
        k3_mesh, th, et
    torch.cuda.empty_cache()

    # (d) multiclass tempered on 1x2: the plain main block
    temp_kw = dict(n_chains=64, tempering=4, tempering_beta_min=0.5,
                   chain_jitter=0.01)
    mcmc = cls_mcmc("multiclass")
    tmp = {label: train(f"multiclass tempered, {label}", multiclass_network,
                        mcmc, 3, m, use_fused=False, **temp_kw)
           for label, m in (("meshless", None), ("1x2", mesh(1, 2)))}
    (t0_, _, _), (t1_, _, _) = tmp["meshless"], tmp["1x2"]
    auto, auto_counts, _ = train("multiclass tempered on 1x2, kernels",
                                 multiclass_network, mcmc, 3, mesh(1, 2),
                                 **temp_kw)
    swaps_equal = bool((t1_.swap_accept_rung == t0_.swap_accept_rung).all())
    out["multiclass_tempered_1x2"] = {
        "main_path": t1_.main_path,
        "swap_rate_rung": t1_.swap_accept_rung.tolist(),
        "meshless_swap_rate_rung": t0_.swap_accept_rung.tolist(),
        "swap_decisions_equal": swaps_equal,
        "main_accept": t1_.main_accept.tolist(),
        "meshless_main_accept": t0_.main_accept.tolist(),
        "with_kernels": {"main_path": auto.main_path,
                         "fused_hyper": auto.fused_hyper,
                         "launches": auto_counts,
                         "swap_rate_rung": auto.swap_accept_rung.tolist()}}
    print(f"(d) multiclass 64 x 4 rungs on 1x2 ({card}): "
          f"{json.dumps(out['multiclass_tempered_1x2'])}", flush=True)
    if (t1_.main_path != "plain" or not swaps_equal
            or auto.main_path != "plain" or not auto.fused_hyper
            or auto_counts != {"K1": 0, "K2": 3, "K3": 0}
            or not np.isfinite(auto.swap_accept_rung).all()):
        raise AssertionError(f"multiclass tempered on 1x2: "
                             f"{out['multiclass_tempered_1x2']}")

    # (e) the predict cell on 2x2, on both routes
    out["predict_2x2"] = predict_mesh_phase(dev)

    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"mesh": out}), flush=True)
    return out


def same_bits(got, want, what: str) -> None:
    """Raises unless two NamedTuples of tensors (or None) are equal bit for
    bit, NaNs included."""
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        if (g is None) != (w is None):
            raise AssertionError(f"{what}: {field} is None on one side only")
        if g is None:
            continue
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {field} differs")


def graph_cells(dev):
    """Phase 12's cells: each K1 cell of phase 6 at its chains, hyper
    steps and hyper step size; two chunks' (eps, L) (``a``, ``b``: shared,
    per chain in 4 groups, or a U-turn run's per-epoch counts), the chunk
    length of the steady window, its epochs (``steady``, else
    ``GRAPH_STEADY``) and the profiled epochs."""
    from tensorbnn_tpu_torch.sampler.tempering import make_ladder

    rng = np.random.default_rng(12)
    g_eps, g_l = rung_groups(512)
    t_eps, t_l = rung_groups(2048)
    flip = lambda e, l: (e[::-1].copy(), l[::-1].copy())  # noqa: E731
    cls, multi = CLS_CELLS["classification"], CLS_CELLS["multiclass"]
    return [
        dict(name="flagship 64", build=lambda: flagship_network(dev),
             chains=64, hyper=(30, 1e-3), chunk=10, prof=10,
             a=(2e-3, 100), b=(1e-3, 120)),
        dict(name="G = 4 512", build=lambda: flagship_network(dev, seed=11),
             chains=512, hyper=(30, 1e-3), chunk=10, prof=10,
             a=(g_eps, g_l), b=flip(g_eps, g_l)),
        dict(name="tempered 512 x 4",
             build=lambda: flagship_network(dev, seed=11), chains=2048,
             hyper=(30, 1e-3), chunk=10, prof=10,
             tempering=(4, np.repeat(make_ladder(4, 0.5), 512)),
             a=(t_eps, t_l), b=flip(t_eps, t_l)),
        dict(name="U-turn 512 alternate",
             build=lambda: flagship_network(dev, seed=11), chains=512,
             hyper=(30, 1e-3), chunk=50, prof=50, uturn=True,
             a=(3e-3, rng.integers(20, 201, 50)),
             b=(2e-3, rng.integers(20, 201, 50))),
        # its eager epoch takes 0.18-0.36 s (the plain hyper block): short
        # chunks, one of them steady
        dict(name="classification 128",
             build=lambda: classification_network(dev), chains=CLS_CHAINS,
             hyper=(cls["hyper_steps"], 1e-4), chunk=5, prof=5, steady=5,
             a=(cls["eps"], cls["steps"]), b=CLS_GROUPS[1]),
        dict(name="multiclass 128", build=lambda: multiclass_network(dev),
             chains=CLS_CHAINS, hyper=(multi["hyper_steps"], 1e-4),
             chunk=50, prof=50, a=(multi["eps"], multi["steps"]),
             b=(5e-3, 30)),
    ]


def stepped_cells(dev, warm=None):
    """Phase 12's cells on the stepped runner (K3 or the plain main block:
    a head, a step and a tail graph an epoch, the step replayed L times):
    ``wide_deep`` at 64 chains (K3, K2's coupled block) with a shared and
    a per-chain count in four groups (masked); the tutorial-shaped
    classifier at 64 chains (K3, the plain hyper block at 30 steps); the
    1M-point surrogate at 32 chains under exact numerics (the plain path,
    the Kahan leapfrog, ``data_chunk``, a diagonal metric) and under
    default numerics (K3 over 125,000-row chunks, K2), from the MAP
    warm start ``warm`` (pretrained here when None), in chunks of one
    epoch, one steady and one profiled. Each spec's ``make(net, lik, flat, eager,
    mesh)`` builds its runner, and ``scale(d)`` gives its step scale."""
    from tensorbnn_tpu_torch.sampler.driver import exact_numerics_model

    data = {}

    def surrogate_net():
        # the 1M rows and the warm start, made at the first cell that
        # needs them
        if not data:
            data["x"], data["y"] = surrogate_data()
            data["warm"] = warm if warm is not None else surrogate_pretrain(
                dev, data["x"], data["y"])
        return surrogate_network(dev, data["x"], data["y"], data["warm"],
                                 200)

    w_eps, w_l = (np.repeat(np.asarray(v), 16) for v in zip(*WIDE_GROUPS))
    w_eps = w_eps.astype(np.float32)
    flip = lambda e, l: (e[::-1].copy(), l[::-1].copy())  # noqa: E731

    def scale(d):
        # a diagonal metric's step scale over the surrogate's d weights
        return torch.as_tensor(np.random.default_rng(4).uniform(
            0.5, 1.5, d).astype(np.float32), device=dev)

    def surrogate(exact):
        def make(net, lik, flat, eager, mesh):
            if exact:
                return surrogate_runner(
                    net, lik, flat, exact_numerics_model(net.model),
                    SURR_CHUNK, True, eager=eager, n_chains=SURR_CHAINS,
                    mesh=mesh)
            return chunk_runner(net, lik, flat, SURR_MCMC["hyper_leapfrog"],
                                SURR_MCMC["hyper_step_size"], eager=eager,
                                n_chains=SURR_CHAINS, data_chunk=SURR_CHUNK,
                                mesh=mesh)
        return make

    surr = dict(build=surrogate_net, chains=SURR_CHAINS, chunk=1, prof=1,
                steady=1, a=(5e-7, 10), b=(4e-7, 15), runner="stepped")
    return [
        dict(name="wide_deep 64", build=lambda: wide_network(dev),
             chains=64, hyper=(5, 1e-4), chunk=10, prof=10, steady=20,
             a=(1e-5, 20), b=(1e-5, 25), runner="stepped",
             max_launches=20 + STEPPED_LAUNCHES_OVER_L),
        dict(name="wide_deep 64 G = 4", build=lambda: wide_network(dev),
             chains=64, hyper=(5, 1e-4), chunk=10, prof=10, steady=20,
             a=(w_eps, w_l), b=flip(w_eps, w_l), runner="stepped"),
        dict(name="tutorial 64", build=lambda: tutorial_network(dev),
             chains=64, hyper=(30, 1e-4), chunk=2, prof=1, steady=2,
             a=(1e-3, 50), b=(1e-3, 40), runner="stepped"),
        dict(surr, name="surrogate 32 exact", make=surrogate(True),
             scale=scale),
        dict(surr, name="surrogate 32 default", make=surrogate(False),
             peak_over_eager=STEPPED_PEAK_OVER_EAGER),
    ]


def compare_runners(dev, spec, mesh=None) -> dict:
    """One cell of ``graph_cells`` or ``stepped_cells`` (over ``mesh``,
    None: no mesh) through the eager and the graph runner (the cell's
    ``runner``: "graph" of the chunk, or "stepped"), from one carry and
    one generator seed: two chunks whose (eps, L) differ, held bit for bit
    (carry, every trace and the generator's state); then the cell's steady
    epochs in chunks of its length, their host ms an epoch (the host clock
    around work ending in a synchronize), and one profiled chunk: the
    card's busy ms an epoch, the idle share (1 - busy / host ms) and the
    host's launches an epoch (kernel and graph launches, copies and
    fills); each runner's peak memory over what the process held before
    it (``max_memory_allocated``, the cache emptied first); with the graph
    runner's captures (one a chain shard; the stepped runner's three) and
    their ms. Returns the cell's row."""
    from tensorbnn_tpu_torch.parallel import graphs
    from tensorbnn_tpu_torch.parallel.chains import init_multichain_state
    from tensorbnn_tpu_torch.sampler.potential import flatten_state

    net, lik = spec["build"]()
    params, hypers = net.init_state()
    flat = flatten_state(params, hypers, lik.init_hypers(device=dev))
    hyper_steps, hyper_eps = spec.get("hyper", (
        SURR_MCMC["hyper_leapfrog"], SURR_MCMC["hyper_step_size"]))
    n, uturn = spec["chunk"], spec.get("uturn", False)
    steady = spec.get("steady", GRAPH_STEADY)
    scale = spec["scale"](flat.theta.numel()) if "scale" in spec else None
    shards = 1 if mesh is None else len(mesh.devices)
    n_data = 1 if mesh is None else len(mesh.devices[0])
    graph_kind = spec.get("runner", "graph")
    row, chunks = {"chains": spec["chains"], "chunk": n,
                   "steady_epochs": steady, "chain_shards": shards,
                   "data_peers": n_data, "runner": graph_kind}, {}
    make = spec.get("make") or (
        lambda net, lik, flat, eager, mesh: chunk_runner(
            net, lik, flat, hyper_steps, hyper_eps, spec.get("tempering"),
            record_uturn=uturn, eager=eager, per_epoch_leapfrog=uturn,
            mesh=mesh, n_chains=spec["chains"]))
    for kind in ("eager", graph_kind):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        run = make(net, lik, flat, kind == "eager", mesh)
        assert run.runner == kind, (run.runner, kind)
        graphs.COUNTS.reset()
        gen = torch.Generator(device=dev).manual_seed(12)
        carry = init_multichain_state(
            flat.theta, flat.eta, hyper_eps, spec["chains"],
            torch.Generator(device=dev).manual_seed(13), jitter=0.01)
        got = []
        for eps, leap in (spec["a"], spec["b"]):
            carry, trace = run(carry, eps, leap, n, gen, step_scale=scale)
            got.append((carry, trace))
        torch.cuda.synchronize()
        chunks[kind] = (got, gen.get_state())
        eps, leap = spec["a"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steady // n):
            carry, _ = run(carry, eps, leap, n, gen, step_scale=scale)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / steady
        if not torch.isfinite(carry.theta).all():
            raise AssertionError(f"{spec['name']}: the chains left the "
                                 f"finite range")
        prof = spec["prof"]
        events = trace_events(lambda: run(carry, eps, leap[:prof] if
                                          uturn else leap, prof, gen,
                                          step_scale=scale))
        busy = busy_ms(device_events(None, events=events)) / prof
        row[kind] = {
            "host_ms_per_epoch": host_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / host_ms,
            "host_launches_per_epoch": host_launches(events) / prof,
            "host_launches_by_call": host_launch_calls(events, prof),
            "device_ops_per_epoch": len(device_events(
                None, events=events)) / prof,
            "peak_bytes": torch.cuda.max_memory_allocated() - held,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            **({"captures": graphs.COUNTS.captures,
                "capture_ms": [1e3 * t for t in
                               graphs.COUNTS.capture_seconds],
                "replays": graphs.COUNTS.replays,
                "copies": graphs.COUNTS.copies}
               if kind != "eager" else {})}
        del run, carry, got, trace
    (g_chunks, g_state), (e_chunks, e_state) = (chunks[graph_kind],
                                                chunks["eager"])
    for j, ((cg, tg), (ce, te)) in enumerate(zip(g_chunks, e_chunks)):
        same_bits(cg, ce, f"{spec['name']} chunk {j} carry")
        same_bits(tg, te, f"{spec['name']} chunk {j} trace")
    if not torch.equal(g_state, e_state):
        raise AssertionError(f"{spec['name']}: the generators' states "
                             f"differ")
    row["bit_equal"] = True
    g, e = row[graph_kind], row["eager"]
    # one capture a key and chain shard: the chunk length (whole-chunk
    # graphs) and, for the classification stack's plain hyper block, one
    # epoch; the stepped runner's head, step and tail, whatever the
    # chunk's length and L, and over data peers a home segment and a
    # graph a peer at each of their sums
    per_shard = 3 if graph_kind == "stepped" else 1
    max_launches = spec.get("max_launches")
    if n_data > 1:
        per_shard += (2 + DATA_TAIL_SUMS) * (n_data + 1)
        n_leap = int(np.max(spec["a"][1]))
        sums = n_leap + 1 + DATA_TAIL_SUMS
        max_launches = (n_leap + 2 + STEPPED_LAUNCHES_OVER_L
                        + math.ceil(DATA_CHUNK_LAUNCHES / n) + sums * (
                            1 + n_data + DATA_COPIES_A_PEER * (n_data - 1)))
        row["max_host_launches_per_epoch"] = shards * max_launches
    if g["captures"] != per_shard * shards:
        raise AssertionError(f"{spec['name']}: {g['captures']} captures "
                             f"for one chunk key over {shards} shards")
    if g["host_launches_per_epoch"] >= e["host_launches_per_epoch"]:
        raise AssertionError(f"{spec['name']}: the graph runner issues "
                             f"no fewer host launches an epoch: {row}")
    if max_launches is not None and g["host_launches_per_epoch"] > \
            shards * max_launches:
        raise AssertionError(f"{spec['name']}: more than "
                             f"{max_launches} host launches an "
                             f"epoch a shard: {row}")
    if "peak_over_eager" in spec and g["peak_bytes"] > \
            spec["peak_over_eager"] * e["peak_bytes"]:
        raise AssertionError(f"{spec['name']}: peak memory over "
                             f"{spec['peak_over_eager']}x the eager "
                             f"runner's: {row}")
    where = "" if mesh is None else f" on {shards}x{n_data}"
    print(f"{spec['name']}{where}: {graph_kind} and eager runners bit-equal "
          f"over two chunks of {n}; host ms/epoch "
          f"{e['host_ms_per_epoch']:.3f} eager, "
          f"{g['host_ms_per_epoch']:.3f} {graph_kind}; host launches an "
          f"epoch {e['host_launches_per_epoch']:.1f} eager, "
          f"{g['host_launches_per_epoch']:.1f} {graph_kind}; idle share "
          f"{e['idle_share']:.2f} eager, {g['idle_share']:.2f} "
          f"{graph_kind}; peak GB {e['peak_bytes'] / 1e9:.3f} eager, "
          f"{g['peak_bytes'] / 1e9:.3f} {graph_kind}; captures "
          f"{g['captures']} ({', '.join(f'{t:.0f}' for t in g['capture_ms'])}"
          f" ms)", flush=True)
    del net, chunks, g_chunks, e_chunks
    torch.cuda.empty_cache()
    return row


def run_cells(cells) -> dict:
    """``compare_runners`` over ``cells``, ``(label, spec, mesh)`` each;
    a cell that fails does not stop the next, and the phase raises at
    its end with every cell's failure."""
    out, failed = {}, []
    for label, spec, mesh in cells:
        try:
            out[label] = compare_runners(spec["dev"], spec, mesh)
        except AssertionError as err:
            print(f"{label}: FAILED: {err}", flush=True)
            failed.append(f"{label}: {err}")
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def graph_phase(dev, card, warm=None) -> dict:
    """Phase 12: each cell of ``graph_cells`` through the eager and the
    graph runner, and each of ``stepped_cells`` (the surrogate's from the
    MAP warm start ``warm``) through the eager and the stepped runner,
    without a mesh (``compare_runners``)."""
    return {"card": card, **run_cells(
        (spec["name"], dict(spec, dev=dev), None)
        for spec in graph_cells(dev) + stepped_cells(dev, warm))}


def data_mesh_cells(dev, warm=None):
    """Phase 13's data-mesh cells (``MESH_DATA_CELLS``): ``wide_deep`` at
    64 chains (K3 on each peer's rows, K2's coupled block) as phase 12
    runs it; ``multiclass`` tempered at 64 chains x 4 rungs (beta_min
    0.5; the plain main block, K2), the bench's (eps, L) and (5e-3, 30),
    chunks of 2, 4 steady epochs; the 1M-point surrogate at 32 chains
    under exact and default numerics (K3 on 250,000 rows a peer), from
    the MAP warm start ``warm`` (pretrained here when None), at (eps, L)
    = (5e-7, 10) and (4e-7, 15) as phase 12 runs it, in chunks of one
    epoch, one steady and one profiled: four epochs a runner."""
    from tensorbnn_tpu_torch.sampler.tempering import make_ladder

    multi = CLS_CELLS["multiclass"]
    cells = {spec["name"]: spec for spec in stepped_cells(dev, warm)
             if spec["name"] in MESH_DATA_CELLS}
    cells["multiclass tempered 64 x 4"] = dict(
        name="multiclass tempered 64 x 4",
        build=lambda: multiclass_network(dev), chains=256,
        hyper=(multi["hyper_steps"], 1e-4), chunk=2, prof=2, steady=4,
        tempering=(4, np.repeat(make_ladder(4, 0.5), 64)),
        a=(multi["eps"], multi["steps"]), b=(5e-3, 30), runner="stepped")
    return [dict(cells[name], mesh=shape)
            for name, shape in MESH_DATA_CELLS.items()]


def mesh_graph_phase(dev, card, warm=None) -> dict:
    """Phase 13: the cells of ``MESH_GRAPH_CELLS`` through the eager and
    the graph runner over a chains-only mesh whose entries are all this
    card (a graph a chain shard, the stepped runner's three), then those
    of ``data_mesh_cells`` through the eager and the stepped runner over
    a ``(chains, data)`` mesh of this card (each part split at its sums
    over the data peers; ``compare_runners``)."""
    from tensorbnn_tpu_torch.parallel.mesh import make_mesh

    cells = [(spec, (MESH_GRAPH_CELLS[spec["name"]], 1))
             for spec in graph_cells(dev) + stepped_cells(dev)[:1]
             if spec["name"] in MESH_GRAPH_CELLS]
    cells += [(spec, spec["mesh"]) for spec in data_mesh_cells(dev, warm)]
    return {"card": card, **run_cells(
        (f"{spec['name']} on {k}x{n}", dict(spec, dev=dev),
         make_mesh(k, n, devices=[dev] * (k * n)))
        for spec, (k, n) in cells)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # --surrogate-only / --mesh-only / --graph-only / --mesh-graph-only /
    # --pretrain-only / --predict-only / --quality-only / --moons-only:
    # phases 1, 2 and 10 / 11 / 12 / 13 / 9 / 7 (e) and 11 (e) / 6's three
    # seed bands (G = 4, tempered, U-turn "always") / 6 (e)'s moons ladder
    # alone (a quick check of that phase; no kernels line)
    surrogate_only = argv == ["--surrogate-only"]
    mesh_only = argv == ["--mesh-only"]
    graph_only = argv == ["--graph-only"]
    mesh_graph_only = argv == ["--mesh-graph-only"]
    pretrain_only = argv == ["--pretrain-only"]
    predict_only = argv == ["--predict-only"]
    quality_only = argv == ["--quality-only"]
    moons_only = argv == ["--moons-only"]
    if argv and not (surrogate_only or mesh_only or graph_only
                     or mesh_graph_only or pretrain_only or predict_only
                     or quality_only or moons_only):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
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
    from tensorbnn_tpu_torch.io import fast_text
    t0 = time.perf_counter()
    # the host text store's g++ runs beside the kernels' nvcc (one process
    # a source, all started together)
    text_build = fast_text.start_build()
    _build.load(verbose=True)
    native_text = fast_text.finish_build(text_build)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s); native text store "
          f"{native_text}")

    counted = {"K1": fused_mlp.fused_trajectory,
               "K2": fused_hyper.fused_hyper_trajectory,
               "K3": fused_mlp.fused_potential}

    from tensorbnn_tpu_torch.parallel import graphs

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.LAUNCHES = 0
        graphs.COUNTS.reset()

    def read_counts(path):
        # a replay adds the launches its graph captured: the counts read as
        # the eager runner's; the graph runner's own counts on a line of
        # their own
        torch.cuda.synchronize()
        got = {name: fn.LAUNCHES for name, fn in counted.items()}
        print(f"launches during the {path} path: {got}")
        if graphs.COUNTS.captures:
            print(f"graph runner during the {path} path: "
                  f"{json.dumps(graphs.COUNTS.as_dict())}")
        return got

    if predict_only:
        phase("7 (e) the predict cell on both routes")
        net, lik = flagship_network(dev)
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            print(json.dumps({"predict": predict_phase(
                dev, tmp, net.train_x, net.train_y, lik)}))
        phase("11 (e) the predict cell on 2x2 on both routes")
        print(json.dumps({"predict_2x2": predict_mesh_phase(dev)}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if moons_only:
        phase("6 (e) the moons stack's same-state acceptance ladder")
        moons_ladder_cell(dev, card, reset_counts, read_counts)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if quality_only:
        phase("6 (b) the G = 4 quality block over seeds "
              f"{G4_SEEDS[0]}-{G4_SEEDS[-1]}")
        reset_counts()
        net, res, wall = g4_run(dev, G4_SEEDS[0])
        launches = read_counts("G = 4 quality block (K1 + K2)")
        assert min(launches["K1"], launches["K2"]) >= 1, launches
        g4_band(dev, quality("512 chains, G = 4", net, res, wall,
                             ESS_RUN["burnin"], seed=G4_SEEDS[0]))
        d = res.theta_samples.shape[2]
        del net, res
        phase("6 (c) the tempered quality block over seeds "
              f"{TEMPERED_SEEDS[0]}-{TEMPERED_SEEDS[-1]}")
        tempered_block(dev, d, reset_counts, read_counts)
        phase("6 (g) the U-turn quality block, probe always, over seeds "
              f"{UTURN_SEEDS[0]}-{UTURN_SEEDS[-1]}")
        uturn_block(dev, d, "always", reset_counts, read_counts)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if graph_only or mesh_graph_only:
        if graph_only:
            phase("12 the graph chunk runner against the eager runner")
            print(json.dumps({"graph": graph_phase(dev, card)}))
        else:
            phase("13 the mesh graph runner against the eager mesh runner")
            print(json.dumps({"mesh_graph": mesh_graph_phase(dev, card)}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if surrogate_only or mesh_only or pretrain_only:
        x, y = surrogate_data()
        if pretrain_only:
            phase("9 pretraining, the shim and the examples on the card")
            pretrain_phase(dev, card, x, y, reset_counts, read_counts)
        elif surrogate_only:
            warm = surrogate_pretrain(dev, x, y)
            phase("10 the 1M-point surrogate on the card")
            surrogate_phase(dev, card, x, y, warm, reset_counts, read_counts)
        else:
            warm = surrogate_pretrain(dev, x, y)
            phase("11 the mesh on the card")
            mesh_phase(dev, card, x, y, warm, reset_counts, read_counts)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

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
        (MOONS_K1_LABEL, *moons_network(dev), 1,
         MOONS_MCMC["step_size_start"], MOONS_MCMC["leapfrog_max"]),
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
    # every path of K1's layer table (fused_paths_network), per-chain L in
    # {1, 2, 3, 40}, with its own generator
    fp_net, fp_lik = fused_paths_network(dev)
    prog, kflat = k1d_program(fp_net, fp_lik)
    args = k1d_inputs(fp_net, kflat, 64, torch.Generator(
        device=dev).manual_seed(9))
    eps_c, l_c = (torch.tensor(np.repeat(v, 16), device=dev) for v in (
        np.float32([1e-3, 2e-3, 5e-3, 1e-2]), np.int32([1, 2, 3, 40])))
    got = fused_mlp.fused_trajectory(prog, *args, eps_c, l_c)
    want = fused_mlp.trajectory_plain(prog, *args, eps_c, l_c)
    torch.cuda.synchronize()
    compare(f"K1 fused paths (elu, relu, sigmoid, exp; "
            f"{prog.barriers_per_step} barriers a step) C=64 L in (1, 2, 3, "
            f"40)", got, want, K1_TOL)

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
                                               device=dev), gen)
                for c in (64, 512)]
    k2_cases += [
        ("K2 coupled learned-sd flagship C=64 H=17 n_steps=30", lnet0,
         llik0, lflat, 30, 1e-2, True, l_thetas, l_etas, gen),
        ("K2 coupled wide_deep C=64 H=41 n_steps=5", wnet, wlik, wflat, 5,
         1e-4, True, w_thetas, w_etas, gen)]
    # the tempered block's hyper shape (2,048 replicas, 30 steps), and the
    # widest table (16 blocks, 32 items), from a generator of their own
    k2_gen = torch.Generator(device=dev).manual_seed(13)
    snet, slik = stack_network(dev, 16)
    sparams, shypers = snet.init_state()
    sflat = flatten_state(sparams, shypers, {})
    for label, knet, klik, kflat, c, n_steps in (
            ("K2 tempered C=2048 n_steps=30", net, lik, flat, 2048, 30),
            ("K2 16 blocks C=64 H=64 n_steps=100", snet, slik, sflat, 64,
             100)):
        kd, kh = kflat.theta.numel(), kflat.eta.numel()
        k2_cases.append((
            label, knet, klik, kflat, n_steps, 1e-3, False,
            kflat.theta + 0.1 * torch.randn((c, kd), generator=k2_gen,
                                            device=dev),
            kflat.eta + 0.05 * torch.randn((c, kh), generator=k2_gen,
                                           device=dev), k2_gen))
    k2_err = 0.0
    k2_shapes = {}
    for label, knet, klik, kflat, n_steps, eps, coupled, thetas, etas, \
            kgen in k2_cases:
        c, kh = etas.shape
        prog = fused_hyper.build_hyper_program(knet.model, klik,
                                               kflat.unravel_eta, kh, n_steps)
        assert prog is not None and prog.coupled == coupled, label
        stats_fn, _, _ = make_stats_hyper(knet.model, klik, knet.train_x,
                                       knet.train_y, kflat.unravel_theta,
                                       kflat.unravel_eta, kh)
        args = (etas, stats_fn(thetas),
                torch.randn((c, kh), generator=kgen, device=dev),
                torch.full((c,), eps, device=dev))
        got = fused_hyper.fused_hyper_trajectory(prog, *args)
        want = fused_hyper.hyper_trajectory_plain(prog, *args)
        torch.cuda.synchronize()
        k2_err = max(k2_err, compare(
            f"{label} ({len(prog.items)} items on {prog.lanes} lanes a "
            f"chain)", got, want, K2_TOL))
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
    split_ops = (("dense", 50, 7), ("sqprelu", 7), ("dense", 7, 3),
                 ("dense", 3, 1), ("sigmoid", 1))
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
        # both new paths with ragged edges everywhere: the packed first
        # layer (C d_out = 21 columns) and every row sum split into uneven
        # slices of the 3,001 rows
        "K3 Bernoulli + sqprelu ragged 50-7-3-1 C=3 N=3001": (
            split_ops, "bernoulli", 3,
            torch.tensor(dg.normal(size=(3001, 50)), dtype=torch.float32,
                         device=dev),
            torch.tensor(dg.random(3001) > 0.5, dtype=torch.float32,
                         device=dev)),
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
        print(f"{label}: plan {vg.args[0].plan(c).layers}")
    split_plan = k3_shapes["K3 Bernoulli + sqprelu ragged 50-7-3-1 C=3 "
                           "N=3001"][0].args[0].plan(3).layers
    assert split_plan[0][0] == 1 and all(
        row[1] > 1 for row in split_plan) and split_plan[0][3] > 1, split_plan
    # the split row sums add their slices in a fixed order: two calls on the
    # same inputs give bit-equal results at the tutorial shape
    tut_label = f"K3 Bernoulli + sqprelu tutorial C=64 N={TUTORIAL_ROWS}"
    vg, _, thetas, sd_c, xs, ys = k3_shapes[tut_label]
    first, second = vg(thetas, sd_c, xs, ys), vg(thetas, sd_c, xs, ys)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{tut_label}: two calls on the same inputs "
                             f"differ")
    print(f"{tut_label}: two calls bit-equal (ll and grad)")
    # K1 declines the tutorial and digits shapes (their planes are past one
    # block's shared memory); the driver takes K3 for them
    tparams, thypers = tut_net.init_state()
    tflat = flatten_state(tparams, thypers, {})
    he_err = he_init_check(tut_net, tut_lik, tflat, dev)
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


    # (b) the flagship on K1 + K2: 64 chains at the verify recipe, and the
    # 512-chain, G = 4 quality block at ess_run's settings; launches
    # counted from here
    reset_counts()
    net5, lik5 = flagship_network(dev, seed=0)
    net5.setup_mcmc(**RECIPE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net5.train(800, 10, lik5, n_chains=64, verbose=False)
    torch.cuda.synchronize()
    runs = {64: (net5, res, time.perf_counter() - t0, RECIPE["burnin"]),
            512: (*g4_run(dev, G4_SEEDS[0]), ESS_RUN["burnin"])}
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
    first = quality("512 chains, G = 4", net512, res512, wall512,
                    ESS_RUN["burnin"], seed=G4_SEEDS[0])
    del net512, res512
    # the same block at the other seeds, and the band against the JAX
    # package's seeds (after the counts were read)
    g4_band(dev, first)

    # (c) the tempered quality block: 512 cold chains x 4 rungs at beta_min
    # 0.5 (2,048 replicas, one adapter per rung) on tempered K1 + K2, then
    # the same block at the other seeds and their band against the JAX
    # package's seeds (after the counts were read)
    tempered_launches = tempered_block(dev, d, reset_counts, read_counts)
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
        # chunks of the warm-up's length: the graph runner captured that
        # one before the window
        for _ in range(5):
            ccarry, _ = crun(ccarry, cfg["eps"], cfg["steps"], 2, gen)
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

    # (e) then the moons stack's same-state acceptance ladder on K1 (d) and
    # the plain hyper block, held to the JAX package's figures
    moons_ladder = moons_ladder_cell(dev, card, reset_counts, read_counts)

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
    uturn_launches = {probe: uturn_block(dev, d, probe, reset_counts,
                                         read_counts)
                      for probe in ("alternate", "always")}

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

    phase("7 store, resume and Predictor on the card")
    store_phase(dev, reset_counts, read_counts)

    phase("8 times")
    times = {}
    # each K1 shape's evaluations along its longest trajectory (max L + 1),
    # which set its time: K1 is bound by a step's latency; and the barriers
    # of one step that computes no value, counted from its layer table
    k1_evals, k1_barriers, k1_device = {}, {}, {}
    for label, (prog, args, eps_c, l_c) in k1_shapes.items():
        ms = cuda_ms(lambda: fused_mlp.fused_trajectory(prog, *args, eps_c,
                                                        l_c))
        plain = cuda_ms(lambda: fused_mlp.trajectory_plain(prog, *args,
                                                           eps_c, l_c))
        times[label] = (ms, plain, None)
        k1_evals[label] = int(l_c.max()) + 1
        k1_barriers[label] = prog.barriers_per_step
        k1_device[label] = device_ms(lambda: fused_mlp.fused_trajectory(
            prog, *args, eps_c, l_c))
    for c, (args, eps_c, l_c, betas) in k1t_shapes.items():
        ms = cuda_ms(lambda: fused_mlp.fused_trajectory(t_program, *args,
                                                        eps_c, l_c, betas))
        plain = cuda_ms(lambda: fused_mlp.trajectory_plain(
            t_program, *args, eps_c, l_c, betas))
        label = f"K1 tempered C={c} per-rung (eps, L)"
        times[label] = (ms, plain, None)
        k1_evals[label] = int(l_c.max()) + 1
        k1_barriers[label] = t_program.barriers_per_step
        k1_device[label] = device_ms(lambda: fused_mlp.fused_trajectory(
            t_program, *args, eps_c, l_c, betas))
    # K2 at each of its phase 4 shapes, with its device time (a K2 call is
    # shorter than its host's enqueue); the twin of the two widest shapes
    # over 3 calls
    k2_device = {}
    for label, (prog, args) in k2_shapes.items():
        ms = cuda_ms(lambda: fused_hyper.fused_hyper_trajectory(prog, *args))
        plain = cuda_ms(lambda: fused_hyper.hyper_trajectory_plain(prog,
                                                                   *args),
                        reps=3 if label.startswith(("K2 tempered",
                                                    "K2 16 blocks")) else 10)
        times[label] = (ms, plain, None)
        k2_device[label] = device_ms(
            lambda: fused_hyper.fused_hyper_trajectory(prog, *args))
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
        k1_evals[label] = int(l_c.max()) + 1
        k1_barriers[label] = prog.barriers_per_step
        k1_device[label] = device_ms(lambda: fused_mlp.fused_trajectory(
            prog, *args, eps_c, l_c))
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
              + ("" if func_ms is None else f", torch.func {func_ms:.4f} ms")
              + ("" if label not in k1_evals else
                 f", {1e3 * ms / k1_evals[label]:.3f} us per evaluation "
                 f"(max L + 1 = {k1_evals[label]}), "
                 f"{k1_barriers[label]} barriers a step, device "
                 f"{k1_device[label]:.4f} ms")
              + ("" if label not in k2_device else
                 f", device {k2_device[label]:.4f} ms"))
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
        uturn_times[c]["us_per_eval"] = 1e3 * on_ms / (steps + 1)
        print(f"K1 record_uturn C={c} (eps, L)=({eps}, {steps}): kernel "
              f"{on_ms:.4f} ms ({1e3 * on_ms / (steps + 1):.3f} us per "
              f"evaluation) against {off_ms:.4f} ms without recording "
              f"({100 * (on_ms / off_ms - 1):+.1f}%; a, e, e, a: "
              f"{', '.join(f'{t:.4f}' for t in rec)}), plain {plain:.4f} "
              f"ms, bound {ub[0]:.5f} ms ({ub[1]}), "
              f"{u_program.barriers_per_step} barriers a step")

    # steady main-chain leapfrog rate at 64 chains, (eps, L) = (1e-3, 100),
    # hyper_leapfrog 100 (the bench's shape), kernels on
    run = chunk_runner(net, lik, flat, 100, 1e-3)
    carry = init_multichain_state(flat.theta, flat.eta, 1e-3, 64, gen,
                                  jitter=0.01)
    carry, _ = run(carry, 1e-3, 100, 10, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_epochs = 0
    # chunks of the warm-up's length: the graph runner captured that one
    # before the window
    for _ in range(10):
        carry, trace = run(carry, 1e-3, 100, 10, gen)
        n_epochs += 10
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
    k1t_label = "K1 tempered C=2048 per-rung (eps, L)"
    k1t_ms, k1t_plain, _ = times[k1t_label]
    t_evals = float((k1t_shapes[2048][2].to(torch.float64) + 1).sum())
    k1t_bound = bound(t_evals * (product_flops(program.ops, 11) + 7 * d),
                      4 * (4 * 2048 * d + 2048 * h + 11 * 2 + 5 * 2048))
    # K1 (d) at each of its shapes (k1_shape_bound); the kernels line
    # reports it at the classification cell's, C = 128, (5e-4, 50)
    k1d_label = "K1 (d) classification C=128 (eps, L)=(0.0005, 50)"
    k1d_ms, k1d_plain, _ = times[k1d_label]
    k1d_bounds = {label: k1_shape_bound(prog, args, l_c)
                  for label, (prog, args, _, l_c) in k1d_shapes.items()}
    k1d_bound = k1d_bounds[k1d_label]
    for label, (b_ms, b_by) in k1d_bounds.items():
        print(f"{label}: bound {b_ms:.5f} ms ({b_by}), kernel "
              f"{times[label][0]:.4f} ms")
    # K3 at its digits and flagship shapes (k3_shape_bound)
    k3_bounds = {label: k3_shape_bound(k3_shapes[label][1],
                                       k3_shapes[label][2],
                                       k3_shapes[label][4])
                 for label in ("K3 categorical digits 64-20-10 C=64 N=1437",
                               "K3 flagship C=64 N=11")}
    for label, (b_ms, b_by) in k3_bounds.items():
        print(f"{label}: bound {b_ms:.5f} ms ({b_by}), kernel "
              f"{times[label][0]:.4f} ms")
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
         "bound_by": k1_bound[1], "library_ms": None,
         "us_per_eval": 1e3 * k1_ms / 101},
        {"name": "K2 fused_hyper", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_hyper.cu",
         "replaces": "tensorbnn_tpu/ops/fused_hyper.py:108",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "device_ms": k2_device["K2 C=64 n_steps=100"],
         "shapes_device_ms": k2_device},
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
         "bound_by": k1t_bound[1], "library_ms": None,
         "us_per_eval": 1e3 * k1t_ms / k1_evals[k1t_label]},
        # ms at C = 512, L = 200; launches in the "alternate" U-turn block
        {"name": "K1 fused_trajectory (record_uturn)", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_trajectory.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:449",
         "launches": uturn_launches["alternate"]["K1"],
         "max_abs_err": k1u_err, **{k: uturn_times[512][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "us_per_eval": uturn_times[512]["us_per_eval"],
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
         "library_ms": None, "us_per_eval": 1e3 * k1d_ms / 51,
         "shapes_ms": {k: v[0] for k, v in times.items()
                       if k.startswith("K1 (d)")},
         "shapes_bound_ms": {k: v[0] for k, v in k1d_bounds.items()},
         "moons_ladder_launches": moons_ladder["launches"]["K1"]},
        # ms at the tutorial shape, launches in its 6-epoch run
        {"name": "K3 fused_potential (Bernoulli tail)", "route": "cuda",
         "source": "tensorbnn_tpu_torch/csrc/fused_potential.cu",
         "replaces": "tensorbnn_tpu/ops/fused_mlp.py:239",
         "launches": tut_launches["K3"], "max_abs_err": k3t_err,
         "ms": tut_ms, "plain_ms": tut_plain, "bound_ms": tut_bound[0],
         "bound_by": tut_bound[1], "library_ms": tut_plain,
         "digits_categorical_ms": times[
             "K3 categorical digits 64-20-10 C=64 N=1437"][0],
         "flagship_ms": times["K3 flagship C=64 N=11"][0],
         "digits_categorical_bound_ms": k3_bounds[
             "K3 categorical digits 64-20-10 C=64 N=1437"][0],
         "flagship_bound_ms": k3_bounds["K3 flagship C=64 N=11"][0],
         "plan": k3_shapes[tut_label][0].args[0].plan(64).layers,
         "he_init_grad_err": he_err},
    ]

    phase("9 pretraining, the shim and the examples on the card")
    x, y = surrogate_data()
    _, warm = pretrain_phase(dev, card, x, y, reset_counts, read_counts)

    phase("10 the 1M-point surrogate on the card")
    surr = surrogate_phase(dev, card, x, y, warm, reset_counts, read_counts)
    # K3 at the surrogate's shape under default numerics: (e)'s figures
    # (a main-block evaluation's calls over row chunks and unchunked) and
    # (f)'s 128-chain fleet
    kernels[2]["surrogate_default_numerics"] = surr["default_numerics"]
    kernels[2]["surrogate_launches_per_eval"] = {
        label: r["launches_per_eval"]
        for label, r in surr["default_numerics"]["k3"].items()}
    kernels[2]["surrogate_128_chunked"] = surr["default_128"]

    phase("11 the mesh on the card")
    mesh = mesh_phase(dev, card, x, y, warm, reset_counts, read_counts)
    del x, y
    # K1 a chain shard's launch on 4x1, K3 on four surrogate shards
    kernels[0]["mesh_4x1"] = {
        k: mesh["flagship_4x1"][k] for k in ("launches", "steady_200")}
    kernels[2]["mesh_1x4_surrogate"] = mesh["surrogate_1x4"][
        "default_numerics"]

    phase("12 the graph chunk runner against the eager runner")
    print(json.dumps({"graph": graph_phase(dev, card, warm)}))

    phase("13 the mesh graph runner against the eager mesh runner")
    print(json.dumps({"mesh_graph": mesh_graph_phase(dev, card, warm)}))

    print(f"chip_smoke: {time.perf_counter() - _START:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
