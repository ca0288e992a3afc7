"""Parallel tempering on a bimodal BNN posterior.

Counterpart of the JAX package's ``examples/tempering_bimodal.py``. Every
tanh BNN posterior carries exact sign-flip mode copies: flipping the sign
of a hidden unit's input weights/bias together with its output weight
leaves the network function unchanged, so the posterior has mirrored modes
of identical depth separated by a likelihood wall. A single-temperature
HMC chain never tunnels between them: warm-started in one mode it reports
that mode's uncertainty and silently misses the other.

``tempering=K`` widens the fleet rung-major to ``K x n_chains`` replicas
on a geometric inverse-temperature ladder. The hottest rung sees the
likelihood wall scaled by ``tempering_beta_min``, crosses freely, and
replica swaps carry opposite-sign states down the ladder into the cold
chains. On the card the rungs run in the same tempered K1 launch as the
cold chains.

Run: ``python -m tensorbnn_tpu_torch.examples.tempering_bimodal [--cpu]
[--smoke]``
"""

import argparse
import time

import numpy as np


def bimodal_data():
    """A tanh curve of 8 points and the warm start in its positive mode:
    a 1-hidden-unit tanh net fit to it has two EXACT mirrored modes,
    (w1, b1, w2) and (-w1, -b1, -w2)."""
    x = np.linspace(-1, 1, 8)
    y = 1.5 * np.tanh(2.0 * x)
    warm = ({"w": np.full((1, 1), 2.0, np.float32),
             "b": np.zeros((1,), np.float32)},
            {"w": np.full((1, 1), 1.5, np.float32),
             "b": np.zeros((1,), np.float32)})
    return x, y, warm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
        GaussianDenseLayer, Network, Tanh

    device = "cpu" if args.cpu else "cuda"
    x, y, warm = bimodal_data()
    lik = FixedGaussianLikelihood(sd=0.15)
    epochs = 100 if args.smoke else 600
    n_chains = 4 if args.smoke else 16

    def build():
        net = Network(torch.float32, 1, x, y, x, y, seed=5, device=device)
        net.add(GaussianDenseLayer(1, 1), parameters=warm[0]).add(Tanh())
        net.add(GaussianDenseLayer(1, 1), parameters=warm[1])
        net.setup_mcmc(step_size_start=1e-2, step_size_min=1e-3,
                       step_size_max=0.2, step_size_options=15,
                       leapfrog_start=8, leapfrog_min=2, leapfrog_max=20,
                       leapfrog_increment=2, hyper_step_size=1e-2,
                       hyper_leapfrog=5, burnin=50, averaging_steps=10,
                       random_steps=3)
        return net

    # theta layout is [b1, w1, b2, w2] (dict keys in sorted order); the
    # hidden kernel w1 carries the mode's sign
    t0 = time.time()
    res_plain = build().train(epochs, 2, lik, n_chains=n_chains,
                              chain_jitter=0.0, verbose=False)
    t_plain = time.time() - t0
    w1_plain = res_plain.theta_samples[..., 1]

    t0 = time.time()
    res_temp = build().train(epochs, 2, lik, n_chains=n_chains,
                             tempering=6, tempering_beta_min=0.01,
                             chain_jitter=0.0, verbose=False)
    t_temp = time.time() - t0
    w1_cold = res_temp.theta_samples[..., 1]

    def mode_report(name, w1, wall):
        neg = float((w1 < 0).mean())
        print(f"{name}: {wall:.1f}s, negative-mode fraction "
              f"{neg:.3f} (ideal 0.5 — the modes are exactly symmetric)")
        return neg

    print(f"warm start: positive mode; {epochs} epochs x {n_chains} "
          f"cold chains")
    neg_p = mode_report("plain HMC      ", w1_plain, t_plain)
    neg_t = mode_report("tempering (K=6)", w1_cold, t_temp)
    swap = float(np.mean(res_temp.swap_accept))
    print(f"replica swap acceptance: {swap:.3f}")
    if neg_p == 0.0 and neg_t > 0.0:
        print("-> plain HMC never left the start mode; the tempered cold "
              "chains visited both.")
    return {"plain_negative": neg_p, "tempered_negative": neg_t,
            "swap_accept": swap, "plain_path": res_plain.main_path,
            "tempered_path": res_temp.main_path}


if __name__ == "__main__":
    main()
