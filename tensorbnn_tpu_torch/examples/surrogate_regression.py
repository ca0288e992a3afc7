"""Large-dataset physics-surrogate regression (BASELINE.json config 5).

Counterpart of the JAX package's ``examples/surrogate_regression.py``: a
1M-point synthetic detector-response dataset fit with a Bayesian MLP under
a learned-noise Gaussian likelihood. The full-batch log-likelihood and its
gradient are evaluated every leapfrog step.

Run: ``python -m tensorbnn_tpu_torch.examples.surrogate_regression
[--cpu] [--smoke]``. The single-card quality configuration is ``--chains
32 --data-chunk 125000``: a 32-chain fleet whose activations are bounded
by the chunked likelihood, under the default ``numerics="exact"`` preset
(the Kahan leapfrog and TF32-off products). Leave ``--precondition`` off
here: the cross-chain metric estimate on this fleet is near-identity or
corrupted by the adapter's random-phase exploration (the JAX package's
measurement). ``--data-devices N`` (N > 1) lays a ``(chains, data)`` mesh
over the cards (over the CPU with ``--cpu``), N on the data axis and one
chain a chain-axis device, as the JAX example does; a machine with fewer
than N devices raises ``make_mesh``'s error.
"""

import argparse
import time

import numpy as np


def detector_response(x, rng):
    """Synthetic smooth nonlinear response with heteroscedastic-ish shape."""
    r = np.sin(x[:, 0] * 2) * np.cos(x[:, 1]) + 0.5 * np.tanh(x[:, 2:].sum(1))
    return (r + 0.05 * rng.normal(size=len(x))).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--data-devices", type=int, default=1)
    ap.add_argument("--chains", type=int, default=1,
                    help="chains on one card (try 32)")
    ap.add_argument("--data-chunk", type=int, default=0,
                    help="likelihood rows per chunk (exact accumulation; "
                         "bounds activation memory for wide fleets)")
    ap.add_argument("--precondition", action="store_true",
                    help="diagonal-metric step preconditioner (needs "
                         "--chains >= 8). Not recommended on this target")
    ap.add_argument("--default-numerics", action="store_true",
                    help="opt out of the numerics='exact' preset (Kahan "
                         "integration + exact-f32 products)")
    args = ap.parse_args(argv)

    import torch

    from tensorbnn_tpu_torch import GaussianDenseLayer, GaussianLikelihood, \
        Network, Tanh
    from tensorbnn_tpu_torch.metrics import SquaredError
    from tensorbnn_tpu_torch.parallel.mesh import make_mesh

    device = "cpu" if args.cpu else "cuda"
    mesh = None
    n_chains = args.chains
    if args.data_devices > 1:
        devices = [torch.device("cpu")] if args.cpu else [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n_chain_dev = len(devices) // args.data_devices
        mesh = make_mesh(n_chain_devices=n_chain_dev,
                         n_data_devices=args.data_devices, devices=devices)
        n_chains = n_chain_dev  # one chain per chain-axis device
    start = time.time()
    n = args.points if not args.smoke else min(args.points, 100_000)
    d_in, width = 8, 64
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    y = detector_response(x, rng)
    x_val = rng.normal(size=(4096, d_in)).astype(np.float32)
    y_val = detector_response(x_val, rng)

    net = Network(torch.float32, d_in, x, y, x_val, y_val, seed=3,
                  device=device)
    net.add(GaussianDenseLayer(d_in, width)).add(Tanh())
    net.add(GaussianDenseLayer(width, width)).add(Tanh())
    net.add(GaussianDenseLayer(width, 1))

    epochs, burnin = (60, 20) if args.smoke else (600, 200)
    net.setup_mcmc(step_size_start=2e-5, step_size_min=1e-6,
                   step_size_max=1e-4, step_size_options=40,
                   leapfrog_start=30, leapfrog_min=10, leapfrog_max=100,
                   leapfrog_increment=5, hyper_step_size=1e-4,
                   hyper_leapfrog=10, burnin=burnin, averaging_steps=10,
                   random_steps=3)
    res = net.train(epochs, 5, GaussianLikelihood(sd=0.05),
                    metric_list=[SquaredError()], mesh=mesh,
                    n_chains=n_chains,
                    # positional jitter collapses acceptance on sharp
                    # big-data posteriors; momenta decorrelate the fleet
                    chain_jitter=0.0,
                    data_chunk=args.data_chunk or None,
                    precondition=args.precondition,
                    numerics=("default" if args.default_numerics
                              else "exact"),
                    display_skip=max(epochs // 5, 1))

    accept = float(res.main_accept.mean())
    sd = (float(np.mean(res.eta_samples[:, :, -1] ** 2))
          if res.theta_samples.size else float("nan"))
    print(f"\n{res.theta_samples.shape[0]} samples, main accept "
          f"{accept:.3f}, learned sd ~ {sd:.4f}"
          if res.theta_samples.size else "no samples")
    wall = time.time() - start
    print("Total time elapsed (seconds):", wall)
    return {"main_accept": accept, "learned_sd": sd,
            "samples": int(res.theta_samples.shape[0]),
            "main_path": res.main_path, "fused_hyper": res.fused_hyper,
            "wall_s": wall}


if __name__ == "__main__":
    main()
