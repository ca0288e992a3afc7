"""Trig regression example — the port's clone of the reference's
Examples/trainRegression.py (counterpart of the JAX package's
``examples/train_regression.py``): 1-D trig target, 3 hidden tanh layers of
width 10, FixedGaussianLikelihood (sd=0.1), adaptive two-block HMC.

Run: ``python -m tensorbnn_tpu_torch.examples.train_regression [--cpu]
[--smoke]`` (on the CUDA card unless ``--cpu``).
"""

import argparse
import time

import numpy as np

from tensorbnn_tpu_torch.examples.extended_regression import trig_data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="short run for sanity checking")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--folder", default="TrigRegression")
    ap.add_argument("--chains", type=int, default=1,
                    help="parallel chains (reference is single-chain)")
    ap.add_argument("--adapters", type=int, default=1,
                    help="GP-adapter groups: chains split into this many "
                         "groups, each on its own (step size, leapfrog) "
                         "trajectory (must divide --chains)")
    args = ap.parse_args(argv)

    import torch

    from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
        GaussianDenseLayer, Network, Predictor, Tanh
    from tensorbnn_tpu_torch.metrics import PercentError, SquaredError

    device = "cpu" if args.cpu else "cuda"
    start = time.time()

    train_in, train_out, val_in, val_out = trig_data(11)

    width, hidden = 10, 3
    likelihood = FixedGaussianLikelihood(sd=0.1)
    metrics = [SquaredError(), PercentError()]

    net = Network(torch.float32, 1, train_in, train_out, val_in, val_out,
                  seed=1000, device=device)
    net.add(GaussianDenseLayer(1, width)).add(Tanh())
    for _ in range(hidden - 1):
        net.add(GaussianDenseLayer(width, width)).add(Tanh())
    net.add(GaussianDenseLayer(width, 1))

    if args.smoke:
        net.setup_mcmc(step_size_start=1e-3, step_size_min=1e-4,
                       step_size_max=1e-2, step_size_options=40,
                       leapfrog_start=100, leapfrog_min=20,
                       leapfrog_max=500, leapfrog_increment=5,
                       hyper_step_size=0.001, hyper_leapfrog=30,
                       burnin=200, averaging_steps=10, random_steps=5)
        epochs, sampling = args.epochs or 800, 10
    else:
        # the reference example's config (trainRegression.py:87-109)
        net.setup_mcmc(step_size_start=1e-3, step_size_min=1e-4,
                       step_size_max=1e-2, step_size_options=100,
                       leapfrog_start=1000, leapfrog_min=100,
                       leapfrog_max=10000, leapfrog_increment=10,
                       hyper_step_size=0.001, hyper_leapfrog=100,
                       burnin=1000, averaging_steps=10)
        epochs, sampling = args.epochs or 6001, 10

    result = net.train(epochs, sampling, likelihood, metric_list=metrics,
                       adjust_hypers=True, folder_name=args.folder,
                       networks_per_file=50, n_chains=args.chains,
                       n_adapters=args.adapters,
                       chain_jitter=0.01 if args.chains > 1 else 0.0,
                       display_skip=max(epochs // 20, 1))

    print(f"\nSampled {result.theta_samples.shape[0]} networks; "
          f"mean main acceptance {result.main_accept.mean():.3f}")

    pred = Predictor(args.folder, likelihood=likelihood, device=device)
    mean, sd = pred.predict_mean_sd(val_in[:, None])
    rmse = float(np.sqrt(np.mean((mean[:, 0] - val_out) ** 2)))
    print(f"posterior predictive val RMSE: {rmse:.4f}; "
          f"mean predictive sd: {sd.mean():.4f}")
    tau = pred.autocorrelation_length(val_in[:, None], n_max=200)
    print(f"integrated autocorrelation time: {tau:.2f} "
          f"(ESS ~ {pred.n_networks / max(tau, 1e-9):.1f})")
    wall = time.time() - start
    print("Total time elapsed (seconds):", wall)
    return {"val_rmse": rmse, "mean_sd": float(sd.mean()), "tau": tau,
            "main_accept": float(result.main_accept.mean()),
            "main_path": result.main_path, "networks": pred.n_networks,
            "wall_s": wall}


if __name__ == "__main__":
    main()
