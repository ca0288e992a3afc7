"""Extended regression example — MAP warm start + posterior credible bands.

Counterpart of the JAX package's ``examples/extended_regression.py`` (the
reference's Examples/extendedRegression.py): pretrain an MLP with amsgrad,
feed the MAP weights into the Bayesian layers as starting states, sample
with adaptive HMC, then summarize the posterior predictive with mean +/-
sd bands.

Run: ``python -m tensorbnn_tpu_torch.examples.extended_regression [--cpu]
[--smoke]``.
"""

import argparse
import math
import time

import numpy as np


def trig_data(n_train):
    """The reference's trig curve: ``n_train`` training points on [-2, 2]
    and 30 validation points between them."""
    train_in = np.linspace(-2, 2, num=n_train)
    val_in = np.linspace(-2 + 2 / 30, 2.0 - 2 / 30, num=30)
    train_out = np.sin(train_in * math.pi * 2) * train_in \
        - np.cos(train_in * math.pi)
    val_out = np.sin(val_in * math.pi * 2) * val_in \
        - np.cos(val_in * math.pi)
    return train_in, train_out, val_in, val_out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--folder", default="ExtendedRegression")
    args = ap.parse_args(argv)

    import torch

    from tensorbnn_tpu_torch import FixedGaussianLikelihood, \
        GaussianDenseLayer, Network, Predictor, Tanh
    from tensorbnn_tpu_torch.metrics import SquaredError
    from tensorbnn_tpu_torch.training.pretrain import dense_warm_start, \
        train_basic_regression

    device = "cpu" if args.cpu else "cuda"
    start = time.time()
    train_in, train_out, val_in, val_out = trig_data(31)

    width, hidden = 10, 3
    cycles, pre_epochs = (2, 40) if args.smoke else (3, 100)

    # MAP warm start. All three return values are consumed: this tanh
    # architecture has no trainable slopes to feed, so `activations`
    # (per-layer leaky-relu slope vectors) is checked for shape only —
    # the classification example feeds them into SquarePrelu warm starts.
    weights, biases, activations = train_basic_regression(
        hidden, 1, 1, width, cycles, pre_epochs, alpha=0.1,
        train_in=train_in, train_out=train_out,
        val_in=val_in, val_out=val_out, verbose=False, device=device)
    assert len(activations) == hidden
    assert all(a.shape == (width,) for a in activations)

    net = Network(torch.float32, 1, train_in, train_out, val_in, val_out,
                  seed=1000, device=device)
    net.add(GaussianDenseLayer(1, width),
            parameters=dense_warm_start(weights, biases, 0))
    net.add(Tanh())
    for i in range(hidden - 1):
        net.add(GaussianDenseLayer(width, width),
                parameters=dense_warm_start(weights, biases, i + 1))
        net.add(Tanh())
    net.add(GaussianDenseLayer(width, 1),
            parameters=dense_warm_start(weights, biases, hidden))

    if args.smoke:
        net.setup_mcmc(step_size_start=1e-3, step_size_min=1e-4,
                       step_size_max=1e-2, step_size_options=40,
                       leapfrog_start=100, leapfrog_min=20,
                       leapfrog_max=500, leapfrog_increment=5,
                       hyper_step_size=0.001, hyper_leapfrog=30,
                       burnin=200, averaging_steps=10, random_steps=5)
        epochs = 800
    else:
        net.setup_mcmc(step_size_start=1e-3, step_size_min=1e-4,
                       step_size_max=1e-2, step_size_options=100,
                       leapfrog_start=1000, leapfrog_min=100,
                       leapfrog_max=10000, leapfrog_increment=10,
                       hyper_step_size=0.001, hyper_leapfrog=100,
                       burnin=1000, averaging_steps=10)
        epochs = 6001

    likelihood = FixedGaussianLikelihood(sd=0.1)
    result = net.train(epochs, 10, likelihood, metric_list=[SquaredError()],
                       adjust_hypers=True, folder_name=args.folder,
                       networks_per_file=50,
                       display_skip=max(epochs // 10, 1))

    pred = Predictor(args.folder, likelihood=likelihood, device=device)
    grid = np.linspace(-2, 2, 101)
    mean, sd = pred.predict_mean_sd(grid[:, None])
    true = np.sin(grid * math.pi * 2) * grid - np.cos(grid * math.pi)
    inside = np.mean(np.abs(true - mean[:, 0]) <= 2 * sd[:, 0])
    print(f"posterior band: {100 * inside:.1f}% of the true curve inside "
          f"mean +/- 2 sd")
    lo, med, hi = pred.predict_quantiles(grid[:, None])
    inside_q = np.mean((true >= lo[:, 0]) & (true <= hi[:, 0]))
    print(f"95% credible band: {100 * inside_q:.1f}% of the true curve "
          f"inside [2.5%, 97.5%] quantiles")
    rmse = float(np.sqrt(np.mean((mean[:, 0] - true) ** 2)))
    print(f"grid RMSE: {rmse:.4f}")
    wall = time.time() - start
    print("Total time elapsed (seconds):", wall)
    return {"band_inside": float(inside), "quantile_inside": float(inside_q),
            "grid_rmse": rmse, "main_path": result.main_path,
            "networks": pred.n_networks, "wall_s": wall}


if __name__ == "__main__":
    main()
