"""Binary classification example with a Bernoulli likelihood.

Counterpart of the JAX package's ``examples/classification.py`` (the
reference's classification tutorial, docs/ClassificationExample.md: MNIST
3-vs-8 with SquarePrelu activations, a sigmoid head, Bernoulli likelihood,
accuracy metric). MNIST is not in the repository, so a synthetic
two-moons task stands in — the model/likelihood/metric stack is
identical.

Run: ``python -m tensorbnn_tpu_torch.examples.classification [--cpu]
[--smoke]``.
"""

import argparse
import time

import numpy as np


def two_moons(n, noise=0.15, seed=0):
    rng = np.random.default_rng(seed)
    n2 = n // 2
    t = rng.uniform(0, np.pi, n2)
    a = np.stack([np.cos(t), np.sin(t)], 1)
    b = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    x = np.concatenate([a, b]) + rng.normal(0, noise, (2 * n2, 2))
    y = np.concatenate([np.zeros(n2), np.ones(n2)])
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), y[perm].astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--folder", default="MoonsClassification")
    args = ap.parse_args(argv)

    import torch

    from tensorbnn_tpu_torch import BernoulliLikelihood, \
        GaussianDenseLayer, Network, Predictor, Sigmoid, SquarePrelu
    from tensorbnn_tpu_torch.metrics import Accuracy
    from tensorbnn_tpu_torch.training.pretrain import dense_warm_start, \
        squareprelu_warm_start, train_basic_classification

    device = "cpu" if args.cpu else "cuda"
    start = time.time()
    x_train, y_train = two_moons(200, seed=0)
    x_val, y_val = two_moons(100, seed=1)

    width, hidden = 16, 2
    cycles, pre_epochs = (1, 30) if args.smoke else (2, 80)

    # pretraining returns all three warm starts; train_slopes=True makes the
    # activation slope vectors genuinely trained
    weights, biases, activations = train_basic_classification(
        hidden, 2, 1, width, cycles, pre_epochs, alpha=0.1,
        train_in=x_train, train_out=y_train,
        val_in=x_val, val_out=y_val, train_slopes=True, device=device)

    net = Network(torch.float32, 2, x_train, y_train, x_val, y_val,
                  seed=42, device=device)
    net.add(GaussianDenseLayer(2, width),
            parameters=dense_warm_start(weights, biases, 0))
    net.add(SquarePrelu(width, alpha=0.55),
            parameters=squareprelu_warm_start(activations, 0))
    net.add(GaussianDenseLayer(width, width),
            parameters=dense_warm_start(weights, biases, 1))
    net.add(SquarePrelu(width, alpha=0.55),
            parameters=squareprelu_warm_start(activations, 1))
    net.add(GaussianDenseLayer(width, 1),
            parameters=dense_warm_start(weights, biases, 2))
    net.add(Sigmoid())

    if args.smoke:
        net.setup_mcmc(step_size_start=5e-4, step_size_min=1e-5,
                       step_size_max=5e-3, step_size_options=40,
                       leapfrog_start=50, leapfrog_min=10,
                       leapfrog_max=200, leapfrog_increment=5,
                       hyper_step_size=0.001, hyper_leapfrog=30,
                       burnin=150, averaging_steps=10, random_steps=4)
        epochs = 500
    else:
        net.setup_mcmc(step_size_start=5e-4, step_size_min=1e-5,
                       step_size_max=5e-3, step_size_options=100,
                       leapfrog_start=500, leapfrog_min=50,
                       leapfrog_max=2000, leapfrog_increment=10,
                       hyper_step_size=0.001, hyper_leapfrog=100,
                       burnin=1000, averaging_steps=10)
        epochs = 4000

    likelihood = BernoulliLikelihood()
    result = net.train(epochs, 10, likelihood,
                       metric_list=[Accuracy()],
                       adjust_hypers=True, folder_name=args.folder,
                       networks_per_file=50,
                       display_skip=max(epochs // 10, 1))

    pred = Predictor(args.folder, likelihood=likelihood, device=device)
    probs = pred.predict(x_val, n=1).mean(axis=0)[:, 0]
    acc = float(np.mean((probs > 0.5) == (y_val > 0.5)))
    print(f"posterior-ensemble validation accuracy: {acc:.3f}")
    wall = time.time() - start
    print("Total time elapsed (seconds):", wall)
    return {"accuracy": acc, "main_path": result.main_path,
            "networks": pred.n_networks, "wall_s": wall}


if __name__ == "__main__":
    main()
