"""Real-data binary classification: digits 3-vs-8.

Counterpart of the JAX package's ``examples/digits_classification.py``.
The reference's classification acceptance spec is MNIST 3-vs-8 with
pretraining -> SquarePrelu/sigmoid BNN -> 2500-epoch HMC
(docs/ClassificationExample.md in the reference). MNIST is not in the
repository; scikit-learn's bundled 8x8 handwritten-digit scans (1,797
images, the UCI optdigits test set) are the same task on real image data.
This example mirrors the tutorial step for step on those digits:

* select classes 3 and 8, relabel {0, 1}, scale pixels to [0, 1] (these
  4-bit pixels divide by 16);
* 80-20 train/validation split with ``random_state=21``;
* pretraining with 2 hidden layers of width 20, leaky-relu slope 0.1,
  lr-decade cycles (``training/pretrain.py``);
* BNN: Dense(warm-started) + SquarePrelu(alpha=sqrt(0.1)) x2, Dense +
  Sigmoid head;
* ``setup_mcmc`` with the tutorial's parameters and a 2500-epoch training
  run saving every 10th network, 25 per file, Bernoulli likelihood,
  accuracy metric.

It needs scikit-learn for the digits and exits with a message without it.

Run: ``python -m tensorbnn_tpu_torch.examples.digits_classification
[--cpu] [--smoke]``
"""

import argparse
import time

import numpy as np


def digits_3v8():
    try:
        from sklearn.datasets import load_digits
        from sklearn.model_selection import train_test_split
    except ImportError as e:  # keep the package scikit-learn-free
        raise SystemExit(
            "this example needs scikit-learn for its bundled digits "
            "dataset; examples/classification.py is the dependency-free "
            "synthetic variant") from e

    d = load_digits()
    mask = np.isin(d.target, (3, 8))
    x = (d.data[mask] / 16.0).astype(np.float32)   # 4-bit pixels -> [0, 1]
    y = (d.target[mask] == 8).astype(np.float32)   # 3 -> 0, 8 -> 1
    return train_test_split(x, y, test_size=0.20, random_state=21)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="shortened config for CI-style runs")
    ap.add_argument("--folder", default="DigitsBNN")
    args = ap.parse_args(argv)

    import torch

    from tensorbnn_tpu_torch import BernoulliLikelihood, \
        GaussianDenseLayer, Network, Predictor, Sigmoid, SquarePrelu
    from tensorbnn_tpu_torch.metrics import Accuracy
    from tensorbnn_tpu_torch.training.pretrain import dense_warm_start, \
        squareprelu_warm_start, train_basic_classification

    device = "cpu" if args.cpu else "cuda"
    start = time.time()
    x_train, x_val, y_train, y_val = digits_3v8()
    input_dims = x_train.shape[1]                  # 64 pixels
    width, hidden = 20, 2
    alpha = 0.1                                    # leaky-relu/SquarePrelu

    cycles, pre_epochs = (1, 10) if args.smoke else (3, 10)
    weights, biases, activations = train_basic_classification(
        hidden, input_dims, 1, width, cycles, pre_epochs, alpha=alpha,
        train_in=x_train, train_out=y_train,
        val_in=x_val, val_out=y_val, train_slopes=True,
        callbacks=True, patience=10, device=device)

    net = Network(torch.float32, input_dims, x_train, y_train,
                  x_val, y_val, seed=0, device=device)
    net.add(GaussianDenseLayer(input_dims, width),
            parameters=dense_warm_start(weights, biases, 0))
    net.add(SquarePrelu(width, alpha=alpha ** 0.5),
            parameters=squareprelu_warm_start(activations, 0))
    for n in range(hidden - 1):
        net.add(GaussianDenseLayer(width, width),
                parameters=dense_warm_start(weights, biases, n + 1))
        net.add(SquarePrelu(width, alpha=alpha ** 0.5),
                parameters=squareprelu_warm_start(activations, n + 1))
    net.add(GaussianDenseLayer(width, 1),
            parameters=dense_warm_start(weights, biases, -1))
    net.add(Sigmoid())

    if args.smoke:
        net.setup_mcmc(step_size_start=0.001, step_size_min=0.0005,
                       step_size_max=0.002, step_size_options=20,
                       leapfrog_start=50, leapfrog_min=10,
                       leapfrog_max=200, leapfrog_increment=5,
                       hyper_step_size=1e-5, hyper_leapfrog=30,
                       burnin=50, averaging_steps=2, random_steps=4)
        epochs = 300
    else:
        # the tutorial's setupMCMC arguments
        net.setup_mcmc(step_size_start=0.001, step_size_min=0.0005,
                       step_size_max=0.002, step_size_options=100,
                       leapfrog_start=500, leapfrog_min=100,
                       leapfrog_max=2000, leapfrog_increment=1,
                       hyper_step_size=1e-5, hyper_leapfrog=30,
                       burnin=50, averaging_steps=2)
        epochs = 2500

    likelihood = BernoulliLikelihood()
    # Accuracy only: PercentError divides by the raw {0,1} labels and is
    # non-finite on the 0 class (kept reference quirk, metrics.py)
    result = net.train(epochs, 10, likelihood,
                       metric_list=[Accuracy()],
                       adjust_hypers=True, folder_name=args.folder,
                       networks_per_file=25,
                       display_skip=max(epochs // 10, 1))

    pred = Predictor(args.folder, likelihood=likelihood, device=device)
    probs = pred.predict(x_val, n=1).mean(axis=0)[:, 0]
    acc = float(np.mean((probs > 0.5) == (y_val > 0.5)))
    print(f"posterior-ensemble validation accuracy: {acc:.3f} "
          f"({len(y_val)} held-out digits)")
    wall = time.time() - start
    print("Total time elapsed (seconds):", wall)
    return {"accuracy": acc, "main_path": result.main_path,
            "networks": pred.n_networks, "wall_s": wall}


if __name__ == "__main__":
    main()
