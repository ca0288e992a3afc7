"""Makes ``tutorial_warm_start.npy``: a maximum a posteriori start of the
tutorial configuration over its fixed data, in the benchmark's flat layout
(float32), as the tutorial warm-starts its sampler from a pretrained
network. Plain PyTorch on the CPU (the reference's float64 potential at
the start hypers, full-batch Adam from the seed-0 initial network):

    python3 portbench/data/make_tutorial_warm_start.py
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import inputs  # noqa: E402
import spec  # noqa: E402
from reference.mlp import Stack  # noqa: E402


def main(steps=400, lr=1e-2):
    cfg = spec.load_json(os.path.join(os.path.dirname(HERE), "configs",
                                      "tutorial.json"))
    stack = Stack(cfg, torch.float64)
    x, y = inputs.make_data(cfg["data"], 0, "cpu")
    theta, eta = inputs.initial_network(dict(cfg, init={"kind": "he_normal"}),
                                        stack, 0, "cpu")
    theta = theta.double()[None].requires_grad_(True)
    eta = eta.double()[None]
    opt = torch.optim.Adam([theta], lr=lr)
    for i in range(steps):
        opt.zero_grad()
        loss = -(stack.log_prior(theta, eta) + stack.log_likelihood(
            theta, eta, x, y)).sum() / x.shape[0]
        loss.backward()
        opt.step()
        if i % 50 == 0 or i == steps - 1:
            with torch.no_grad():
                p = stack.forward(theta, x)[0, :, 0]
                acc = float(((p > 0.5).double() == y.double()).double().mean())
            print(f"step {i}: loss {float(loss):.5f}, accuracy {acc:.4f}")
    np.save(os.path.join(HERE, "tutorial_warm_start.npy"),
            theta.detach()[0].float().numpy())


if __name__ == "__main__":
    main()
