"""What the benchmark makes from ``--seed`` and hands to the program and
to the reference alike: the data, each job's initial network, the seeds of
the jobs' generators, and the predict cell's ensemble and inputs.

What depends on the seed is made on the device, in a few large calls,
from generators seeded by the run's seed. The data makers are frozen
copies of the repository's data makers (each names its source); the
tutorial's pixels keep their fixed numpy generator, to which its warm
start was fitted.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from reference.mlp import Stack

HERE = os.path.dirname(os.path.abspath(__file__))


def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of run seed ``seed`` (job k
    of the run takes ``derived_seed(seed, 1, k)``)."""
    ss = np.random.SeedSequence([seed % (1 << 64), *path])
    lo, hi = ss.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_data(recipe: dict, seed: int, device):
    """``(x (N, in), y (N,))`` float32 on ``device``."""
    kind = recipe["kind"]
    if kind == "trig_curve":
        # the reference's trainRegression data (__graft_entry__.py:28-30)
        x = torch.linspace(recipe["lo"], recipe["hi"], recipe["rows"],
                           dtype=torch.float64)
        y = torch.sin(x * math.pi * 2) * x - torch.cos(x * math.pi)
        return (x.to(torch.float32)[:, None].to(device),
                y.to(torch.float32).to(device))
    rows, width = recipe["rows"], recipe["width"]
    if kind == "plane_pixels_fixed":
        # chip_smoke.py:995-1004 (tutorial_data) as it is: uniform pixels
        # from numpy's default_rng(5) labelled by a random hyperplane
        # through their mean, the same for every seed (the warm start was
        # fitted to them)
        rng = np.random.default_rng(recipe["rng"])
        x = rng.uniform(size=(recipe["all_rows"], width)).astype(np.float32)
        plane = rng.normal(size=width)
        y = ((x - 0.5) @ plane > 0).astype(np.float32)
        return (torch.from_numpy(x[:rows]).to(device),
                torch.from_numpy(y[:rows]).to(device))
    if kind == "sin_sum":
        g = generator(device, derived_seed(seed, 0))
        # chip_smoke.py:2642-2650 (surrogate_data): N(0, 1) points, y =
        # sin(sum x) + noise N(0, 1)
        x = torch.randn((rows, width), generator=g, device=device)
        y = torch.sin(x.sum(dim=1)) + recipe["noise"] * torch.randn(
            rows, generator=g, device=device)
        return x, y
    raise ValueError(f"unknown data recipe {kind!r}")


def start_hypers(config: dict, stack: Stack) -> torch.Tensor:
    """``(H,)``: every hyper at its start (dense: locations 0, scales 1;
    SquarePrelu: location 0, scale 0.3; a sampled noise sd's root at the
    likelihood's sd's square root)."""
    eta = torch.zeros(stack.H, dtype=torch.float32)
    for layer in stack.layers:
        if layer["kind"] == "dense":
            eta[layer["hyper"] + 1] = 1.0   # b_scale
            eta[layer["hyper"] + 3] = 1.0   # w_scale
        elif layer["kind"] == "squareprelu":
            eta[layer["hyper"] + 1] = 0.3
    if stack.sd_index is not None:
        eta[stack.sd_index] = math.sqrt(config["likelihood"]["sd"])
    return eta


def initial_network(config: dict, stack: Stack, seed: int, device):
    """``(theta (D,), eta (H,))`` float32 on ``device``: the start of a
    job. ``he_normal``: every dense weight and bias N(0, sqrt(2 / out))
    from ``seed``, SquarePrelu slopes at their ``alpha``; ``warm_start``:
    the dense layers from the configuration's file (per layer ``W (out,
    in)`` then ``b``), the same for every seed; ``flat``: the whole theta
    from the configuration's file in the benchmark's flat layout."""
    init = config["init"]
    theta = torch.empty(stack.D, dtype=torch.float32)
    if init["kind"] == "he_normal":
        g = generator(device, seed)
        draws = torch.randn(stack.D, generator=g, device=device).cpu()
        for layer in stack.layers:
            if layer["kind"] == "dense":
                lo, hi = layer["b"][0], layer["w"][1]
                theta[lo:hi] = draws[lo:hi] * math.sqrt(2.0 / layer["n_out"])
    elif init["kind"] == "flat":
        # a start in the benchmark's own flat layout
        theta = torch.from_numpy(np.load(os.path.join(HERE, init["file"]))
                                 .astype(np.float32))
    elif init["kind"] == "warm_start":
        flat = np.load(os.path.join(HERE, init["file"])).astype(np.float32)
        at = 0
        for layer in stack.layers:
            if layer["kind"] != "dense":
                continue
            i, o = layer["n_in"], layer["n_out"]
            w = flat[at:at + o * i].reshape(o, i)
            b = flat[at + o * i:at + o * i + o]
            at += o * i + o
            theta[layer["b"][0]:layer["b"][1]] = torch.from_numpy(b)
            theta[layer["w"][0]:layer["w"][1]] = torch.from_numpy(
                np.ascontiguousarray(w.T).reshape(-1))
        if at != flat.size:
            raise ValueError(f"{init['file']}: {flat.size} numbers, the "
                             f"stack's dense layers take {at}")
    else:
        raise ValueError(f"unknown init {init['kind']!r}")
    for spec, layer in zip(config["layers"], stack.layers):
        if layer["kind"] == "squareprelu" and init["kind"] != "flat":
            theta[layer["slopes"][0]:layer["slopes"][1]] = spec["alpha"]
    return theta.to(device), start_hypers(config, stack).to(device)


def ensemble(config: dict, stack: Stack, networks: int, spread: float,
             seed: int, device) -> torch.Tensor:
    """``(networks, D)`` float32: a posterior-like ensemble around one
    ``initial_network``, each coordinate moved by N(0, ``spread``) (the
    JAX bench's predict cell, benchmarks/run_benchmarks.py:1196-1214)."""
    theta0, _ = initial_network(config, stack, derived_seed(seed, 2),
                                device)
    g = generator(device, derived_seed(seed, 3))
    return theta0[None] + spread * torch.randn(
        (networks, stack.D), generator=g, device=device)
