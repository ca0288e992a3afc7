"""The system under test, ``tensorbnn_tpu_torch``, as the benchmark drives
it: the one module of the harness that imports the program.

It builds the program's model and likelihood from a configuration,
hands the driver (``sampler.driver.sample_posterior``, the sampler that
``Network.train`` runs) the data, the initial network and the generator
the benchmark made, and reads the program's spans and counters: the
``RunTracer`` chunk spans and the graph runner's ``COUNTS``. The Predictor
is driven through its public constructor and ``predict``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from inputs import start_hypers
from reference.mlp import Stack

import tensorbnn_tpu_torch as port
from tensorbnn_tpu_torch.io import checkpoint
from tensorbnn_tpu_torch.ops import _build
from tensorbnn_tpu_torch.parallel import graphs
from tensorbnn_tpu_torch.parallel.mesh import make_mesh
from tensorbnn_tpu_torch.sampler.driver import MCMCConfig, sample_posterior
from tensorbnn_tpu_torch.sampler.potential import flatten_state
from tensorbnn_tpu_torch.utils.tracing import RunTracer


def build_model(config: dict):
    """``(Sequential, Likelihood)`` of the configuration's stack."""
    layers = []
    for spec in config["layers"]:
        kind = spec["kind"]
        if kind == "dense":
            layers.append(port.GaussianDenseLayer(spec["in"], spec["out"]))
        elif kind == "tanh":
            layers.append(port.Tanh())
        elif kind == "sigmoid":
            layers.append(port.Sigmoid())
        elif kind == "squareprelu":
            layers.append(port.SquarePrelu(spec["width"], alpha=spec["alpha"]))
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    lik = config["likelihood"]
    likelihood = {"gaussian_fixed": lambda: port.FixedGaussianLikelihood(
                      sd=lik["sd"]),
                  "gaussian_learned": lambda: port.GaussianLikelihood(
                      sd=lik["sd"]),
                  "bernoulli": port.BernoulliLikelihood}[lik["kind"]]()
    return port.Sequential(layers), likelihood


def structured(stack: Stack, theta: torch.Tensor, eta: torch.Tensor):
    """The flat ``theta (D,)`` and ``eta (H,)`` as the program's
    ``(params, hypers)``: a dict a layer."""
    params, hypers = [], []
    for layer in stack.layers:
        kind, k = layer["kind"], layer.get("hyper")
        if kind == "dense":
            i, o = layer["n_in"], layer["n_out"]
            params.append({"b": theta[layer["b"][0]:layer["b"][1]].clone(),
                           "w": theta[layer["w"][0]:layer["w"][1]]
                           .reshape(i, o).clone()})
            hypers.append({name: eta[k + j].clone() for j, name in enumerate(
                ("b_loc", "b_scale", "w_loc", "w_scale"))})
        elif kind == "squareprelu":
            params.append({"slopes": theta[layer["slopes"][0]:
                                           layer["slopes"][1]].clone()})
            hypers.append({"loc": eta[k].clone(), "scale": eta[k + 1].clone()})
        else:
            params.append({})
            hypers.append({})
    return tuple(params), tuple(hypers)


class ChunkTracer(RunTracer):
    """The program's ``RunTracer``, which the driver feeds at each chunk,
    with a callback at each chunk's start (``on_start(index)``) and end
    (``on_end(index, record)``): the harness starts and stops its profiler
    there."""

    def __init__(self, on_start: Optional[Callable] = None,
                 on_end: Optional[Callable] = None):
        super().__init__()
        self.on_start, self.on_end = on_start, on_end

    def start_chunk(self):
        if self.on_start is not None:
            self.on_start(len(self.chunks))
        super().start_chunk()

    def end_chunk(self, epochs, leapfrog, n_chains, max_leapfrog=None):
        super().end_chunk(epochs, leapfrog, n_chains, max_leapfrog)
        if self.on_end is not None:
            self.on_end(len(self.chunks) - 1, self.chunks[-1])


class Sampler:
    """One configuration's sampling jobs through the program's driver."""

    def __init__(self, config: dict, traffic: dict, stack: Stack,
                 mesh_shape=None, devices=None):
        self.config, self.traffic, self.stack = config, traffic, stack
        self.model, self.likelihood = build_model(config)
        self.mesh = None
        if mesh_shape is not None:
            self.mesh = make_mesh(*mesh_shape, devices=devices)

    def run(self, x, y, theta0, eta0, gen_seed: int, epochs: int,
            burnin: int, tracer=None):
        """One job: ``sample_posterior`` over ``(x, y)`` from ``(theta0,
        eta0)`` with a generator seeded by ``gen_seed``; returns the
        program's ``RunResult``."""
        job = self.traffic["job"]
        params, hypers = structured(self.stack, theta0, eta0)
        flat = flatten_state(params, hypers,
                             self.likelihood.init_hypers(x.dtype, x.device))
        if not (torch.equal(flat.theta, theta0)
                and torch.equal(flat.eta, eta0)):
            raise RuntimeError("the program's flat layout is not the one "
                               "the benchmark's reference reads")
        cfg = MCMCConfig(**dict(self.traffic["mcmc"], burnin=burnin))
        gen = torch.Generator(device=x.device).manual_seed(int(gen_seed))
        return sample_posterior(
            self.model, self.likelihood, x, y, config=cfg, params=params,
            hypers=hypers, generator=gen, epochs=epochs,
            sampling_step=job["sampling_step"], n_chains=job["n_chains"],
            n_adapters=job.get("n_adapters", 1),
            chain_jitter=job.get("chain_jitter", 0.0), verbose=False,
            tracer=tracer, data_chunk=job.get("data_chunk"),
            numerics=job.get("numerics", "default"), mesh=self.mesh)


def graph_counts():
    """The graph runners' and forward graphs' counters (``COUNTS``)."""
    return graphs.COUNTS


def build_seconds() -> Optional[float]:
    """Seconds the program's kernel build took in this process (None:
    found built)."""
    return _build.build_seconds


def predictor(config: dict, stack: Stack, thetas: torch.Tensor,
              directory: str, device):
    """A ``Predictor`` over the ensemble ``thetas (S, D)``, stored in the
    program's npz store under ``directory``."""
    model, likelihood = build_model(config)
    host = thetas.cpu().numpy()
    params, hypers = [], []
    eta_one = start_hypers(config, stack).numpy()
    s = host.shape[0]
    for layer in stack.layers:
        kind, k = layer["kind"], layer.get("hyper")
        if kind == "dense":
            i, o = layer["n_in"], layer["n_out"]
            params.append({"b": host[:, layer["b"][0]:layer["b"][1]],
                           "w": host[:, layer["w"][0]:layer["w"][1]]
                           .reshape(s, i, o)})
            hypers.append({name: np.full(s, eta_one[k + j], np.float32)
                           for j, name in enumerate(
                               ("b_loc", "b_scale", "w_loc", "w_scale"))})
        else:
            params.append({})
            hypers.append({})
    checkpoint.save_samples(directory, tuple(params), tuple(hypers), {})
    with open(os.path.join(directory, "architecture.txt"), "w") as f:
        f.write("\n".join(model.layer_names) + "\n")
    return port.Predictor(directory, likelihood=likelihood, device=device)
