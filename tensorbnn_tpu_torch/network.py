"""User-facing network facade: construct -> add -> setup_mcmc -> train.

Counterpart of ``tensorbnn_tpu/network.py``: assembles data, layers and
the sampler configuration, then delegates to
:func:`tensorbnn_tpu_torch.sampler.driver.sample_posterior`. The reference's
camelCase names (``setupMCMC``, ``stepSizeStart``, ...) are accepted.
Everything lives on ``device``: the CUDA card unless the caller names
another device (the tests pass ``device="cpu"``). ``train(mesh=...)`` runs
the fleet over a ``(chains, data)`` mesh (parallel/mesh.py), whose first
device must be ``device``: the run's data, draws and gathered outputs live
there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tensorbnn_tpu_torch.likelihoods import Likelihood
from tensorbnn_tpu_torch.models.layers import LayerSpec
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.sampler.driver import MCMCConfig, RunResult, \
    sample_posterior

#: reference setupMCMC kwarg -> MCMCConfig field (network.py:193-198)
_REF_KWARGS = {
    "stepSizeStart": "step_size_start",
    "stepSizeMin": "step_size_min",
    "stepSizeMax": "step_size_max",
    "stepSizeOptions": "step_size_options",
    "leapfrogStart": "leapfrog_start",
    "leapfogMin": "leapfrog_min",        # [sic] reference typo kept as alias
    "leapfrogMin": "leapfrog_min",
    "leapFrogMax": "leapfrog_max",
    "leapfrogMax": "leapfrog_max",
    "leapfrogIncrement": "leapfrog_increment",
    "hyperStepSize": "hyper_step_size",
    "hyperLeapfrog": "hyper_leapfrog",
    "burnin": "burnin",
    "averagingSteps": "averaging_steps",
    "a": "a",
    "delta": "delta",
    "strikes": "max_strikes",
    "randomSteps": "random_steps",
}

#: reference train() kwarg -> train() keyword
_REF_TRAIN_KWARGS = {
    "metricList": "metric_list",
    "adjustHypers": "adjust_hypers",
    "folderName": "folder_name",
    "networksPerFile": "networks_per_file",
    "displaySkip": "display_skip",
}


def _torch_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


class Network:
    """Holds data, model layers and sampler config; runs the sampler."""

    def __init__(self, dtype, input_dims: int, train_x, train_y,
                 validate_x, validate_y, seed: int = 0, device="cuda"):
        self.dtype = _torch_dtype(dtype)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Network: device {device!r} needs a CUDA card, and torch "
                f"sees none here; pass device='cpu' to run on the CPU")
        self.input_dims = input_dims
        arrays = {}
        for name, arr in (("train_x", train_x), ("train_y", train_y),
                          ("validate_x", validate_x),
                          ("validate_y", validate_y)):
            a = np.asarray(arr)
            if a.dtype.kind in "fc" and not np.isfinite(a).all():
                raise ValueError(f"{name} contains non-finite values "
                                 f"({int((~np.isfinite(a)).sum())} of "
                                 f"{a.size})")
            if name.endswith("_x") and a.size != len(a) * input_dims:
                raise ValueError(
                    f"{name} width does not match input_dims={input_dims}: "
                    f"{a.size} values for {len(a)} rows")
            arrays[name] = torch.as_tensor(a, dtype=self.dtype).to(
                self.device)
        self.train_x = arrays["train_x"].reshape(-1, input_dims)
        self.train_y = arrays["train_y"]
        self.validate_x = arrays["validate_x"].reshape(-1, input_dims)
        self.validate_y = arrays["validate_y"]

        self.model = Sequential()
        self._param_overrides = []
        self.config: Optional[MCMCConfig] = None
        # initial weights are drawn on the CPU, so a seed gives the same
        # start on every device; the run's draws come from a generator on
        # the device, seeded from this one
        self.generator = torch.Generator().manual_seed(seed)
        self.results: Optional[RunResult] = None

    def add(self, layer: LayerSpec, parameters: Optional[dict] = None):
        """Adds a layer, optionally with explicit starting parameters."""
        self.model.add(layer)
        self._param_overrides.append(parameters)
        return self

    def setup_mcmc(self, **kwargs) -> MCMCConfig:
        """Configures the sampler (MCMCConfig names or camelCase)."""
        mapped = {_REF_KWARGS.get(k, k): v for k, v in kwargs.items()}
        mapped.pop("cores", None)
        mapped.pop("dualAveraging", None)
        self.config = MCMCConfig(**mapped)
        return self.config

    setupMCMC = setup_mcmc

    def init_state(self):
        """Initial ``(params, hypers)`` with warm-start overrides applied."""
        params, hypers = self.model.init(self.generator, dtype=self.dtype,
                                         device=self.device)
        params = list(params)
        for i, override in enumerate(self._param_overrides):
            if override:
                params[i] = {**params[i], **{
                    k: torch.as_tensor(np.asarray(v), dtype=self.dtype).to(
                        self.device) for k, v in override.items()}}
        return tuple(params), hypers

    def train(self, epochs: int, sampling_step: int, likelihood: Likelihood,
              metric_list: Sequence = (), adjust_hypers: bool = True,
              folder_name: Optional[str] = None,
              networks_per_file: int = 1000,
              display_skip: int = 0, verbose: bool = True,
              n_chains: int = 1, n_adapters: int = 1,
              chain_jitter: float = 0.0, use_fused="auto",
              tempering: int = 1, tempering_beta_min: float = 0.1,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, tracer=None,
              keep_samples="auto", data_chunk: Optional[int] = None,
              precondition=False, precondition_clip=(1e-2, 1e2),
              precondition_windows: int = 1, compensated: bool = False,
              numerics: str = "default", mesh=None,
              **kwargs) -> RunResult:
        """Runs the sampler; options the port does not carry raise
        NotImplementedError naming them.

        ``folder_name`` writes the posterior in the reference text store
        (``networks_per_file`` networks a file) and the npz store, which
        ``Predictor`` reads; ``keep_samples`` ("auto", True or False)
        decides whether the samples are buffered and written at the end or
        streamed there chunk by chunk. ``checkpoint_dir`` saves the whole
        sampler state every ``checkpoint_every`` chunks and at the end, and
        a later call with the same configuration (a fresh ``Network`` of
        the same seed) resumes from it. ``metric_list`` (``metrics.py``) is
        displayed with the likelihood's hypers every ``display_skip``
        epochs; ``tracer`` (``utils/tracing.RunTracer``) times each chunk.

        ``tempering=K`` (K > 1) runs parallel tempering: ``K * n_chains``
        replicas on a geometric ladder of inverse temperatures from 1 down
        to ``tempering_beta_min``, one GP-UCB adapter per rung, an even/odd
        replica swap after every epoch; the result records the
        ``n_chains`` cold chains and the swap rates (``swap_accept``,
        ``swap_accept_rung``).

        ``trajectory="uturn"`` (default "adapter") runs NUTS-style dynamic
        trajectory lengths (sampler/uturn.py) instead of the GP-UCB
        adapter: burn-in trajectories record their first U-turn step, the
        step size is tuned toward 0.8 acceptance, and after burn-in each
        epoch draws its leapfrog count from the recorded lengths
        (``result.leapfrog`` holds the executed count per epoch). It needs
        ``n_adapters == 1`` and no tempering. ``uturn_probe``, "alternate"
        (default) or "always", is the burn-in probe schedule: "always"
        runs every burn-in chunk at ``ceil(1.5 * l_hat)``, "alternate"
        interleaves such probe chunks with chunks at ``l_hat``.

        The big-data options, as in the JAX package: ``data_chunk`` sums
        the likelihood's value and gradient over row chunks of that many
        rows (a divisor of the rows), on the plain path and on K3's (one
        K3 call a chunk), which bounds the activations, or K3's workspace,
        to ``chains x data_chunk x width`` (where even one call's
        workspace cannot fit the card, the driver builds no K3 and the
        main block takes the plain path). The others take the plain path:
        ``compensated=True`` runs the main block's leapfrog as Kahan sums,
        for step sizes within a few ulps of the parameters;
        ``numerics="exact"`` is ``compensated`` plus
        ``matmul_precision="highest"`` (TF32 off) on every dense layer;
        ``precondition`` (True for half the burn-in, or an epoch; needs
        ``n_chains >= 8``) estimates a diagonal metric from the fleet's
        spread, clipped to ``precondition_clip``, re-estimated at
        ``precondition_windows`` epochs up to the burn-in.

        ``mesh`` (``parallel.mesh.make_mesh``; its first device this
        Network's ``device``) splits the chains over its chains axis and the
        rows over its data axis, the likelihood summed over the data peers;
        ``n_chains`` must be a multiple of the chains axis and the rows of
        the data axis.
        """
        options = {_REF_TRAIN_KWARGS.get(k, k): v for k, v in kwargs.items()}
        options.pop("scaleExp", None)
        metric_list = options.pop("metric_list", metric_list)
        adjust_hypers = options.pop("adjust_hypers", adjust_hypers)
        folder_name = options.pop("folder_name", folder_name)
        networks_per_file = options.pop("networks_per_file",
                                        networks_per_file)
        display_skip = options.pop("display_skip", display_skip)
        if self.config is None:
            raise RuntimeError("call setup_mcmc() before train()")
        params, hypers = self.init_state()
        run_seed = int(torch.randint(2 ** 62, (1,),
                                     generator=self.generator))
        run_gen = torch.Generator(device=self.device).manual_seed(run_seed)
        self.results = sample_posterior(
            self.model, likelihood, self.train_x, self.train_y,
            config=self.config, params=params, hypers=hypers,
            generator=run_gen, epochs=epochs, sampling_step=sampling_step,
            adjust_hypers=adjust_hypers, display_skip=display_skip,
            n_chains=n_chains, n_adapters=n_adapters,
            chain_jitter=chain_jitter, use_fused=use_fused,
            verbose=verbose, tempering=tempering,
            tempering_beta_min=tempering_beta_min, metric_list=metric_list,
            x_validate=self.validate_x, y_validate=self.validate_y,
            folder_name=folder_name, networks_per_file=networks_per_file,
            keep_samples=keep_samples, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, tracer=tracer,
            data_chunk=data_chunk, precondition=precondition,
            precondition_clip=precondition_clip,
            precondition_windows=precondition_windows,
            compensated=compensated, numerics=numerics, mesh=mesh,
            **options)
        return self.results

    def predict(self, train: bool = True, params: Optional[tuple] = None):
        """Forward pass on the train or validation split, at ``params`` or
        (as the JAX package does) at a fresh initial state."""
        if params is None:
            params, _ = self.init_state()
        x = self.train_x if train else self.validate_x
        return self.model.apply(params, x)


# lowercase alias matching the reference class name
network = Network
