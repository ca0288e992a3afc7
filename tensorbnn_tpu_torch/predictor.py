"""Posterior-ensemble predictor over a saved sample store, on the device.

Counterpart of ``tensorbnn_tpu/predictor.py``. The reference loops over
saved networks one forward pass at a time; here the ensemble lives on the
device (cached per thinning factor) and one ``torch.func.vmap`` of the
model's ``apply`` over the stacked sample axis runs it, a batched product
per dense layer. Reweighting evaluates every network's log posterior the
same way.

* ``predict``, ``predict_mean_sd``, ``predict_quantiles`` — ensemble
  predictions (every n-th network);
* ``train_probs`` / ``reweight`` — importance weights under swapped priors
  (exp(logp_new - logp_old), normalized);
* ``autocorrelation`` / ``autocorrelation_length`` — FFT-based, averaged
  over test points, per chain when the store has chain ids;
* ``extract_parameters`` / ``extract_hyper_parameters`` /
  ``parameter_statistics`` / ``hyper_statistics``.

It reads both the reference text store and the npz store (preferring
``samples.npz``), written by either package. Every store this package
writes carries chain ids (``chains.txt``, ``__chain_index__``), so a
multichain store gets a per-chain autocorrelation time; a JAX package's
buffered store has none and gets the pooled one, as there. Kept quirk:
Bernoulli reweighting is prior-only, as in the reference.

With a ``mesh`` (parallel/mesh.py; on the constructor or on a call) the
ensemble splits over the ``chains`` axis and the rows over the ``data``
axis, every block of networks placed once on its mesh row's devices and
cached per mesh (one mesh at a time, compared by identity); each device
runs its networks on its rows, with no sum between devices, and the
blocks are gathered in order. The ensemble is padded with copies of its
first network and the rows with zeros, both sliced off the result.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tensorbnn_tpu_torch.io import checkpoint, reference_format
from tensorbnn_tpu_torch.likelihoods import (
    BernoulliLikelihood,
    GaussianLikelihood,
    Likelihood,
)
from tensorbnn_tpu_torch.models.layers import LAYER_REGISTRY, LayerSpec
from tensorbnn_tpu_torch.models.sequential import Sequential
from tensorbnn_tpu_torch.network import _torch_dtype
from tensorbnn_tpu_torch.parallel.mesh import CHAIN_AXIS, DATA_AXIS
from tensorbnn_tpu_torch.sampler.potential import tree_leaves, \
    tree_unflatten
from tensorbnn_tpu_torch.utils import autocorr


def _tree_map(fn, tree):
    return tree_unflatten(tree, iter([fn(leaf) for leaf in tree_leaves(tree)]))


class Predictor:
    def __init__(self, directory_path: str, dtype=torch.float32,
                 custom_layer_dict: Optional[Dict] = None,
                 likelihood: Likelihood = GaussianLikelihood(sd=0.1),
                 layers: Optional[Sequence[LayerSpec]] = None,
                 device="cuda", mesh=None):
        """Loads a saved posterior-sample directory.

        Arguments:
            * directory_path: run directory (reference text store, or an
              npz store containing ``samples.npz``, which is preferred)
            * custom_layer_dict: extra name -> layer-constructor entries
            * likelihood: the training likelihood (used for reweighting)
            * layers: explicit layer specs; if omitted they are rebuilt from
              ``architecture.txt`` via the registry
            * device: where the ensemble lives and runs: the CUDA card
              unless the caller names another device
            * mesh: optional ``(chains, data)`` mesh
              (``parallel.mesh.make_mesh``): ``predict`` then shards the
              networks over its chains axis and the rows over its data
              axis (see the module docstring)
        """
        self.mesh = mesh
        self._mesh_cache = None
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Predictor: device {device!r} needs a CUDA card, and torch "
                f"sees none here; pass device='cpu' to run on the CPU")
        self.dtype = _torch_dtype(dtype)
        self.registry = dict(LAYER_REGISTRY)
        if custom_layer_dict:
            self.registry.update(custom_layer_dict)
        self.likelihood = likelihood
        self.directory_path = directory_path
        self._train_log_weights = None

        if os.path.exists(os.path.join(directory_path, "samples.npz")):
            self._load_native(directory_path, layers)
        else:
            self._load_reference(directory_path, layers)

        self.n_networks = self._count_networks()
        self._ensemble_cache = {}
        self._apply_ens = torch.func.vmap(self.model.apply,
                                          in_dims=(0, None))

    # -- loading ---------------------------------------------------------------

    def _make_layers(self, names: List[str],
                     layers: Optional[Sequence[LayerSpec]]):
        if layers is not None:
            self.layers = list(layers)
        else:
            self.layers = [self.registry[name]() for name in names]
        self.model = Sequential(self.layers)

    def _chain_major(self, chain_ids, trees):
        """Reorders the samples of a store with chain ids to chain-major
        (stable, so time order is kept within each chain) — the pooling
        order of ``RunResult.theta_pooled``; streamed multichain stores
        are time-major on disk."""
        if chain_ids is None:
            return None, trees
        order = np.argsort(chain_ids, kind="stable")
        return chain_ids[order], _tree_map(lambda v: v[order], trees)

    def _load_reference(self, path, layers):
        names, matrices, hyper_mat, chain_ids = \
            reference_format.load_run(path)
        self.chain_index, (matrices, hyper_mat) = self._chain_major(
            chain_ids, (matrices, hyper_mat))
        self._make_layers(names, layers)
        self.param_samples = reference_format.assign_ref_tensors(
            self.layers, matrices)
        self.hyper_samples, lik_cols = reference_format.assign_ref_hypers(
            self.layers, hyper_mat)
        self.lik_hyper_samples = self._lik_hypers_from_cols(lik_cols)

    def _load_native(self, path, layers):
        params, hypers, lik, chain_ids = \
            checkpoint.load_samples_with_chains(path)
        self.chain_index, (params, hypers, lik) = self._chain_major(
            chain_ids, (params, hypers, lik))
        arch = os.path.join(path, "architecture.txt")
        names = []
        if os.path.exists(arch):
            with open(arch) as f:
                names = [line.strip() for line in f if line.strip()]
        self._make_layers(names, layers)
        self.param_samples = params
        self.hyper_samples = hypers
        self.lik_hyper_samples = lik

    def _lik_hypers_from_cols(self, cols: np.ndarray) -> dict:
        keys = sorted(self.likelihood.init_hypers())
        return {k: cols[..., i] for i, k in enumerate(keys)}

    def _count_networks(self) -> int:
        for layer_params in self.param_samples:
            for v in layer_params.values():
                return int(np.asarray(v).shape[0])
        return 0

    # -- inference ---------------------------------------------------------------

    def _on_device(self, tree, n: int):
        """Every n-th network of a numpy sample tree, on the device."""
        return _tree_map(lambda v: torch.as_tensor(
            np.ascontiguousarray(np.asarray(v)[::n]),
            dtype=self.dtype).to(self.device), tree)

    def ensemble(self, n: int = 1):
        """The device-resident parameter ensemble of every n-th network,
        cached per thinning factor: repeated predict calls skip the
        host-to-device transfer."""
        cached = self._ensemble_cache.get(n)
        if cached is None:
            cached = self._on_device(self.param_samples, n)
            self._ensemble_cache[n] = cached
        return cached

    def _input(self, input_matrix) -> torch.Tensor:
        x = torch.as_tensor(input_matrix, dtype=self.dtype,
                            device=self.device)
        return x[:, None] if x.ndim == 1 else x

    def predict_tensor(self, input_matrix, n: int = 1) -> torch.Tensor:
        """Ensemble predictions of every n-th network as a device tensor of
        shape (ceil(S/n), batch, out_dims): one vmapped forward."""
        return self._apply_ens(self.ensemble(n), self._input(input_matrix))

    def predict(self, input_matrix, n: int = 1, mesh=None) -> np.ndarray:
        """Ensemble predictions using every n-th network, as a numpy array
        of shape (ceil(S/n), batch, out_dims); sharded over ``mesh`` (or
        the constructor's) when there is one."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is not None:
            return self._predict_sharded(input_matrix, n, mesh)
        return self.predict_tensor(input_matrix, n).cpu().numpy()

    def _mesh_ensemble(self, n: int, mesh):
        """``(blocks, S)``: every n-th network, padded to a multiple of the
        chains axis, split in order into one block a mesh row and placed on
        each of the row's devices; cached per thinning factor for one mesh
        at a time (a new mesh drops the old one's blocks)."""
        if self._mesh_cache is None or self._mesh_cache[0] is not mesh:
            self._mesh_cache = (mesh, {})
        cached = self._mesh_cache[1].get(n)
        if cached is None:
            n_ens = mesh.shape[CHAIN_AXIS]
            params = _tree_map(lambda v: np.asarray(v)[::n],
                               self.param_samples)
            s = next(v.shape[0] for v in tree_leaves(params))
            pad = (-s) % n_ens
            if pad:
                # copies of the first network; sliced off the result
                params = _tree_map(lambda v: np.concatenate(
                    [v, np.repeat(v[:1], pad, axis=0)]), params)
            k = (s + pad) // n_ens
            blocks = []
            for i, row in enumerate(mesh.devices):
                home = _tree_map(lambda v: torch.as_tensor(
                    np.ascontiguousarray(v[i * k:(i + 1) * k]),
                    dtype=self.dtype).to(row[0]), params)
                blocks.append([_tree_map(lambda t: t.to(d), home)
                               for d in row])
            cached = (blocks, s)
            self._mesh_cache[1][n] = cached
        return cached

    def _predict_sharded(self, input_matrix, n: int, mesh) -> np.ndarray:
        """``predict`` over ``mesh``: device (i, j) runs row i's networks
        on the j-th block of rows; no device reads another's output."""
        blocks, s = self._mesh_ensemble(n, mesh)
        x = torch.as_tensor(input_matrix, dtype=self.dtype)
        x = x[:, None] if x.ndim == 1 else x
        b = x.shape[0]
        pad = (-b) % mesh.shape[DATA_AXIS]
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        x_rows = x.chunk(mesh.shape[DATA_AXIS])
        # each block of rows reaches the first row's device once; other
        # rows take it from there (no copy on a repeated device)
        x_rows = [xr.to(d) for xr, d in zip(x_rows, mesh.devices[0])]
        first = mesh.first
        out = torch.cat([torch.cat(
            [self._apply_ens(blk, xr.to(d, non_blocking=True)).to(
                first, non_blocking=True)
             for blk, xr, d in zip(row_blocks, x_rows, row)], dim=1)
            for row_blocks, row in zip(blocks, mesh.devices)])
        return out.cpu().numpy()[:s, :b]

    def predict_mean_sd(self, input_matrix, n: int = 1, mesh=None):
        """Posterior predictive mean and sd over the ensemble."""
        preds = self.predict(input_matrix, n, mesh=mesh)
        return preds.mean(axis=0), preds.std(axis=0)

    def predict_quantiles(self, input_matrix, n: int = 1, mesh=None, *,
                          qs=(0.025, 0.5, 0.975)) -> np.ndarray:
        """Posterior predictive quantiles over the ensemble, shape
        ``(len(qs), batch, out_dims)``; the default gives an equal-tailed
        95% band and the median."""
        preds = self.predict(input_matrix, n, mesh=mesh)
        return np.quantile(preds, np.asarray(qs), axis=0)

    # -- reweighting ---------------------------------------------------------------

    def _log_posterior_weights(self, layers: Sequence[LayerSpec],
                               train_x, train_y, n: int,
                               likelihood: Optional[Likelihood]):
        """Per-network -(loglik + hyper probs), the reference's reweighting
        weight, for every n-th network in one vmapped pass."""
        model = Sequential(layers)
        params = self._on_device(self.param_samples, n)
        hypers = self._on_device(self.hyper_samples, n)
        lik_hypers = self._on_device(self.lik_hyper_samples, n)
        use_lik = likelihood is not None and not isinstance(
            likelihood, BernoulliLikelihood)
        if use_lik:
            x = self._input(train_x)
            y = torch.as_tensor(train_y, dtype=self.dtype, device=self.device)

        def one(p, h, lh):
            total = torch.zeros((), dtype=self.dtype, device=self.device)
            if use_lik:
                # Bernoulli reweighting is prior-only, as in the reference
                total = total + likelihood.log_likelihood(
                    model.apply(p, x), y, lh)
            total = total + model.log_hyper_prior(h, p)
            return -total

        return torch.func.vmap(one)(params, hypers, lik_hypers) \
            .cpu().numpy()

    def train_probs(self, train_x, train_y, n: int = 1,
                    likelihood: Optional[Likelihood] = None) -> np.ndarray:
        """Caches and returns the per-network negative log posterior terms
        used as reweighting baselines (the reference's ``trainProbs``)."""
        self._train_log_weights = self._log_posterior_weights(
            self.layers, train_x, train_y, n, likelihood)
        return self._train_log_weights

    def reweight(self, new_layers: Sequence[LayerSpec], train_x=None,
                 train_y=None, n: int = 1,
                 likelihood: Optional[Likelihood] = None) -> np.ndarray:
        """Importance weights for the ensemble under swapped priors.

        ``new_layers`` may also be a path to an architecture file. Returns
        normalized weights exp(logp_new - logp_old) / sum, normalized in
        log space (the largest exponent taken out first), so they stay
        finite where the JAX package's, exp'd as they are, overflow.
        """
        if self._train_log_weights is None:
            self._train_log_weights = self._log_posterior_weights(
                self.layers, train_x, train_y, n, likelihood)

        if isinstance(new_layers, str):
            with open(new_layers) as f:
                names = [line.strip() for line in f if line.strip()]
            new_layers = [self.registry[name]() for name in names]

        new_layers = list(new_layers)
        if not all(isinstance(lyr, LayerSpec) for lyr in new_layers):
            # the easy misuse (an input matrix where the swapped-prior
            # architecture goes) fails here, not deep inside Sequential
            raise TypeError(
                "reweight() takes the swapped-prior architecture as its "
                "first argument: a sequence of LayerSpec (or a path to an "
                f"architecture file), got {type(new_layers[0]).__name__} "
                "elements")
        new_log_weights = self._log_posterior_weights(
            new_layers, train_x, train_y, n, likelihood)
        log_w = self._train_log_weights - new_log_weights
        weighting = np.exp(log_w - np.max(log_w))
        return weighting / np.sum(weighting)

    # -- diagnostics ---------------------------------------------------------------

    def _chain_blocks(self):
        """Contiguous ``(start, stop)`` slices of the chain-major sample
        axis, one per chain, or ``None`` when the store has no multichain
        structure (one chain, or no chain ids)."""
        if self.chain_index is None:
            return None
        idx = np.asarray(self.chain_index)
        if idx.size == 0 or len(np.unique(idx)) <= 1:
            return None
        change = np.nonzero(np.diff(idx))[0] + 1
        starts = np.concatenate([[0], change])
        stops = np.concatenate([change, [idx.size]])
        return list(zip(starts.tolist(), stops.tolist()))

    def autocorrelation(self, input_data, n_max: int) -> np.ndarray:
        """Mean normalized autocorrelation function of the predictions,
        averaged over test points with finite integrated time. For a
        multichain store the ACF is computed per chain and averaged (no lag
        product crosses a chain boundary)."""
        preds = self.predict(input_data, n=1)
        output = np.atleast_2d(np.squeeze(preds).T)  # (points, S)

        blocks = self._chain_blocks() or [(0, output.shape[1])]
        acfs = []
        for a, b in blocks:
            seg = output[:, a:b]
            taus = autocorr.integrated_time_batch(seg)
            ok = ~np.isnan(taus)
            if np.any(ok):
                acfs.append(np.mean(
                    [autocorr.autocorr_function_1d(s) for s in seg[ok]],
                    axis=0))
        if not acfs:
            return np.zeros(min(n_max, output.shape[1]))
        min_len = min(len(a) for a in acfs)
        val_func = np.atleast_1d(np.mean([a[:min_len] for a in acfs], axis=0))
        if n_max < len(val_func):
            val_func = val_func[:n_max]
        return val_func

    def autocorrelation_length(self, input_data, n_max: int) -> float:
        """Mean integrated autocorrelation time over test points; for a
        multichain store, per chain and averaged over (point, chain) pairs
        (a tau over the chain-major pooled series would count the chains'
        mean differences as autocorrelation)."""
        preds = self.predict(input_data, n=1)
        output = np.atleast_2d(np.squeeze(preds).T)

        blocks = self._chain_blocks() or [(0, output.shape[1])]
        taus = np.concatenate([
            autocorr.integrated_time_batch(output[:, a:b]) for a, b in blocks])
        ok = ~np.isnan(taus)
        val = float(taus[ok].mean()) if np.any(ok) else 0.0
        if val > n_max:
            print("Correlation time is greater than maximum accepted value.")
        return float(val)

    # -- raw access / statistics -----------------------------------------------------

    def extract_parameters(self):
        """Stacked parameter trees (leading axis = network), numpy."""
        return self.param_samples

    def extract_hyper_parameters(self) -> np.ndarray:
        """Hyper samples as a (S, H) matrix in reference order."""
        return np.asarray(reference_format.ref_hyper_matrix(
            self.model, self.likelihood, self.hyper_samples,
            self.lik_hyper_samples))

    def parameter_statistics(self):
        """Per-parameter posterior means and sds."""
        means = _tree_map(lambda v: np.asarray(v).mean(axis=0),
                          self.param_samples)
        sds = _tree_map(lambda v: np.asarray(v).std(axis=0),
                        self.param_samples)
        return means, sds

    def hyper_statistics(self):
        mat = self.extract_hyper_parameters()
        if mat.size == 0:
            return np.zeros(0), np.zeros(0)
        return mat.mean(axis=0), mat.std(axis=0)


# lowercase alias matching the reference class name
predictor = Predictor
