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

On a card, and on a mesh whose entries are all cards
(``parallel/graphs.py::predict_route``), a call runs its forward as a
replay of a captured CUDA graph, the port of the JAX package's
``jax.jit`` of the vmapped forward (``tensorbnn_tpu/predictor.py:84``,
``:222-224``), which compiles at a key's first call: the graph of a key
(the thinning and the input's shape; on a mesh, an entry and its block of
rows) is captured at its first call, after one eager run on the card's
side stream whose output is that call's, and every later call of the key
copies its input into the graph's static buffer and replays
(``graphs.ForwardGraph``). A replay runs the eager forward's kernels, so
its bits are the eager route's. Every graph of a Predictor on one card
shares one memory pool; a graph's output is copied out before another
replays. A new mesh drops the old one's graphs with its blocks. The CPU
runs eagerly. ``predict`` copies the output into a fresh pinned block of
torch's host allocator and waits on that copy alone; the reweighting pass
stays eager (the JAX package's ``jax.jit`` there wraps a closure made
anew at every call, ``tensorbnn_tpu/predictor.py:259``, ``:271``, so it
compiles at every call and keeps no program to replay).
"""

from __future__ import annotations

import functools
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
from tensorbnn_tpu_torch.parallel import graphs
from tensorbnn_tpu_torch.parallel.mesh import CHAIN_AXIS, DATA_AXIS
from tensorbnn_tpu_torch.sampler.potential import tree_leaves, \
    tree_unflatten
from tensorbnn_tpu_torch.utils import autocorr


def _tree_map(fn, tree):
    return tree_unflatten(tree, iter([fn(leaf) for leaf in tree_leaves(tree)]))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A fresh numpy copy of ``t``: from a card through a fresh block of
    torch's caching pinned-host allocator (a steady call gets a freed block
    back and pays no ``cudaHostAlloc``), the host waiting on the copy's
    stream alone."""
    if t.device.type != "cuda":
        return t.numpy().copy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


class Predictor:
    #: the graph route's graph type: None takes ``graphs.CudaGraph`` where
    #: ``graphs.predict_route`` gives "graph"; the CPU tests set a stand-in,
    #: which takes the graph route on the CPU
    _graph_type = None
    #: True runs every call eagerly, on a card too (for comparisons)
    _eager = False

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
        self._graphs = {}
        self._pools = {}
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

    def _graph_type_of(self, mesh):
        """The graph type of a call over ``mesh`` (None: no mesh), or None
        for the eager route (``_graph_type``, ``_eager``)."""
        if self._eager:
            return None
        if self._graph_type is not None:
            return self._graph_type
        return (graphs.CudaGraph if graphs.predict_route(self.device, mesh)
                == "graph" else None)

    def _run(self, cache: dict, key, fn, x: torch.Tensor, graph_type):
        """``fn(x)`` on ``x``'s device, eagerly without ``graph_type``, else
        through the graph of ``key`` in ``cache`` (made at the key's first
        call, ``graphs.ForwardGraph.warm``, in the card's pool). Returns
        the output and whether it is a graph's own (overwritten at the
        graph's next replay, or another's of its pool)."""
        if graph_type is None:
            return fn(x), False
        graph = cache.get(key)
        if graph is not None:
            return graph(x), True
        if x.device not in self._pools:
            self._pools[x.device] = graph_type.new_pool()
        cache[key], out = graphs.ForwardGraph.warm(
            fn, x, graph_type, self._pools[x.device])
        return out, False

    def _forward(self, input_matrix, n: int):
        """The forward of every n-th network over the input on the device,
        and whether its output is a graph's own (``_run``); the graphs are
        keyed by ``n`` and the input's shape."""
        x = self._input(input_matrix)
        return self._run(self._graphs, (n,) + tuple(x.shape),
                         functools.partial(self._apply_ens, self.ensemble(n)),
                         x, self._graph_type_of(None))

    def predict_tensor(self, input_matrix, n: int = 1) -> torch.Tensor:
        """Ensemble predictions of every n-th network as a device tensor of
        shape (ceil(S/n), batch, out_dims): one vmapped forward, or a
        replay of its graph (then a copy of the graph's output, which no
        later call overwrites)."""
        out, own = self._forward(input_matrix, n)
        return out.clone() if own else out

    def predict(self, input_matrix, n: int = 1, mesh=None) -> np.ndarray:
        """Ensemble predictions using every n-th network, as a numpy array
        of shape (ceil(S/n), batch, out_dims); sharded over ``mesh`` (or
        the constructor's) when there is one."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is not None:
            return _to_host(self._forward_sharded(input_matrix, n, mesh))
        return _to_host(self._forward(input_matrix, n)[0])

    def _mesh_ensemble(self, n: int, mesh):
        """``(blocks, S)``: every n-th network, padded to a multiple of the
        chains axis, split in order into one block a mesh row and placed on
        each of the row's devices; cached per thinning factor for one mesh
        at a time, with the mesh's graphs (``_mesh_cache[2]``), which read
        the blocks: a new mesh drops the old one's blocks and graphs."""
        if self._mesh_cache is None or self._mesh_cache[0] is not mesh:
            self._mesh_cache = (mesh, {}, {})
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

    def _forward_sharded(self, input_matrix, n: int, mesh) -> torch.Tensor:
        """``predict`` over ``mesh`` on its first device: entry (i, j) runs
        row i's networks on the j-th block of rows (eagerly, or through its
        graph, keyed by ``n``, the entry and its rows' shape), and the
        unpadded part of its output is copied into place before the next
        entry runs; no device reads another's output. The entries run in
        one order, the order their graphs were captured in."""
        blocks, s = self._mesh_ensemble(n, mesh)
        cache, graph_type = self._mesh_cache[2], self._graph_type_of(mesh)
        x = torch.as_tensor(input_matrix, dtype=self.dtype)
        x = x[:, None] if x.ndim == 1 else x
        b = x.shape[0]
        n_ens, n_dat = mesh.shape[CHAIN_AXIS], mesh.shape[DATA_AXIS]
        k, r = -(-s // n_ens), -(-b // n_dat)
        x = torch.cat([x, x.new_zeros((r * n_dat - b,) + x.shape[1:])])
        # each block of rows reaches the first row's device once; other
        # rows take it from there (no copy on a repeated device)
        x_rows = [xr.to(d) for xr, d in zip(x.chunk(n_dat),
                                            mesh.devices[0])]
        out = None
        for i, (row_blocks, row) in enumerate(zip(blocks, mesh.devices)):
            for j, (blk, xr, d) in enumerate(zip(row_blocks, x_rows, row)):
                xr = xr.to(d, non_blocking=True)
                y, _ = self._run(cache, (n, i, j) + tuple(xr.shape),
                                 functools.partial(self._apply_ens, blk),
                                 xr, graph_type)
                if out is None:
                    out = torch.empty((s, b) + y.shape[2:], dtype=y.dtype,
                                      device=mesh.first)
                # a block of padding alone has nothing to copy
                ni, nj = min(k, s - i * k), min(r, b - j * r)
                if ni > 0 and nj > 0:
                    out[i * k:i * k + ni, j * r:j * r + nj].copy_(
                        y[:ni, :nj], non_blocking=True)
        return out

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
