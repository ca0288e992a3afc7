"""Native checkpoint store: stacked-sample trees + full sampler resume.

A port of ``tensorbnn_tpu/io/checkpoint.py`` (numpy only). The reference
persists only posterior samples as text files and cannot resume a chain
mid-run. This store keeps:

* ``samples.npz``  — posterior sample stacks (one array per tree leaf,
  leading axis = sample), written with numpy's compressed container, and
  each sample's chain id under ``__chain_index__`` (an addition: the JAX
  package's ``load_samples`` skips keys without a ``params/``, ``hypers/``
  or ``lik/`` prefix, so it still reads the file);
* ``resume.npz`` + ``resume.json`` — the full device carry (flat
  theta/eta, dual-averaging state, epoch counter) and the run generator's
  state, plus host state (adapters, step size, leapfrog, epoch
  bookkeeping, the diagonal metric's step scale and how many of its
  windows have fired), for a bit-exact continuation of an interrupted run;
* ``resume_seg{i}.npz`` — the samples recorded between two checkpoints.

Tree leaves are keyed by ``layer{i}/{name}`` paths so files are
self-describing.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np


def _flatten_tree(params: tuple, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for i, layer_params in enumerate(params):
        for k, v in layer_params.items():
            out[f"{prefix}{i}/{k}"] = np.asarray(v)
    return out


def _unflatten_tree(arrays: Dict[str, np.ndarray], prefix: str) -> tuple:
    by_layer: Dict[int, Dict[str, np.ndarray]] = {}
    max_idx = -1
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        idx_str, name = rest.split("/", 1)
        idx = int(idx_str)
        by_layer.setdefault(idx, {})[name] = v
        max_idx = max(max_idx, idx)
    return tuple(by_layer.get(i, {}) for i in range(max_idx + 1))


#: key of the per-sample chain ids in ``samples.npz``
CHAIN_INDEX_KEY = "__chain_index__"


def save_samples(path: str, param_samples: tuple, hyper_samples: tuple,
                 lik_hyper_samples: dict,
                 chain_index: Optional[np.ndarray] = None) -> str:
    """Writes stacked posterior samples to ``<path>/samples.npz``, with
    each sample's chain id when ``chain_index`` is given."""
    os.makedirs(path, exist_ok=True)
    arrays = _flatten_tree(param_samples, "params/")
    arrays.update(_flatten_tree(hyper_samples, "hypers/"))
    for k, v in lik_hyper_samples.items():
        arrays[f"lik/{k}"] = np.asarray(v)
    arrays["__n_layers__"] = np.asarray(len(param_samples))
    if chain_index is not None:
        arrays[CHAIN_INDEX_KEY] = np.asarray(chain_index, np.int64)
    fname = os.path.join(path, "samples.npz")
    np.savez_compressed(fname, **arrays)
    return fname


def load_samples(path: str) -> Tuple[tuple, tuple, dict]:
    """Loads ``(param_samples, hyper_samples, lik_hyper_samples)``."""
    return load_samples_with_chains(path)[:3]


def load_samples_with_chains(path: str):
    """Loads ``(param_samples, hyper_samples, lik_hyper_samples,
    chain_index)``; ``chain_index`` is None for a store without chain ids
    (the JAX package's)."""
    with np.load(os.path.join(path, "samples.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    n_layers = int(arrays.pop("__n_layers__"))
    chain_index = arrays.pop(CHAIN_INDEX_KEY, None)
    params = _unflatten_tree(arrays, "params/")
    hypers = _unflatten_tree(arrays, "hypers/")
    # pad to full layer count (stateless layers have no leaves)
    params = tuple((params[i] if i < len(params) else {})
                   for i in range(n_layers))
    hypers = tuple((hypers[i] if i < len(hypers) else {})
                   for i in range(n_layers))
    lik = {k.split("/", 1)[1]: v for k, v in arrays.items()
           if k.startswith("lik/")}
    return params, hypers, lik, chain_index


def save_resume(path: str, *, carry_arrays: Dict[str, np.ndarray],
                host_state: dict) -> None:
    """Saves the device carry plus host-side JSON state for resume.

    Both files go through tmp-write + atomic rename, and they carry a
    shared pairing token: a crash inside this function can therefore
    never produce a *silently* torn checkpoint (new carry paired with
    old host state would re-execute epochs from the wrong device state)
    — at worst the tokens mismatch and ``load_resume`` raises a clear
    error instead of resuming wrong.
    """
    os.makedirs(path, exist_ok=True)
    token = os.urandom(8).hex()
    npz = os.path.join(path, "resume.npz")
    js = os.path.join(path, "resume.json")
    # np.savez appends ".npz" when the filename lacks it — give the tmp
    # file the suffix up front so the rename source is deterministic
    tmp_npz = npz + ".tmp.npz"
    np.savez(tmp_npz, __pair_token__=np.frombuffer(
        token.encode(), dtype=np.uint8).copy(), **carry_arrays)
    os.replace(tmp_npz, npz)
    tmp_js = js + ".tmp"
    with open(tmp_js, "w") as f:
        json.dump({"__pair_token__": token, **host_state}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_js, js)


def save_sample_segment(path: str, idx: int, theta: np.ndarray,
                        eta: np.ndarray) -> str:
    """Persists one incremental sample segment (``(S_new, C, D)`` stacks).

    Checkpoint cost stays O(samples since the last checkpoint) instead of
    re-writing the whole accumulated history every time: the driver writes
    a new segment per checkpoint and records the segment count in the
    resume host state. Segments are written *before* resume.json, so a
    crash between the two leaves an unreferenced trailing segment that the
    next checkpoint simply overwrites.
    """
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"resume_seg{idx}.npz")
    np.savez(fname, theta=theta, eta=eta)
    return fname


def load_sample_segments(path: str, n_segments: int):
    """Concatenates the first ``n_segments`` segments back into per-epoch
    sample row lists (``[(C, D), ...]``, the driver's in-memory form)."""
    thetas, etas = [], []
    for i in range(n_segments):
        with np.load(os.path.join(path, f"resume_seg{i}.npz")) as data:
            thetas.extend(np.asarray(data["theta"]))
            etas.extend(np.asarray(data["eta"]))
    return thetas, etas


def load_resume(path: str) -> Optional[Tuple[Dict[str, np.ndarray], dict]]:
    """Returns ``(carry_arrays, host_state)`` or None if absent.

    Raises if the npz/json pairing tokens disagree (a crash landed
    between the two renames in :func:`save_resume`) — resuming from the
    mixed pair would silently produce a wrong trajectory. Legacy
    checkpoints without tokens load as before.
    """
    npz = os.path.join(path, "resume.npz")
    js = os.path.join(path, "resume.json")
    if not (os.path.exists(npz) and os.path.exists(js)):
        return None
    with np.load(npz) as data:
        arrays = {k: data[k] for k in data.files}
    with open(js) as f:
        host_state = json.load(f)
    tok_npz = arrays.pop("__pair_token__", None)
    tok_js = host_state.pop("__pair_token__", None)
    if tok_npz is not None or tok_js is not None:
        tok_npz = (bytes(np.asarray(tok_npz, np.uint8)).decode()
                   if tok_npz is not None else None)
        if tok_npz != tok_js:
            raise ValueError(
                f"checkpoint in {path} is torn: resume.npz and "
                f"resume.json were written by different checkpoint "
                f"saves (a crash landed between them); delete the "
                f"checkpoint directory to start fresh — resuming the "
                f"mixed pair would produce a wrong trajectory")
    return arrays, host_state
