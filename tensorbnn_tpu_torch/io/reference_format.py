"""Reader/writer for the reference's on-disk posterior-sample format.

A port of ``tensorbnn_tpu/io/reference_format.py``: for the same samples
its files are byte-equal to the JAX package's, but for one addition,
``save_run``'s ``chains.txt`` (below). Format (the reference's
``network.py`` writer and ``predictor.py`` reader):

* ``architecture.txt`` — one registry layer name per line.
* ``summary.txt``      — one line per state tensor with its shape dims,
  then ``"numNetworks numFiles numStates"``, then the hyper scalar count.
* ``{tensorIdx}.{fileIdx}.txt`` — ``networksPerFile`` consecutive networks'
  copies of state tensor ``tensorIdx`` appended row-wise (np.savetxt), in
  the reference's column-major layout (W: (out, in), b: (out, 1)).
* ``hypers{fileIdx}.txt`` — per network, all hyper scalars flattened in
  layer order followed by the likelihood's hypers.
* ``chains.txt`` (extension, absent in the reference) — one chain index per
  recorded network in disk order, written whenever a network came from a
  chain other than 0. The streaming multichain writer's disk order is
  time-major (epoch by epoch, chains interleaved) while in-memory pooling
  is chain-major; readers use it to reorder to chain-major so streamed and
  buffered runs are order-equivalent, and to estimate autocorrelation per
  chain. Unlike the JAX package's, this ``save_run`` writes it too, so a
  buffered multichain store keeps its chain ids.

The writer only materializes complete files (the reference's summary is only
rewritten on file-rotation boundaries, so its counts always describe full
files; a trailing partial file is never counted — network.py:610-646).

Either package's ``Predictor`` reads the other's output. The fast native
store is :mod:`tensorbnn_tpu_torch.io.checkpoint`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tensorbnn_tpu_torch.io import fast_text
from tensorbnn_tpu_torch.likelihoods import Likelihood
from tensorbnn_tpu_torch.models.sequential import Sequential


def _write_floats(f, arr) -> None:
    """Appends ``arr`` to the open binary file in np.savetxt's exact text
    format, through the native formatter when available (the pure-Python
    per-value ``%.18e`` path dominates a streamed run's host time at wide
    chain counts)."""
    arr = np.atleast_1d(np.asarray(arr))
    data = fast_text.format_floats(arr)
    if data is None:
        np.savetxt(f, arr)
    else:
        f.write(data)


def ref_state_tensors(model: Sequential, params: tuple) -> List[np.ndarray]:
    """Ordered reference-layout state tensors (leading axis = samples ok)."""
    out = []
    for layer, p in zip(model.layers, params):
        out.extend(np.asarray(t) for t in layer.ref_param_tensors(p))
    return out


def ref_hyper_matrix(model: Sequential, likelihood: Likelihood,
                     hypers: tuple, lik_hypers: dict) -> np.ndarray:
    """Stacks hyper scalars into reference order, shape (S, H) or (H,).

    Order: per-layer declaration order, then the likelihood's hypers
    (appended last, as the reference writes them).
    """
    cols = []
    for layer, h in zip(model.layers, hypers):
        cols.extend(np.asarray(v) for v in layer.ref_hyper_values(h))
    if likelihood.n_ref_hyper_scalars:
        for k in sorted(lik_hypers):
            cols.append(np.asarray(lik_hypers[k]))
    if not cols:
        return np.zeros((0,))
    return np.stack(cols, axis=-1)


def save_run(path: str, model: Sequential, likelihood: Likelihood,
             param_samples: tuple, hyper_samples: tuple,
             lik_hyper_samples: dict, networks_per_file: int,
             chain_ids: Optional[np.ndarray] = None) -> int:
    """Writes a sampled run in the reference directory layout.

    ``param_samples``/``hyper_samples``/``lik_hyper_samples`` are the model
    trees with a leading sample axis (numpy). ``chain_ids`` gives each
    sample's chain; when any is not 0, ``chains.txt`` holds them for the
    kept networks (a stale one is removed otherwise). Returns the number of
    networks actually recorded (complete files only).
    """
    os.makedirs(path, exist_ok=True)

    with open(os.path.join(path, "architecture.txt"), "w") as f:
        for name in model.layer_names:
            f.write(name + "\n")

    tensors = ref_state_tensors(model, param_samples)
    hyper_mat = ref_hyper_matrix(model, likelihood, hyper_samples,
                                 lik_hyper_samples)

    n_samples = tensors[0].shape[0] if tensors else 0
    n_files = n_samples // networks_per_file
    n_keep = n_files * networks_per_file

    for n, tensor in enumerate(tensors):
        for m in range(n_files):
            sl = tensor[m * networks_per_file:(m + 1) * networks_per_file]
            with open(os.path.join(path, f"{n}.{m}.txt"), "wb") as f:
                for net in sl:
                    _write_floats(f, net)

    n_hyper_scalars = hyper_mat.shape[-1] if hyper_mat.ndim else 0
    if n_hyper_scalars:
        for m in range(n_files):
            sl = hyper_mat[m * networks_per_file:(m + 1) * networks_per_file]
            with open(os.path.join(path, f"hypers{m}.txt"), "wb") as f:
                for net in sl:
                    _write_floats(f, net)

    with open(os.path.join(path, "summary.txt"), "w") as f:
        for tensor in tensors:
            shape = tensor.shape[1:]
            f.write(" ".join(str(s) for s in shape) + "\n")
        f.write(f"{n_keep} {n_files} {len(tensors)}\n")
        f.write(str(n_hyper_scalars))
    _write_chain_ids(path, [] if chain_ids is None
                     else np.asarray(chain_ids)[:n_keep])
    return n_keep


def _write_chain_ids(path: str, chain_ids) -> None:
    """``chains.txt`` with one id a line when any id is not 0; otherwise
    no such file (a stale one would be matched against this run)."""
    fname = os.path.join(path, "chains.txt")
    if any(int(c) for c in chain_ids):
        with open(fname, "w") as f:
            for c in chain_ids:
                f.write(f"{int(c)}\n")
    elif os.path.exists(fname):
        os.remove(fname)


class RunWriter:
    """Streaming writer in the reference's incremental style.

    The reference appends each sampled network to open per-tensor files and
    rotates/rewrites summary.txt every ``networksPerFile`` samples. This
    writer does the same, so arbitrarily long runs persist with
    O(networks_per_file) host memory instead of buffering the whole
    posterior.
    """

    def __init__(self, path: str, model: Sequential, likelihood: Likelihood,
                 networks_per_file: int, resume_state: dict = None):
        """``resume_state`` (a prior ``state_dict()``) restores mid-run
        streaming: the on-disk files are truncated back to exactly the
        checkpointed network count (a crash may have streamed a tail past
        the checkpoint) and appending continues from there. Without it,
        stale stream files from a previous run in ``path`` are removed
        (the files are opened in append mode)."""
        self.path = path
        self.model = model
        self.likelihood = likelihood
        self.per_file = networks_per_file
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "architecture.txt"), "w") as f:
            for name in model.layer_names:
                f.write(name + "\n")
        self._n_tensors = sum(layer.n_ref_param_tensors
                              for layer in model.layers)
        self._n_written = 0
        self._file_idx = 0
        self._files = None
        self._n_hyper_scalars = None
        self._chain_ids: List[int] = []
        if resume_state is not None:
            self._restore(resume_state)
        else:
            self._remove_stream_files(from_idx=0)
            # a stale chains.txt/summary.txt from a previous run in this
            # folder would be matched against THIS run's networks on load
            for name in ("chains.txt", "summary.txt"):
                p = os.path.join(path, name)
                if os.path.exists(p):
                    os.remove(p)

    # -- resume support ---------------------------------------------------------

    def state_dict(self) -> dict:
        # durability: the checkpoint claims n_written networks exist on
        # disk, so everything buffered must actually be there before the
        # checkpoint lands (a crash right after a checkpoint is exactly
        # the case resume exists for)
        if self._files:
            for f in self._files:
                f.flush()
                os.fsync(f.fileno())
        return {
            "n_written": self._n_written,
            "file_idx": self._file_idx,
            "chain_ids": list(self._chain_ids),
            "shapes": ([list(s) for s in self._shapes]
                       if self._n_hyper_scalars is not None else None),
            "n_hyper_scalars": self._n_hyper_scalars,
        }

    def _lines_per_network(self, shape) -> int:
        # np.savetxt writes one line per leading-axis row (atleast_1d)
        return int(shape[0]) if len(shape) else 1

    def _stream_paths(self, idx: int):
        paths = [os.path.join(self.path, f"{n}.{idx}.txt")
                 for n in range(self._n_tensors)]
        paths.append(os.path.join(self.path, f"hypers{idx}.txt"))
        return paths

    def _remove_stream_files(self, from_idx: int):
        idx = from_idx
        while True:
            paths = [p for p in self._stream_paths(idx)
                     if os.path.exists(p)]
            if not paths:
                break
            for p in paths:
                os.remove(p)
            idx += 1

    def _restore(self, state: dict) -> None:
        self._n_written = int(state["n_written"])
        self._file_idx = int(state["file_idx"])
        self._chain_ids = [int(c) for c in state["chain_ids"]]
        self._n_hyper_scalars = state["n_hyper_scalars"]
        if self._n_hyper_scalars is None:
            # checkpoint taken before the first network was streamed: the
            # crashed run may still have rotated files and written a
            # summary/chains pair past the checkpoint — mirror the
            # fresh-start branch so load_run never sees a summary whose
            # files were just deleted
            self._remove_stream_files(from_idx=0)
            for name in ("chains.txt", "summary.txt"):
                p = os.path.join(self.path, name)
                if os.path.exists(p):
                    os.remove(p)
            return
        self._shapes = [tuple(s) for s in state["shapes"]]
        # drop any files past the checkpointed rotation, then truncate the
        # in-progress file set to the checkpointed partial count
        self._remove_stream_files(from_idx=self._file_idx + 1)
        partial = self._n_written % self.per_file
        keep_rows = [partial * self._lines_per_network(s)
                     for s in self._shapes]
        keep_rows.append(partial * (self._n_hyper_scalars or 0))
        for p, rows in zip(self._stream_paths(self._file_idx), keep_rows):
            if not os.path.exists(p):
                if rows:
                    raise ValueError(
                        f"stream resume: {p} is missing but the "
                        f"checkpoint records {rows} rows in it — the "
                        f"stream directory does not match the checkpoint")
                continue
            if rows == 0:
                os.remove(p)
                continue
            # truncate at the byte offset of row `rows`, streaming line by
            # line — buffering the whole file (hundreds of MB of text for
            # wide tensors) just to drop its tail would hold it all in
            # host memory during resume
            offset = 0
            found = 0
            with open(p, "rb") as f:
                for line in f:
                    found += 1
                    offset += len(line)
                    if found == rows:
                        break
            if found < rows:
                raise ValueError(
                    f"stream resume: {p} holds {found} rows but the "
                    f"checkpoint records {rows} — the stream files were "
                    f"modified or written without the checkpoint's flush")
            os.truncate(p, offset)
        self._open_files()
        self._write_summary()

    def _open_files(self):
        self._files = [
            open(os.path.join(self.path, f"{n}.{self._file_idx}.txt"), "ab")
            for n in range(self._n_tensors)]
        if self._n_hyper_scalars:
            self._files.append(open(
                os.path.join(self.path, f"hypers{self._file_idx}.txt"),
                "ab"))

    def append(self, params: tuple, hypers: tuple, lik_hypers: dict,
               chain: int = 0):
        """Appends one network (unstacked pytrees); ``chain`` records which
        chain produced it (multichain disk order is time-major)."""
        self._chain_ids.append(int(chain))
        tensors = ref_state_tensors(self.model, params)
        hyper_vec = ref_hyper_matrix(self.model, self.likelihood,
                                     hypers, lik_hypers)
        if self._n_hyper_scalars is None:
            self._n_hyper_scalars = int(hyper_vec.shape[-1]) \
                if hyper_vec.ndim else 0
            self._shapes = [t.shape for t in tensors]
            self._open_files()

        for f, t in zip(self._files, tensors):
            _write_floats(f, t)
        if self._n_hyper_scalars:
            _write_floats(self._files[-1],
                          np.asarray(hyper_vec).reshape(-1))
        self._n_written += 1

        if self._n_written % self.per_file == 0:
            for f in self._files:
                f.close()
            self._file_idx += 1
            self._write_summary()
            self._open_files()

    def _write_summary(self):
        n_complete = (self._n_written // self.per_file) * self.per_file
        n_files = self._n_written // self.per_file
        with open(os.path.join(self.path, "summary.txt"), "w") as f:
            for shape in self._shapes:
                f.write(" ".join(str(s) for s in shape) + "\n")
            f.write(f"{n_complete} {n_files} {self._n_tensors}\n")
            f.write(str(self._n_hyper_scalars or 0))
        # chain index per kept network (complete files only), if any network
        # came from a chain other than 0
        if any(self._chain_ids[:n_complete]):
            _write_chain_ids(self.path, self._chain_ids[:n_complete])

    def close(self) -> int:
        """Finalizes; returns the number of recorded (complete-file)
        networks.

        A trailing partial file stays on disk: ``summary.txt`` counts
        complete files only (the reference's semantics), so loaders never
        read it — and a later resume from a checkpoint taken mid-file
        needs those networks to truncate back to rather than re-sample."""
        if self._files:
            for f in self._files:
                f.close()
            self._write_summary()
        return (self._n_written // self.per_file) * self.per_file


def load_run(path: str) -> Tuple[List[str], List[np.ndarray], np.ndarray,
                                 Optional[np.ndarray]]:
    """Loads a reference-format directory.

    Returns ``(layer_names, matrices, hypers, chain_ids)`` where each entry
    of ``matrices`` has shape (numNetworks, rows, cols) in reference layout,
    ``hypers`` has shape (numNetworks, numHypers) (empty second dim if none)
    and ``chain_ids`` is the per-network chain index from ``chains.txt``
    (None when absent — single-chain or reference-written directories).
    Mirrors the parsing of the reference's predictor.
    """
    summary = []
    with open(os.path.join(path, "summary.txt")) as f:
        for line in f:
            summary.append(line.split())
    num_networks = int(summary[-2][0])
    num_files = int(summary[-2][1])
    num_matrices = int(summary[-2][2])
    num_hypers = int(summary[-1][0])
    per_file = num_networks // num_files if num_files else 0

    matrices = []
    for n in range(num_matrices):
        dims = [int(v) for v in summary[n]]
        rows = dims[0]
        cols = dims[1] if len(dims) == 2 else 1
        chunks = []
        for m in range(num_files):
            flat = fast_text.load_floats(os.path.join(path, f"{n}.{m}.txt"))
            chunks.append(flat.reshape(per_file, rows, cols))
        matrices.append(np.concatenate(chunks, axis=0))

    if num_hypers > 0:
        hyper_chunks = []
        for m in range(num_files):
            flat = fast_text.load_floats(
                os.path.join(path, f"hypers{m}.txt"))
            hyper_chunks.append(flat.reshape(per_file, num_hypers))
        hypers = np.concatenate(hyper_chunks, axis=0)
    else:
        hypers = np.zeros((num_networks, 0), np.float32)

    with open(os.path.join(path, "architecture.txt")) as f:
        layer_names = [line.strip() for line in f if line.strip()]

    chain_ids = None
    chains_file = os.path.join(path, "chains.txt")
    if os.path.exists(chains_file):
        chain_ids = np.loadtxt(chains_file, dtype=np.int64).reshape(-1)
        chain_ids = chain_ids[:num_networks]

    return layer_names, matrices, hypers, chain_ids


def assign_ref_tensors(layers: Sequence, matrices: List[np.ndarray]):
    """Distributes loaded reference matrices back into per-layer params.

    Each matrix keeps its leading sample axis; layer conversion hooks handle
    the layout transposes. Returns a tuple of per-layer param dicts (stacked
    over samples).
    """
    params = []
    idx = 0
    for layer in layers:
        n = layer.n_ref_param_tensors
        params.append(layer.params_from_ref(matrices[idx:idx + n]))
        idx += n
    return tuple(params)


def assign_ref_hypers(layers: Sequence, hyper_mat: np.ndarray):
    """Distributes hyper scalar columns back into per-layer hyper dicts.

    Returns ``(hypers_tuple, remaining_columns)`` — the trailing columns
    belong to the likelihood.
    """
    hypers = []
    idx = 0
    for layer in layers:
        n = layer.n_ref_hyper_scalars
        cols = [hyper_mat[..., idx + j] for j in range(n)]
        hypers.append(layer.hypers_from_ref(cols))
        idx += n
    return tuple(hypers), hyper_mat[..., idx:]
