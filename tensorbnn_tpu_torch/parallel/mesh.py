"""The ``(chains, data)`` device mesh and the data peers' sum.

Counterpart of ``tensorbnn_tpu/parallel/mesh.py``. A ``Mesh`` is an
``(n_chain, n_data)`` grid of ``torch.device`` entries with axes
``(chains, data)``:

* ``chains`` — chain groups, one a row of the mesh; no sum ever crosses
  this axis;
* ``data`` — the training rows, split over the row's devices (its *data
  peers*); the likelihood's value and gradient, and the stats potential's
  residual power and row count, are summed over them.

The JAX package runs one program a device under ``shard_map`` and sums with
``lax.psum``. This port is one Python process driving every device: a chain
shard's state lives on its row's first device (its *home*), the other
peers hold only their rows, and each evaluation copies its argument to
every peer, runs there and sums the parts on the home device in peer order
(``DataPeers.sum``). The HMC arithmetic therefore runs once a chain shard,
where the JAX package repeats it on every peer (whose replicated keys make
the copies agree). One Python thread issues every shard's launches.

A device may repeat in a mesh (a deliberate difference from JAX, whose
mesh holds distinct devices): ``make_mesh(2, 2, devices=[torch.device(
"cuda")] * 4)`` lays a virtual mesh on one card, or on the CPU, and runs
the code that runs over distinct cards (a copy to the same device is no
copy). The kernels' wrappers make their tensors' card the current device
around each launch, so a shard on another card launches there.

``DataPeers.sum`` is the one place where the peers meet. The stepped graph
runner (parallel/graphs.py) sets a ``mode`` on the instance while it warms
up, captures and replays an epoch's parts: the sum is then a boundary
between graphs (a graph of each peer's evaluation on its own card, with
the copies between the cards issued by the host). Without a mode the sum
runs eagerly as above.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


def _resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index
    takes the current one, as tensors placed on it report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() \
            else 0
        device = torch.device("cuda", index)
    return device


class Mesh:
    """An ``(n_chain, n_data)`` grid of devices with axes ``(chains,
    data)``; ``shape[CHAIN_AXIS]`` and ``shape[DATA_AXIS]`` as in JAX."""

    axis_names = (CHAIN_AXIS, DATA_AXIS)

    def __init__(self, devices: Sequence[Sequence]):
        self.devices = [[_resolve(d) for d in row] for row in devices]
        self.shape = {CHAIN_AXIS: len(self.devices),
                      DATA_AXIS: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The first device: the run's draws and gathered outputs live
        there."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[CHAIN_AXIS]}x{self.shape[DATA_AXIS]}, "
                f"{[[str(d) for d in row] for row in self.devices]})")


def make_mesh(n_chain_devices: Optional[int] = None,
              n_data_devices: Optional[int] = None,
              devices=None) -> Mesh:
    """Builds a ``(chains, data)`` mesh over ``devices``, by default every
    CUDA device (never the CPU: without a card it raises).

    Defaults put every device on the chain axis; pass ``n_data_devices`` to
    trade chain-axis width for data-parallel likelihood bandwidth. A device
    may repeat in ``devices`` (a virtual mesh on one card or on the CPU).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch sees no CUDA device; pass devices= (a "
                "device may repeat, e.g. [torch.device('cpu')] * 4) to lay "
                "a mesh elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n_chain_devices is None and n_data_devices is None:
        n_chain_devices, n_data_devices = n, 1
    elif n_chain_devices is None:
        n_chain_devices = n // n_data_devices
    elif n_data_devices is None:
        n_data_devices = n // n_chain_devices
    if n_chain_devices * n_data_devices != n:
        raise ValueError(
            f"mesh {n_chain_devices}x{n_data_devices} != {n} devices")
    return Mesh([devices[i * n_data_devices:(i + 1) * n_data_devices]
                 for i in range(n_chain_devices)])


def pad_to_multiple(x: np.ndarray, multiple: int,
                    axis: int = 0) -> Tuple[np.ndarray, int]:
    """Zero-pads ``x`` along ``axis`` to a multiple; returns (padded, n_pad).

    Likelihood shards must divide evenly; padding rows are masked out by the
    caller (weight-zero likelihood contribution).
    """
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, 0
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width), rem


def local_rows(n_rows: int, n_data: int) -> int:
    """A data peer's row count: ``n_rows`` split over ``n_data`` peers
    (the JAX driver's check and message where they do not divide)."""
    if n_rows % n_data:
        raise ValueError(
            f"training rows {n_rows} must divide the data axis "
            f"({n_data}); pad the dataset")
    return n_rows // n_data


def to_device(value, device: torch.device):
    """A tensor, or a tuple of them (nested), copied to ``device`` with
    ``non_blocking`` (where it lives already, as it is); anything else as
    it is."""
    if isinstance(value, tuple):
        return tuple(to_device(v, device) for v in value)
    if torch.is_tensor(value):
        return value.to(device, non_blocking=True)
    return value


def data_sum(parts: Sequence, device: torch.device):
    """The sum over the data peers of their ``parts`` (each a tensor or a
    tuple of tensors, e.g. ``(value (C,), grad (C, D))``), taken in peer
    order on ``device``. Each part is copied there with ``non_blocking``
    (no copy where it already lives), so the host never waits: one code
    path for distinct and for repeated devices."""
    total = to_device(parts[0], device)
    for part in parts[1:]:
        part = to_device(part, device)
        total = (tuple(t + p for t, p in zip(total, part))
                 if isinstance(total, tuple) else total + part)
    return total


def gather(blocks: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The chain shards' blocks concatenated along ``dim`` on the first
    one's device (copied with ``non_blocking``); one block as it is."""
    if len(blocks) == 1:
        return blocks[0]
    first = blocks[0].device
    return torch.cat([b.to(first, non_blocking=True) for b in blocks], dim)


class DataPeers:
    """The data peers of one chain shard: their devices (the mesh's row)
    and each one's rows ``(x_j, y_j)``, placed on it once. The first
    peer's device is the shard's home, where its state lives."""

    def __init__(self, devices: Sequence[torch.device], shards: Sequence):
        self.devices = [_resolve(d) for d in devices]
        self.shards = [(x.to(d), y.to(d)) for d, (x, y) in
                       zip(self.devices, shards)]
        #: ``mode(fns, args)`` takes every sum while set (None: eager)
        self.mode = None

    @classmethod
    def split(cls, devices: Sequence[torch.device], x: torch.Tensor,
              y: torch.Tensor) -> "DataPeers":
        """``x`` and ``y`` split into equal row blocks, one a device, in
        order (``local_rows``)."""
        k = local_rows(x.shape[0], len(devices))
        return cls(devices, [(x[j * k:(j + 1) * k], y[j * k:(j + 1) * k])
                             for j in range(len(devices))])

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def sum(self, fns: Sequence[Callable], *args):
        """``sum_j fns[j](*args)`` with ``args`` copied to peer ``j``'s
        device, summed on the home device (``data_sum``); while ``mode``
        is set, ``mode(fns, args)``. The mode is read at each call: the
        potentials hold this method bound when the epoch is built."""
        if self.mode is not None:
            return self.mode(fns, args)
        return data_sum([fn(*to_device(args, d))
                         for fn, d in zip(fns, self.devices)], self.home)
