"""Device meshes for the multi-device paths, in one process or several.

The counterpart of the JAX package's ``dist/mesh.py``. JAX drives its
mesh through ``shard_map``; the port does the same with an array of torch
devices: a ``(dp, sp)`` mesh whose "sp" axis shards one pair's subject
(the collective sweep, ``dist/collective.py``) and whose devices all take
slices of a batch (``dist/batch.py``). A device may appear more than
once: several ranks then share a card (or, on the CPU, run the plain
versions one after another), which is how the tests and a one-card
machine drive the multi-device paths.

Several processes (one a host, as under ``jax.distributed``): every
process calls :func:`init_distributed` with the same coordinator, then
:func:`make_mesh` with its own devices; the mesh lays every process's
devices out in process order and records which process owns each entry.
Each process runs the same program on the same inputs, drives only the
entries it owns (``dist/process.py`` carries what crosses processes),
and returns the same results as every other process.
"""
from __future__ import annotations

import numpy as np
import torch

from anyseq_tpu_torch.dist import process
from anyseq_tpu_torch.kernels._sweep import reduce_best


class Mesh:
    """An array of torch devices with one name per axis; ``shape`` maps
    each name to its size, as a JAX mesh's does. ``owners`` (same shape)
    names the process that owns each entry (default: this process); a
    mesh over several processes covers every process of the run, in
    process order along its row-major order."""

    def __init__(self, devices, axis_names, owners=None):
        flat = [torch.device(d) for d in np.asarray(devices, object).flat]
        arr = np.empty(len(flat), object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(np.asarray(devices, object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not flat:
            raise ValueError("a mesh needs one axis name per dimension of a "
                             "non-empty device array")
        if owners is None:
            owners = np.full(self.devices.shape, process.index())
        self.owners = np.asarray(owners, np.int64).reshape(self.devices.shape)
        order = self.owners.reshape(-1)
        if self.spans_processes and (
                (np.diff(order) < 0).any()
                or set(order.tolist()) != set(range(process.count()))):
            raise ValueError("a mesh over several processes lays out every "
                             "process's devices, in process order")
        if process.index() not in order:
            raise ValueError("a mesh needs a device of this process")

    @property
    def spans_processes(self) -> bool:
        """Whether other processes own entries: every process then makes
        the mesh's calls together."""
        return bool((self.owners != self.owners.flat[0]).any())

    @property
    def home(self) -> torch.device:
        """This process's first device: it holds the inputs and the
        outputs of the calls over the mesh."""
        return self.device_list()[self.owner_list().index(process.index())]

    def owner_list(self) -> list:
        """The owners in row-major order."""
        return self.owners.reshape(-1).tolist()

    def reshape(self, shape, axis_names) -> "Mesh":
        """The same entries (and owners) as an array of another shape."""
        return Mesh(self.devices.reshape(shape), axis_names,
                    self.owners.reshape(shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """The devices in row-major order (repeats kept)."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        owners = (f", owners {self.owner_list()}" if self.spans_processes
                  else "")
        return f"Mesh({self.shape}, {self.device_list()}{owners})"


def check_mesh(mesh) -> Mesh:
    """The mesh, if it is one (a JAX mesh or a device list is not)."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a dist.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    return mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join this process to a multi-process run: ``coordinator`` is the
    "host:port" that process 0 listens on (every process passes the same),
    ``num_processes`` the run's processes and ``process_id`` this one's
    index. A no-op without a coordinator, as in the JAX package."""
    if coordinator is None:
        return
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    """This process's index in the run (0 for a single process)."""
    return process.index()


def process_count() -> int:
    """The processes of the run (1 for a single process)."""
    return process.count()


def make_mesh(sp: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """A (dp, sp) mesh over `devices` (default: every CUDA device, which
    may be none); a list may repeat a device. Without sizes, every device
    lies on the sp axis. After :func:`init_distributed`, `devices` are
    this process's, and the mesh holds every process's devices in process
    order (every process calls this)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    owners = [process.index()] * len(devices)
    if process.count() > 1:
        entries = process.gather_objects([(process.index(), str(d))
                                          for d in devices])
        owners = [p for p, _ in entries]
        devices = [torch.device(d) for _, d in entries]
    n = len(devices)
    if sp is None and dp is None:
        sp, dp = n, 1
    elif sp is None:
        sp = n // dp
    elif dp is None:
        dp = n // sp
    if sp * dp != n or n == 0:
        raise ValueError(f"sp*dp={sp * dp} != device count {n}")
    arr = np.empty(n, object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, sp), ("dp", "sp"),
                np.reshape(owners, (dp, sp)))


def lex_best_merge(bests: torch.Tensor) -> torch.Tensor:
    """Merge (K, 3) int32 LOCAL-mode (score, i, j) bests into one: the
    highest score, then the smallest i, then the smallest j -- the first
    maximum in row-major order, whichever rank finished first."""
    return reduce_best(bests)
