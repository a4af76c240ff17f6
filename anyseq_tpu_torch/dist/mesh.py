"""Device meshes for the multi-device paths, in one process.

The counterpart of the JAX package's ``dist/mesh.py``. JAX drives its
mesh from one process through ``shard_map``; the port does the same with
an array of torch devices: a ``(dp, sp)`` mesh whose "sp" axis shards one
pair's subject (the collective sweep, ``dist/collective.py``) and whose
devices all take slices of a batch (``dist/batch.py``). A device may
appear more than once: several ranks then share a card (or, on the CPU,
run the plain versions one after another), which is how the tests and a
one-card machine drive the multi-device paths.
"""
from __future__ import annotations

import numpy as np
import torch

from anyseq_tpu_torch.kernels._sweep import reduce_best


class Mesh:
    """An array of torch devices with one name per axis; ``shape`` maps
    each name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names):
        flat = [torch.device(d) for d in np.asarray(devices, object).flat]
        arr = np.empty(len(flat), object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(np.asarray(devices, object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not flat:
            raise ValueError("a mesh needs one axis name per dimension of a "
                             "non-empty device array")

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
        return f"Mesh({self.shape}, {self.device_list()})"


def check_mesh(mesh) -> Mesh:
    """The mesh, if it is one (a JAX mesh or a device list is not)."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a dist.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    return mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host runs: a no-op for one process, as in the JAX package.
    Several processes (torch.distributed) are not ported yet (ROADMAP
    queue 1, item 12b: multi-host)."""
    if coordinator is not None:
        raise NotImplementedError(
            "multi-host runs are not ported yet (ROADMAP queue 1, item 12b)")


def make_mesh(sp: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """A (dp, sp) mesh over `devices` (default: every CUDA device, which
    may be none); a list may repeat a device. Without sizes, every device
    lies on the sp axis."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
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
    return Mesh(arr.reshape(dp, sp), ("dp", "sp"))


def lex_best_merge(bests: torch.Tensor) -> torch.Tensor:
    """Merge (K, 3) int32 LOCAL-mode (score, i, j) bests into one: the
    highest score, then the smallest i, then the smallest j -- the first
    maximum in row-major order, whichever rank finished first."""
    return reduce_best(bests)
