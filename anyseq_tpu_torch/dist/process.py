"""The transport between the processes of a multi-process run.

The counterpart of what ``jax.distributed`` and ``process_allgather`` do
for the JAX package's multi-host runs, over ``torch.distributed`` with the
gloo backend (``dist.mesh.init_distributed`` joins the processes). Every
call here is made by every process of the run, in the same order (SPMD),
except :func:`send_band` / :func:`recv_band`, which only the two
neighbours of a process edge make. Tensors travel through host memory:
device tensors are copied to the host first (the collective sweep stages
its columns in pinned buffers), and what comes back lies on the CPU.

Gloo only: NCCL refuses two ranks on one card (the one-card machine's
two-process runs) and a band's column is at most a few MB, against the
hundreds of ms a band takes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def index() -> int:
    """This process's index in the run (0 without one)."""
    return dist.get_rank() if initialized() else 0


def count() -> int:
    """The processes of the run (1 without one)."""
    return dist.get_world_size() if initialized() else 1


def send_band(buf: torch.Tensor, dst: int, tag: int) -> None:
    """Send one band's boundary column(s), a contiguous host tensor, to
    process `dst`; returns once `dst` has received it."""
    dist.send(buf, dst, tag=tag)


def recv_band(buf: torch.Tensor, src: int, tag: int) -> None:
    """Receive the band that process `src` sent with `tag` into `buf`."""
    dist.recv(buf, src, tag=tag)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor of a dtype that gloo carries (bool as
    uint8)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


def gather(tensors: dict | None) -> dict:
    """Every process's `tensors` (a dict of named tensors, or None where
    this process has none), each name's joined along dim 0 in process
    order, on the CPU. Lengths along dim 0 may differ from process to
    process; the names, the other dimensions and the dtype come from the
    processes that have them."""
    meta = [None] * count()
    dist.all_gather_object(meta, None if tensors is None else {
        k: (t.shape[0], tuple(t.shape[1:]), t.dtype)
        for k, t in tensors.items()})
    spec = next(m for m in meta if m is not None)
    out = {}
    for name, (_, rest, dtype) in spec.items():
        lens = [0 if m is None else m[name][0] for m in meta]
        if not max(lens) or 0 in rest:     # gloo takes no empty tensors
            out[name] = torch.zeros((sum(lens), *rest), dtype=dtype)
            continue
        buf = _wire(torch.zeros((max(lens), *rest), dtype=dtype))
        if tensors is not None:
            buf[:lens[index()]] = _wire(tensors[name])
        parts = [torch.empty_like(buf) for _ in lens]
        dist.all_gather(parts, buf)
        out[name] = _unwire(torch.cat([p[:n] for p, n in zip(parts, lens)]),
                            dtype)
    return out


def gather_objects(items: list) -> list:
    """Every process's list of picklable `items`, joined in process
    order."""
    lists = [None] * count()
    dist.all_gather_object(lists, items)
    return [x for items_ in lists for x in items_]


def broadcast_from(owner: int, t: torch.Tensor | None) -> torch.Tensor:
    """Process `owner`'s tensor `t` (the others pass None) on every
    process, on the CPU."""
    meta = [None if t is None else (tuple(t.shape), t.dtype)]
    dist.broadcast_object_list(meta, src=owner)
    shape, dtype = meta[0]
    buf = (_wire(t) if index() == owner
           else _wire(torch.empty(shape, dtype=dtype)))
    dist.broadcast(buf, src=owner)
    return _unwire(buf, dtype)


def barrier() -> None:
    dist.barrier()
