"""Data-parallel batches over the devices of a mesh.

The counterpart of the JAX package's ``dist/batch.py``: the batch
dimension of a batched sweep is split over every device of the mesh in
order (the flattened (dp, sp) devices, repeats included), each device
runs the single-device port's own route on its slice -- K7 for score and
align batches, K4 / K5L for Hirschberg and Myers-Miller levels, the
terminal pred sweeps with K3 / K6 for terminal stripes -- and the results
come back in input order on the device of the inputs. The problems are
independent: there is no communication between slices.

A slice's work is enqueued device after device from this one process;
where a route reads a result back on the host (the bucketing of
``align_scores_batch``, a level's split rows), that device finishes before
the next one starts. Over a mesh of several processes each process runs
only its own devices' slices, and every process then gathers every
slice's results (``dist/process.py``: the port's ``fetch``), so that each
holds the whole batch in input order.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from anyseq_tpu_torch.core.types import LinearScoring, Mode, check_scoring
from anyseq_tpu_torch.dist import process
from anyseq_tpu_torch.dist.mesh import Mesh
from anyseq_tpu_torch.engine import batch as _batch


@contextlib.contextmanager
def on(device):
    """Make `device` current while its slice runs (CUDA)."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        yield


def slices(B: int, mesh: Mesh):
    """(device, lo, hi) of each non-empty slice of a batch of B that this
    process runs: the devices in order, ceil(B / devices) problems each;
    another process's devices' slices are left out."""
    devices = mesh.device_list()
    per = max(1, -(-B // len(devices)))
    return [(d, lo, min(lo + per, B))
            for d, o, lo in zip(devices, mesh.owner_list(), range(0, B, per))
            if o == process.index()]


def _join(parts, mesh: Mesh, home, dims=None):
    """The outputs of this process's slices (each a dict of tensors)
    joined along dim 0 (along ``dims[name]`` where given) on `home`, in
    input order; over several processes, every process's."""
    dims = dims or {}
    out = {k: torch.cat([p[k].to(home) for p in parts], dims.get(k, 0))
           for k in parts[0]} if parts else None
    if not mesh.spans_processes:
        return out
    # process.gather joins along dim 0
    got = process.gather(None if out is None else {
        k: t.movedim(dims.get(k, 0), 0) for k, t in out.items()})
    return {k: t.to(home).movedim(0, dims.get(k, 0)) for k, t in got.items()}


def _map(fn, mesh: Mesh, *arrays, host=(), dims=None):
    """fn on each of this process's slices of `arrays` (split along dim 0
    and moved to the device), then of `host` (split, left where they are:
    lengths that the level sweeps read on the host): the slices' outputs
    joined in input order (:func:`_join`), in a dict by fn's keys where fn
    returns a dict, else by output position (0, 1, ...); ``dims`` maps a
    key to the dimension its batch lies along, where not 0."""
    out = []
    for dev, lo, hi in slices(arrays[0].shape[0], mesh):
        with on(dev):
            out.append(fn(*(a[lo:hi].to(dev) for a in arrays),
                          *(h[lo:hi] for h in host)))
    as_dict = [p if isinstance(p, dict) else dict(enumerate(
        (p,) if isinstance(p, torch.Tensor) else p)) for p in out]
    return _join(as_dict, mesh, arrays[0].device, dims)


def last_cols_batch_sharded(q, s, ms, ns, sc: LinearScoring, mesh: Mesh):
    """``kernels.lastcols.last_cols`` (K4) over the mesh: (B, M) int32 last
    columns of B GLOBAL problems, on the inputs' device."""
    from anyseq_tpu_torch.kernels import lastcols

    return _map(lambda *a: lastcols.last_cols(*a, sc), mesh, q, s,
                host=(ms, ns))[0]


def last_cols_batch_affine_sharded(q, s, ms, ns, sc, sgaps, mesh: Mesh):
    """``kernels.lastcols.last_cols_affine`` (K5L) over the mesh: the (B, M)
    H and E last columns of the Myers-Miller levels."""
    from anyseq_tpu_torch.kernels import lastcols

    return tuple(_map(lambda q_, s_, g_, m_, n_: lastcols.last_cols_affine(
        q_, s_, m_, n_, sc, g_), mesh, q, s, sgaps, host=(ms, ns)).values())


def preds_batch_sharded(q, s, ms, ns, sc: LinearScoring, mesh: Mesh):
    """``engine.batch.preds_batch`` over the mesh: ((B, M, ceil(N/16))
    packed codes, (M, B) last columns)."""
    return tuple(_map(lambda *a: _batch.preds_batch(*a, sc), mesh, q, s, ms,
                      ns, dims={1: 1}).values())


def preds_batch_affine_sharded(q, s, ms, ns, sc, sgaps, mesh: Mesh):
    """``engine.batch.preds_batch_affine`` over the mesh (terminal
    Myers-Miller stripes): ((B, M, ceil(N/8)) codes, (M, B) H and E last
    columns)."""
    return tuple(_map(lambda q_, s_, m_, n_, g_: _batch.preds_batch_affine(
        q_, s_, m_, n_, sc, g_), mesh, q, s, ms, ns, sgaps,
        dims={1: 1, 2: 1}).values())


def preds_walk_batch_sharded(q, s, ms, ns, sc: LinearScoring, mesh: Mesh):
    """``engine.batch.preds_walk_batch`` over the mesh (the terminal
    stripes of Hirschberg: pred sweep, then K3): (out_q, out_s, scores)."""
    return tuple(_map(lambda *a: _batch.preds_walk_batch(*a, sc), mesh, q, s,
                      ms, ns).values())


def preds_walk_batch_affine_sharded(q, s, ms, ns, sc, sgaps, egaps,
                                    mesh: Mesh):
    """``engine.batch.preds_walk_batch_affine`` over the mesh (terminal
    Myers-Miller stripes: pred sweep, then K6)."""
    return tuple(_map(
        lambda q_, s_, m_, n_, g_, e_: _batch.preds_walk_batch_affine(
            q_, s_, m_, n_, sc, g_, e_), mesh, q, s, ms, ns, sgaps,
        egaps).values())


def preds_batch_full_sharded(q, s, ms, ns, mode: Mode, sc: LinearScoring,
                             mesh: Mesh):
    """K7 with codes (``kernels.swarm.score_pairs_swarm``) over the mesh:
    the dict of ``engine.batch.swarm_batch`` with ``preds``, for any
    mode."""
    from anyseq_tpu_torch.kernels import swarm

    mode = Mode.parse(mode)
    return _map(lambda *a: swarm.score_pairs_swarm(*a, mode, sc,
                                                   emit_preds=True),
                mesh, q, s, ms, ns)


def _pair_slices(queries, subjects, mesh: Mesh):
    if len(queries) != len(subjects):
        raise ValueError("queries and subjects must have equal length")
    return slices(len(queries), mesh)


def align_scores_batch_sharded(queries, subjects, mode="global",
                               scoring=LinearScoring(), mesh: Mesh | None = None,
                               batch_size: int = 4096,
                               device="cuda") -> np.ndarray:
    """``engine.batch.align_scores_batch`` with the pairs split over the
    mesh's devices in order, each slice scored by K7 on its device;
    np.int64 scores in input order (on every process of a mesh over
    several). Without a mesh, the single-device call on `device`.
    ``batch_size`` is accepted for the JAX package's signature."""
    del batch_size
    check_scoring(scoring)
    if mesh is None:
        return _batch.align_scores_batch(queries, subjects, mode, scoring,
                                         device=device)
    parts = []
    for dev, lo, hi in _pair_slices(queries, subjects, mesh):
        with on(dev):
            parts.append(_batch.align_scores_batch(
                queries[lo:hi], subjects[lo:hi], mode, scoring, device=dev))
    out = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    if mesh.spans_processes:
        out = process.gather({"scores": torch.from_numpy(out)})["scores"]
    return np.asarray(out)


def align_batch_sharded(queries, subjects, mode, scoring, mesh: Mesh):
    """Linear-gap ``engine.batch.align_batch`` with the pairs split over
    the mesh's devices in order (K7 with codes, then K3, on each); the
    list of every pair's Alignment on every process of a mesh over
    several."""
    out = []
    for dev, lo, hi in _pair_slices(queries, subjects, mesh):
        with on(dev):
            out += _batch.align_batch(queries[lo:hi], subjects[lo:hi], mode,
                                      scoring, device=dev)
    return process.gather_objects(out) if mesh.spans_processes else out
