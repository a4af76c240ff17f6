"""Linear-memory construction on one device: Hirschberg for linear gaps,
Myers-Miller for affine (Gotoh) gaps.

The port of the JAX package's ``engine/hirschberg.py`` (``_hb_global``,
``_hb_global_affine``, ``_HbCheckpoint`` and ``align_hirschberg``, with
its mesh branches), with the same splits and therefore the same strings:

* every divide level runs all its parts at once: a part's left half
  forward and its right half reversed give the two boundary columns, and
  the level's merge picks the split row (ties to the smallest k):
  ``kernels.lastcols.hb_merge`` (hb_sum) for linear gaps,
  ``kernels.lastcols.mm_merge`` for affine gaps, which also reads the E
  columns and says whether a gap run crosses the cut. Parts carry
  (qlo, qhi, slo, shi, sgap, egap): whether the part's path enters
  through its top row, or leaves through its bottom row, inside a
  horizontal gap run whose gap_open is paid outside it (always False for
  linear gaps);
* levels of one or two parts run each half as one wide single-pair sweep
  (K1, transposed so that the half's last column is the sweep's last row,
  since linear GLOBAL DP is transpose-symmetric; K5 in the half's own
  orientation, since transposing Gotoh swaps E and F and ``start_gap``
  names a horizontal run), and so does every level whose tallest half
  has more than ``band.M_MAX`` rows (the JAX package's genome-scale
  condition): a sweep taller than that runs as a chain of bands (K8 /
  K8 affine), whose memory does not grow with the height; other levels
  run every half in one batched sweep (K4 / K5L). Only the (P,) split
  rows, crossing flags and scores come back to the host;
* parts of width <= ``MIN_WIDTH`` (or of height <= 1) are terminal
  stripes: a batched pred sweep in torch, then the batched walk (K3 / K6),
  whose walked positions are copied into the output buffers on the
  device;
* semiglobal and local alignments first find the end cell (forward sweep)
  and the start cell (reverse sweep on the reversed end prefix), then run
  the global construction on that rectangle;
* with ``mesh`` (a ``dist.mesh.Mesh``), a level of at most 4 parts whose
  narrowest half is at least ``sp_min_width`` columns wide (default 2,048
  a device) runs each half over the whole mesh (``dist.sharded``, the
  collective sweep K10, oriented as above); the other levels and the
  terminal stripes run data-parallel over the mesh's devices
  (``dist.batch``: K4 / K5L, pred sweeps + K3 / K6), and the endpoint
  passes run over the mesh. Every split, and so every string, is the
  single-device one;
* over a mesh of several processes (``dist.mesh.init_distributed``)
  every process runs this same construction: the collective sweeps and the
  data-parallel slices return the same results on every process, so each
  takes the same splits and builds the same strings;
* with ``checkpoint_path``, each completed level and terminal chunk
  rewrites one npz (the parts still to divide, the terminal stripes, the
  output buffers copied to the host, the root score), and the endpoint
  stages of semiglobal and local alignments another; a killed run called
  again with the same arguments resumes and gives the same bytes. Over
  several processes process 0 writes it and every process reads it;
* with ``ANYSEQ_TIMING=1`` in the environment, each level, the terminal
  stripes and the endpoint passes log their wall time (stderr, and
  :data:`TIMING_LOG`), in the JAX package's words.

``MIN_WIDTH`` is 256 on every device: the stripe boundaries decide tie
cells in the strings, and the JAX package uses 256 off the TPU.
"""
from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np
import torch

from anyseq_tpu_torch.core.types import (
    EMPTY_SYM,
    GAP_SYM,
    AffineScoring,
    Alignment,
    LinearScoring,
    Mode,
    as_tensor,
    check_scoring,
)
from anyseq_tpu_torch.dist import batch as dist_batch
from anyseq_tpu_torch.dist import process, sharded
from anyseq_tpu_torch.dist.mesh import check_mesh
from anyseq_tpu_torch.engine import batch, linmem
from anyseq_tpu_torch.engine.resumable import atomic_savez
from anyseq_tpu_torch.kernels import band, lastcols, wavefront

MIN_WIDTH = 256
TERMINAL_BATCH = 512
_RS_NONE = -(2**62)    # no root score yet, in a checkpoint
_STAGE_KEYS = ("stage", "score", "ei", "ej", "rscore", "ri", "rj")

# ANYSEQ_TIMING=1: the construction's phases, with their wall times, as
# the JAX package logs them (stderr and this list)
TIMING_LOG: list[str] = []


def _tlog(msg: str) -> None:
    if os.environ.get("ANYSEQ_TIMING") == "1":
        TIMING_LOG.append(msg)
        print(f"[hb] {msg}", file=sys.stderr, flush=True)


def _ms(t0: float) -> str:
    return f"{(time.perf_counter() - t0) * 1e3:.0f}ms"


class _HbCheckpoint:
    """Durable state of a construction: one npz, rewritten atomically
    after each completed unit of work and tagged with the problem's key;
    a checkpoint of another problem is refused. ``shared``: the
    construction runs on every process of a mesh over several; process 0
    writes, every process reads, and none goes on before every process
    has read it or process 0 has written it."""

    def __init__(self, path, key: str, shared: bool = False):
        self.path = path
        self.key = key
        self.shared = shared

    def load(self):
        ck = None
        if self.path and os.path.exists(self.path):
            ck = np.load(self.path, allow_pickle=False)
            if str(ck["key"]) != self.key:
                raise ValueError("checkpoint does not match this problem")
        if self.shared:
            process.barrier()
        return ck

    def save(self, **arrays):
        if self.path and not (self.shared and process.index()):
            atomic_savez(self.path, key=self.key, **arrays)
        if self.path and self.shared:
            process.barrier()


def _ckpt_key(q, s, mode: Mode, sc) -> str:
    """The problem a checkpoint belongs to: both sequences, the mode, the
    scoring and the stripe width."""
    h = hashlib.sha256()
    h.update(q.cpu().numpy().tobytes())
    h.update(s.cpu().numpy().tobytes())
    h.update(repr((mode.value, sc, MIN_WIDTH)).encode())
    return h.hexdigest()


def _parts_array(parts) -> np.ndarray:
    return np.asarray(parts, np.int64).reshape(-1, 6)


def _parts_list(arr) -> list[tuple]:
    return [(*map(int, r[:4]), bool(r[4]), bool(r[5])) for r in arr]


def _bucket(x: int, mult: int = 256) -> int:
    return max(mult, (x + mult - 1) // mult * mult)


def _gather(seq, lo, length, rev, width: int):
    """(B, width) uint8: row b is seq[lo_b : lo_b + length_b], reversed
    where rev_b. Positions past length_b hold some symbol of seq; the
    sweeps never read them into a result."""
    x = torch.arange(width, device=seq.device)[None, :]
    lo, length = lo[:, None], length[:, None]
    idx = torch.where(rev[:, None], lo + length - 1 - x, lo + x)
    return seq[idx.clamp(0, seq.shape[0] - 1)]


def _stack(cols):
    """(P, max length) int32 of 1-D columns, zero-padded."""
    width = max(c.shape[0] for c in cols)
    return torch.stack([torch.nn.functional.pad(c, (0, width - c.shape[0]))
                        for c in cols])


def _sweep(q, s, mode, sc, mesh=None, **kwargs):
    """One score sweep: K1 / K5 (or a chain of K8 bands) on q's device, or
    the collective sweep over `mesh`."""
    if mesh is None:
        return wavefront.score(q, s, mode, sc, **kwargs)
    kwargs.pop("emit_col_e", None)     # the collective sweep always has it
    return sharded.score_pair_sharded(q, s, mode, sc, mesh, **kwargs)


def _level_per_half(q, s, parts, sc, mesh=None):
    """Boundary columns of a level of few, wide parts, one sweep per half
    (over `mesh` where given): [L, R] for linear gaps, [HL, EL, HR, ER] for
    affine."""
    affine = isinstance(sc, AffineScoring)
    cols = []
    for qlo, qhi, slo, shi, sg, eg in parts:
        mid = (shi - slo) // 2
        for qa, sa, flag in ((q[qlo:qhi], s[slo:slo + mid], sg),
                             (q[qlo:qhi].flip(0), s[slo + mid:shi].flip(0),
                              eg)):
            if affine:
                outs = _sweep(qa, sa, Mode.GLOBAL, sc, mesh, start_gap=flag,
                              emit_col_e=True)
                cols.append((outs["last_col"], outs["last_col_e"]))
            else:
                outs = _sweep(sa, qa, Mode.GLOBAL, sc, mesh)
                cols.append((outs["last_row"],))
    kinds = [_stack(list(c)) for c in zip(*cols)]
    return [k[0::2] for k in kinds] + [k[1::2] for k in kinds]


def _level_batched(q, s, parts, sc, mesh=None):
    """Boundary columns of a level, every half in one K4 / K5L sweep (one
    a device of `mesh` where given): [L, R] for linear gaps, [HL, EL, HR,
    ER] for affine."""
    dev = q.device
    qlo, slo, hs, ws, rev, sgaps = [], [], [], [], [], []
    for a, b, c, d, sg, eg in parts:
        mid = (d - c) // 2
        qlo += [a, a]
        hs += [b - a, b - a]
        slo += [c, c + mid]
        ws += [mid, d - c - mid]
        rev += [False, True]
        sgaps += [sg, eg]   # the reversed half starts where the part ends

    def t(v, dtype=torch.int64):
        return torch.tensor(v, dtype=dtype, device=dev)

    rev_t = t(rev, torch.bool)
    q3 = _gather(q, t(qlo), t(hs), rev_t, max(hs))
    s3 = _gather(s, t(slo), t(ws), rev_t, max(ws))
    # the lengths stay on the host, where K4 / K5L build their strip lists
    hs, ws = (torch.tensor(v, dtype=torch.int32) for v in (hs, ws))
    if isinstance(sc, AffineScoring):
        args = (q3, s3, hs, ws, sc, t(sgaps, torch.bool))
        kinds = (lastcols.last_cols_affine(*args) if mesh is None else
                 dist_batch.last_cols_batch_affine_sharded(*args, mesh))
    elif mesh is None:
        kinds = (lastcols.last_cols(q3, s3, hs, ws, sc),)
    else:
        kinds = (dist_batch.last_cols_batch_sharded(q3, s3, hs, ws, sc,
                                                    mesh),)
    return [k[0::2] for k in kinds] + [k[1::2] for k in kinds]


def _per_half(parts, mesh, sp_min_width: int) -> bool:
    """Whether a level runs one sweep per half (else all in one batch)."""
    if mesh is None:
        return (len(parts) <= 2
                or max(p[1] - p[0] for p in parts) > band.M_MAX)
    return (len(parts) <= 4 and min((p[3] - p[2]) // 2 for p in parts)
            >= sp_min_width)


def _level_msg(parts, sc, mesh, sp_min_width: int) -> str:
    """A level's line of the phase log, but its time."""
    affine = isinstance(sc, AffineScoring)
    if _per_half(parts, mesh, sp_min_width):
        path = "per-half" if mesh is None else "mesh-sp"
    elif affine:
        path = "batched-kernel" if mesh is None else "mesh-batch"
    else:
        path = "batched"
    return (f"{'aff ' if affine else ''}level P={len(parts)} "
            f"maxh={max(p[1] - p[0] for p in parts)} "
            f"maxmid={max((p[3] - p[2]) // 2 for p in parts)} path={path}")


def _split(q, s, parts, sc, mesh=None, sp_min_width: int = 0):
    """Split rows of a level: (k, crosses_in_gap, score) per part."""
    per_half = _per_half(parts, mesh, sp_min_width)
    level = _level_per_half if per_half else _level_batched
    cols = level(q, s, parts, sc, mesh)
    dev = cols[0].device

    def t(i, dtype=torch.int64):
        return torch.tensor([p[i] for p in parts], dtype=dtype, device=dev)

    hs = t(1) - t(0)
    mids = (t(3) - t(2)) // 2
    rights = t(3) - t(2) - mids
    if isinstance(sc, AffineScoring):
        return lastcols.mm_merge(*cols, hs, mids, rights, sc,
                                 t(4, torch.bool), t(5, torch.bool))
    ks, scores = lastcols.hb_merge(*cols, hs, mids, rights, sc.gap)
    return ks, torch.zeros_like(ks, dtype=torch.bool), scores


def _write_all_gap_subject(s, base: int, out_q, out_s) -> None:
    """Subject symbols against query gaps (a part of height 0)."""
    out_q[base: base + s.shape[0]] = GAP_SYM
    out_s[base: base + s.shape[0]] = s


def _terminal_chunks(terminals) -> list[list[tuple]]:
    """The terminal stripes in walk order: grouped by padded shape, in
    chunks of at most TERMINAL_BATCH (a chunk is a checkpoint unit)."""
    groups: dict[tuple[int, int], list] = {}
    for part in terminals:
        h, w = part[1] - part[0], part[3] - part[2]
        groups.setdefault((_bucket(h), _bucket(w, 128)), []).append(part)
    return [parts[lo: lo + TERMINAL_BATCH] for parts in groups.values()
            for lo in range(0, len(parts), TERMINAL_BATCH)]


def _walk_chunk(q, s, chunk, off, out_q, out_s, sc, mesh=None) -> torch.Tensor:
    """Walk one chunk of terminal stripes (of one padded shape) into
    out_q / out_s, whose last slot takes the writes of unwalked
    positions, split over the devices of `mesh` where given; returns their
    scores."""
    dev = q.device
    dump = out_q.shape[0] - 1

    def t(i, dtype=torch.int64):
        return torch.tensor([p[i] for p in chunk], dtype=dtype, device=dev)

    Hb = _bucket(max(p[1] - p[0] for p in chunk))
    Wb = _bucket(max(p[3] - p[2] for p in chunk), 128)
    qlo, slo = t(0), t(2)
    hs, ws = t(1) - qlo, t(3) - slo
    fwd = torch.zeros(len(chunk), dtype=torch.bool, device=dev)
    q3 = _gather(q, qlo, hs, fwd, Hb)
    s3 = _gather(s, slo, ws, fwd, Wb)
    if isinstance(sc, AffineScoring):
        args = (q3, s3, hs, ws, sc, t(4, torch.bool), t(5, torch.bool))
        oq, os_, scores = (
            batch.preds_walk_batch_affine(*args) if mesh is None else
            dist_batch.preds_walk_batch_affine_sharded(*args, mesh))
    elif mesh is None:
        oq, os_, scores = batch.preds_walk_batch(q3, s3, hs, ws, sc)
    else:
        oq, os_, scores = dist_batch.preds_walk_batch_sharded(q3, s3, hs, ws,
                                                              sc, mesh)
    # copy only the walked positions: a stripe's unwalked slots belong to
    # no one, but the buffer is shared
    pos = (off + qlo + slo)[:, None] + torch.arange(Hb + Wb, device=dev)
    walked = (oq != EMPTY_SYM) | (os_ != EMPTY_SYM)
    pos = torch.where(walked, pos, dump).reshape(-1)
    out_q.index_put_((pos,), oq.reshape(-1))
    out_s.index_put_((pos,), os_.reshape(-1))
    return scores


def _hb_global(q, s, off: int, out_q, out_s, sc, ckpt=None, mesh=None,
               sp_min_width: int = 0) -> int:
    """Level-synchronous global construction of q against s (both
    non-empty), whose cell (i, j) lands at position off + i + j + 1 of
    out_q / out_s. Returns the global score. With `ckpt`
    (:class:`_HbCheckpoint`) it starts from the saved state, if any, and
    saves after every level and every terminal chunk; with `mesh`, over
    its devices (see the module docstring)."""
    m, n = q.shape[0], s.shape[0]
    root = (0, m, 0, n, False, False)
    root_score = None
    active: list[tuple] = []
    terminals: list[tuple] = []
    term_done = 0

    def classify(part):
        qlo, qhi, slo, shi = part[:4]
        h, w = qhi - qlo, shi - slo
        if h == 0:
            _write_all_gap_subject(s[slo:shi], off + qlo + slo, out_q, out_s)
        elif w <= MIN_WIDTH or w < 2 or h <= 1:
            terminals.append(part)
        else:
            active.append(part)

    classify(root)
    ck = ckpt.load() if ckpt is not None else None
    if ck is not None:
        active = _parts_list(ck["active"])
        terminals = _parts_list(ck["terminals"])
        out_q.copy_(torch.from_numpy(ck["out_q"]))
        out_s.copy_(torch.from_numpy(ck["out_s"]))
        rs = int(ck["root_score"])
        root_score = None if rs == _RS_NONE else rs
        term_done = int(ck["term_done"])

    def save():
        if ckpt is not None:
            ckpt.save(active=_parts_array(active),
                      terminals=_parts_array(terminals),
                      out_q=out_q.cpu().numpy(), out_s=out_s.cpu().numpy(),
                      root_score=np.int64(_RS_NONE if root_score is None
                                          else root_score),
                      term_done=np.int64(term_done))

    while active:
        parts, active = active, []
        t0 = time.perf_counter()
        ks, cross, scores = _split(q, s, parts, sc, mesh, sp_min_width)
        rows = torch.stack([ks, cross.to(ks.dtype), scores]).T.tolist()
        for (qlo, qhi, slo, shi, sg, eg), (k, c, score) in zip(parts, rows):
            if root_score is None:
                root_score = score
            mid = (shi - slo) // 2
            c = bool(c)
            classify((qlo, qlo + k + 1, slo, slo + mid, sg, c))
            classify((qlo + k + 1, qhi, slo + mid, shi, c, eg))
        _tlog(f"{_level_msg(parts, sc, mesh, sp_min_width)} {_ms(t0)}")
        save()
    t0 = time.perf_counter()
    for ci, chunk in enumerate(_terminal_chunks(terminals)):
        if ci < term_done:
            continue
        scores = _walk_chunk(q, s, chunk, off, out_q, out_s, sc, mesh)
        if root in chunk:
            root_score = int(scores[chunk.index(root)])
        term_done = ci + 1
        save()
    _tlog(f"{'aff ' if isinstance(sc, AffineScoring) else ''}terminals "
          f"n={len(terminals)} {_ms(t0)}")
    return root_score


def _reverse_end(outs, mr: int, nr: int, sc) -> torch.Tensor:
    """Start of a semiglobal alignment from the GLOBAL sweep of the
    reversed end prefix: the best cell of its last row or column, or one
    of the all-gap boundary cells (interior candidates win ties)."""
    lrow, lcol = outs["last_row"], outs["last_col"]
    rj = torch.argmax(lrow)
    score, ri = lrow[rj].to(torch.int64), rj.new_full((), mr - 1)
    ci = torch.argmax(lcol)
    take = lcol[ci] > score
    score = torch.where(take, lcol[ci].to(torch.int64), score)
    ri = torch.where(take, ci, ri)
    rj = torch.where(take, nr - 1, rj)

    def all_gap(length):
        if isinstance(sc, AffineScoring):
            return sc.gap_open + sc.gap_extend * length
        return sc.gap * length

    for cand, i, j in ((all_gap(mr), mr - 1, -1), (all_gap(nr), -1, nr - 1)):
        take = cand > score
        score = torch.where(take, cand, score)
        ri = torch.where(take, i, ri)
        rj = torch.where(take, j, rj)
    return torch.stack([score, ri, rj])


def align_hirschberg(query, subject, mode, scoring=LinearScoring(),
                     device="cuda", mesh=None, checkpoint_path=None,
                     sp_min_width: int | None = None) -> Alignment:
    """Linear-memory alignment construction on `device`, or over the
    devices of `mesh` (a ``dist.mesh.Mesh``; this process's first device
    of it then holds the sequences and outputs, and `device` is not read),
    bit-identical to the single-device construction; over a mesh of
    several processes every process makes the call and gets the result.
    ``sp_min_width``: the narrowest half that a level of at most 4 parts
    runs over the whole mesh (default 2,048 columns a device of the
    mesh).

    ``checkpoint_path``: a durable npz state, updated after every
    completed unit of work; a killed run called again with the same
    arguments resumes and gives byte-identical results, and a checkpoint
    of other inputs is refused. GLOBAL saves its levels and terminal
    chunks there; semiglobal and local save their endpoint stages there
    (1: the forward end found, 2: the reverse start found) and the
    construction of their rectangle under ``checkpoint_path + ".rect"``.
    The output buffers live on `device`; a save copies them to the host.
    A checkpoint of a run over a mesh resumes with or without one; over
    a mesh of several processes, process 0 writes it and every process
    reads it.
    """
    mode = Mode.parse(mode)
    sc = check_scoring(scoring)
    shared = mesh is not None and check_mesh(mesh).spans_processes
    if mesh is not None:
        device = mesh.home
        if sp_min_width is None:
            sp_min_width = 2048 * mesh.size
    q = as_tensor(query, device)
    s = as_tensor(subject, device)
    m, n = q.shape[0], s.shape[0]
    if m == 0 or n == 0:
        raise ValueError("empty sequences are not supported")
    # one extra slot takes the writes of unwalked stripe positions
    out_q = torch.full((m + n + 1,), EMPTY_SYM, dtype=torch.uint8,
                       device=q.device)
    out_s = out_q.clone()

    def result(score, start):
        return Alignment(score, bytes(out_q[:-1].cpu().numpy()),
                         bytes(out_s[:-1].cpu().numpy()), start)

    def rect(qr, sr, off):
        ckpt = None
        if checkpoint_path is not None:
            path = (checkpoint_path if mode is Mode.GLOBAL
                    else checkpoint_path + ".rect")
            ckpt = _HbCheckpoint(path, _ckpt_key(qr, sr, Mode.GLOBAL, sc),
                                 shared)
        return _hb_global(qr, sr, off, out_q, out_s, sc, ckpt, mesh,
                          sp_min_width)

    if mode is Mode.GLOBAL:
        return result(rect(q, s, 0), (0, 0))

    # the endpoint stages: 1 = forward end found, 2 = reverse start found
    outer, stage = None, 0
    if checkpoint_path is not None:
        outer = _HbCheckpoint(checkpoint_path, _ckpt_key(q, s, mode, sc),
                              shared)
        ck = outer.load()
        if ck is not None:
            stage, score, ei, ej, rscore, ri, rj = (int(ck[k])
                                                    for k in _STAGE_KEYS)

    def save_stage(*values):
        if outer is not None:
            outer.save(**{k: np.int64(v) for k, v in zip(_STAGE_KEYS, values)})

    if stage < 1:
        t0 = time.perf_counter()
        outs = _sweep(q, s, mode, sc, mesh)
        score, ei, ej = linmem.extract_end(outs, m, n, mode).tolist()
        _tlog(f"fwd pass {_ms(t0)}")
        save_stage(1, score, ei, ej, 0, 0, 0)
    if ei < 0 or ej < 0 or (mode is Mode.LOCAL and score <= 0):
        # empty alignment: a boundary maximum, or no positive local cell
        return result(score, (ei + 1, ej + 1))

    if stage < 2:
        t0 = time.perf_counter()
        qr = q[: ei + 1].flip(0)
        sr = s[: ej + 1].flip(0)
        if mode is Mode.LOCAL:
            rscore, ri, rj = _sweep(qr, sr, mode, sc, mesh)["best"].tolist()
        else:
            # GLOBAL inits pin the reverse start to the forward end cell
            outs = _sweep(qr, sr, Mode.GLOBAL, sc, mesh)
            rscore, ri, rj = _reverse_end(outs, ei + 1, ej + 1, sc).tolist()
        _tlog(f"rev pass {_ms(t0)}")
        save_stage(2, score, ei, ej, rscore, ri, rj)
    si, sj = ei - ri, ej - rj
    if si > ei or sj > ej:
        return result(score, (si, sj))
    sub_score = rect(q[si: ei + 1], s[sj: ej + 1], si + sj)
    if not sub_score == score == rscore:
        raise RuntimeError(
            f"hirschberg endpoint reduction mismatch: fwd={score} "
            f"rev={rscore} rect={sub_score} (mode={mode}, m={m}, n={n}, "
            f"end=({ei},{ej}), start=({si},{sj}))")
    return result(score, (si, sj))
