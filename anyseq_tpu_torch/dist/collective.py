"""The collective sweep: one pair scored over several devices, each rank
sweeping one stripe of the subject's columns with K10 and handing its
right boundary column to the next rank as it goes.

The counterpart of the JAX package's ``dist/collective.py``
(``score_pair_collective``, ``_stripe_bands``, ``score_pairs_collective``),
where one persistent Pallas kernel a chip streams each 128-row chunk of its
stripe's right edge to the right-hand chip with remote DMA. Here one
process drives every rank, as ``shard_map`` does there:

* rank k owns the columns [k * Nl, (k + 1) * Nl), Nl = ``ceil(n / K)``
  rounded up to whole 1024-column strips (the TPU's window geometry is not
  ported, ROADMAP item 13); ranks past the one that owns column n - 1 have
  no columns and are not launched;
* rank k's stripe is a chain of bands (one band up to
  ``kernels.band.M_MAX`` query rows, else ``band.M_BAND``-row bands), each
  one K10 launch on the rank's device and its own stream. Its first strip
  reads its left column from a :class:`kernels.band.Halo` on its device,
  which the left rank's last strip writes 32 rows at a time (through peer
  access from another card) and raises one flag a band for; the corner of
  band b > 0 is that halo's row i0 - 1, read on the device. The ranks'
  launches are enqueued band by band in rank order, so no launch waits on
  one enqueued after it, and ranks that share a card split its warps so
  that all of them are resident at once;
* rank 0 starts from the closed-form left column, every rank from the
  closed-form top row of its columns (affine: the NEG F row, and the
  Myers-Miller ``start_gap`` boundary), and each keeps its own bottom (and
  F) row from band to band;
* LOCAL bests are shifted to whole-matrix cells and merged with
  ``mesh.lex_best_merge``: ties go to the smallest i, then j.

On CPU devices every rank runs the plain version of K10 in the same order.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from anyseq_tpu_torch.core.types import (
    AffineScoring,
    Mode,
    as_tensor,
    check_scoring,
)
from anyseq_tpu_torch.dist.mesh import Mesh, lex_best_merge
from anyseq_tpu_torch.engine import affine, linmem
from anyseq_tpu_torch.kernels import _build, band

_STREAMS: dict = {}
_PEERS: set = set()


@dataclass
class Rank:
    """One rank of a sweep: its device, the stream its launches go to (a
    CUDA device), and how many ranks of the sweep share its card."""

    device: torch.device
    stream: object = None
    share: int = 1


def _stream(device: torch.device, slot: int):
    """A CUDA stream of `device` kept for mesh position `slot`."""
    key = (device.index, slot)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


def ranks_of(devices, slots=None, counts=None) -> list[Rank]:
    """The ranks on `devices` (repeats allowed); `slots` names each one's
    stream (default: its index), `counts` how many ranks running at once
    use each device (default: those of `devices`)."""
    devices = [torch.device(d) for d in devices]
    slots = range(len(devices)) if slots is None else slots
    counts = counts or {d: devices.count(d) for d in devices}
    return [Rank(d, _stream(d, slot) if d.type == "cuda" else None, counts[d])
            for d, slot in zip(devices, slots)]


def _enable_peers(devices) -> None:
    """Peer access from each rank's card to the next rank's, whose halo it
    writes; raise where the cards cannot reach each other."""
    for a, b in zip(devices, devices[1:]):
        if a == b or (a.index, b.index) in _PEERS:
            continue
        if not torch.cuda.can_device_access_peer(a, b):
            raise RuntimeError(
                f"{a} cannot access {b}'s memory (no peer access): the "
                "collective sweep needs peer access between neighbouring "
                "ranks' cards")
        _build.check(_build.library().anyseq_enable_peer(a.index, b.index),
                     "enable_peer")
        _PEERS.add((a.index, b.index))


@contextlib.contextmanager
def _on(rank: Rank):
    """The context of a rank's work: its device and stream (CUDA)."""
    if rank.stream is None:
        yield
        return
    with torch.cuda.device(rank.device), torch.cuda.stream(rank.stream):
        yield


def _as_seq(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.uint8).contiguous()
    return as_tensor(x, device)


def geometry(m: int, n: int, K: int, band_rows: int | None = None):
    """(Nl, active ranks, band_rows, bands) of an m x n sweep over K
    ranks."""
    Nl = -(-(-(-n // K)) // band.STRIP) * band.STRIP
    if band_rows is None:
        band_rows = m if m <= band.M_MAX else band.M_BAND
    band_rows = max(1, min(band_rows, m))
    return Nl, -(-n // Nl), band_rows, -(-m // band_rows)


def _top(mode: Mode, sc, j: int, start_gap: bool) -> int:
    """The closed-form top row H[-1][j]."""
    if mode is not Mode.GLOBAL:
        return 0
    if isinstance(sc, AffineScoring):
        return (0 if start_gap else sc.gap_open) + (j + 1) * sc.gap_extend
    return (j + 1) * sc.gap


def launch_pair(q, s, mode: Mode, sc, ranks: list[Rank],
                band_rows: int | None = None, start_gap: bool = False):
    """Enqueue the collective sweep of q against s (1-D uint8 tensors on
    one home device) over `ranks`; returns a function that waits for it
    and returns the outputs of ``linmem.score_rows`` on the home device
    (affine: with ``last_col_e`` and ``last_row_f``)."""
    is_affine = isinstance(sc, AffineScoring)
    m, n = int(q.shape[0]), int(s.shape[0])
    Nl, Ka, band_rows, bands = geometry(m, n, len(ranks), band_rows)
    ranks = ranks[:Ka]
    home = q.device
    cuda = home.type == "cuda"
    if is_affine:
        row0, rowf0 = affine.top_row_affine(mode, sc, n, start_gap, home)
    else:
        row0, rowf0 = linmem.top_row(mode, sc, n, home), None
    if cuda:
        _enable_peers([r.device for r in ranks])
        for r in ranks:
            r.stream.wait_stream(torch.cuda.current_stream(home))
            r.stream.wait_stream(torch.cuda.current_stream(r.device))
    st = []
    for k, r in enumerate(ranks):
        j0 = k * Nl
        cols = slice(j0, min(j0 + Nl, n))
        if cuda:
            # the rank's stream reads these home tensors
            for t in (q, s, row0, rowf0):
                if t is not None:
                    t.record_stream(r.stream)
        with _on(r):
            halo = (band.Halo(m, bands, is_affine, r.device,
                              ranks[k - 1].device) if k else None)
            st.append({"j0": j0, "q": q.to(r.device),
                       "s": s[cols].to(r.device).contiguous(),
                       "row": row0[cols].to(r.device).contiguous(),
                       "rowf": (rowf0[cols].to(r.device).contiguous()
                                if is_affine else None),
                       "halo": halo, "cols": [], "cols_e": [], "bests": []})
        if cuda and k:
            for t in halo.tensors():
                t.record_stream(ranks[k - 1].stream)
    for b in range(bands):
        i0 = b * band_rows
        h = min(band_rows, m - i0)
        for k, r in enumerate(ranks):
            x = st[k]
            halo_out = st[k + 1]["halo"] if k + 1 < Ka else None
            with _on(r):
                corner = col = cole = None
                if k == 0 and is_affine:
                    corner, col, cole = affine.left_col_affine(
                        mode, sc, i0, h, start_gap, r.device)
                elif k == 0:
                    corner, col = linmem.left_col(mode, sc, i0, h, r.device)
                elif b == 0:
                    corner = _top(mode, sc, x["j0"] - 1, start_gap)
                outs = band.score_band_collective(
                    x["q"][i0:i0 + h], x["s"], x["row"], corner, col, mode,
                    sc, x["halo"], halo_out, b, i0, rowf_in=x["rowf"],
                    cole_in=cole, share=r.share)
            x["row"] = outs["last_row"]
            if is_affine:
                x["rowf"] = outs["last_row_f"]
            if k == Ka - 1:
                x["cols"].append(outs["last_col"])
                if is_affine:
                    x["cols_e"].append(outs["last_col_e"])
            x["bests"].append((outs["best"], i0))

    def finish():
        if cuda:
            for r in ranks:
                for cur in (torch.cuda.current_stream(r.device),
                            torch.cuda.current_stream(home)):
                    cur.wait_stream(r.stream)
        bests = []
        for x in st:
            for best, i0 in x["bests"]:
                shift = torch.tensor([0, i0, x["j0"]], dtype=torch.int32,
                                     device=best.device)
                bests.append((best + shift).to(home))
        owner = st[-1]
        res = {"last_row": torch.cat([x["row"].to(home) for x in st]),
               "last_col": torch.cat(owner["cols"]).to(home),
               "best": lex_best_merge(torch.stack(bests))}
        if is_affine:
            res["last_col_e"] = torch.cat(owner["cols_e"]).to(home)
            res["last_row_f"] = torch.cat([x["rowf"].to(home) for x in st])
        if cuda:
            # the current streams (a copy across cards runs on the
            # source's) read the ranks' last tensors: keep their memory
            # from the ranks' streams until they have
            for x in st:
                for t in [x["row"], x["rowf"], *x["cols"], *x["cols_e"],
                          *(b for b, _ in x["bests"])]:
                    if t is not None:
                        t.record_stream(torch.cuda.current_stream(t.device))
        return res

    return finish


def _check(mode, sc, start_gap):
    mode = Mode.parse(mode)
    sc = check_scoring(sc)
    if start_gap and not (isinstance(sc, AffineScoring)
                          and mode is Mode.GLOBAL):
        raise ValueError("start_gap is an affine GLOBAL (Myers-Miller) "
                         "option")
    return mode, sc


def score_pair_collective(query, subject, mode, sc, mesh: Mesh,
                          axis: str = "sp", band_rows: int | None = None,
                          start_gap: bool = False):
    """Score one pair over the devices of a 1-D mesh (see the module
    docstring). Returns the outputs of ``linmem.score_rows`` (affine: with
    ``last_col_e`` and ``last_row_f``) on the mesh's first device, equal to
    one single-device sweep bit for bit. ``band_rows`` forces the band
    height (tests); ``start_gap`` is the affine GLOBAL Myers-Miller
    boundary."""
    mode, sc = _check(mode, sc, start_gap)
    if mesh.axis_names != (axis,):
        raise ValueError(f"the collective sweep needs a 1-D mesh over axis "
                         f"{axis!r}; dist.sharded.score_pair_sharded "
                         "flattens other meshes")
    devices = mesh.device_list()
    q, s = _as_seq(query, devices[0]), _as_seq(subject, devices[0])
    if q.shape[0] == 0 or s.shape[0] == 0:
        raise ValueError("empty sequences are not supported")
    return launch_pair(q, s, mode, sc, ranks_of(devices), band_rows,
                       start_gap)()


def score_pairs_collective(queries, subjects, mode, sc, mesh: Mesh,
                           axis_sp: str = "sp", axis_dp: str = "dp",
                           band_rows: int | None = None):
    """A batch of pairs on a 2-D (dp x sp) mesh: the pairs are split over
    the dp rows in order, each row of the mesh is its own sp ring, and
    every pair runs the collective sweep over its row (all rows at once).
    Returns a list of (score, (i, j)) in input order, as the JAX package's
    ``score_pairs_collective``."""
    mode, sc = _check(mode, sc, False)
    if set(mesh.axis_names) != {axis_sp, axis_dp}:
        raise ValueError(f"needs a 2-D mesh over ({axis_dp!r}, {axis_sp!r})")
    if len(queries) != len(subjects) or not len(queries):
        raise ValueError("need equal, non-zero numbers of sequences")
    grid = mesh.devices
    if mesh.axis_names.index(axis_dp) != 0:
        grid = grid.T
    DP, K = grid.shape
    flat = list(grid.flat)
    counts = {d: flat.count(d) for d in flat}
    rings = [ranks_of(grid[r], range(r * K, (r + 1) * K), counts)
             for r in range(DP)]
    home = flat[0]
    pairs = [(_as_seq(a, home), _as_seq(b, home))
             for a, b in zip(queries, subjects)]
    if any(a.shape[0] == 0 or b.shape[0] == 0 for a, b in pairs):
        raise ValueError("empty sequences are not supported")
    per_row = -(-len(pairs) // DP)
    pending = [launch_pair(a, b, mode, sc, rings[i // per_row], band_rows)
               for i, (a, b) in enumerate(pairs)]
    return [linmem.extract_score_from_outputs(
        done(), int(a.shape[0]), int(b.shape[0]), mode)
        for done, (a, b) in zip(pending, pairs)]
