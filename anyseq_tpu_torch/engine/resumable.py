"""Checkpointable band-wise scoring for genome-length runs that must
survive a kill.

The port of the JAX package's ``engine/resumable.py``: the DP advances one
band of rows at a time (``kernels.band.score_band``: K8 on the card, its
plain version on the CPU), and after each band the bottom row, the last
column so far, the running local best and the band index go to one npz,
rewritten atomically. A killed run resumes from the last band and gives
the same int32 outputs. The row stays on the device between bands; a
save copies it to the host. Linear gaps only, as in the JAX package.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from anyseq_tpu_torch.core.types import (
    SCORE_MIN,
    LinearScoring,
    Mode,
    as_tensor,
)
from anyseq_tpu_torch.engine import linmem
from anyseq_tpu_torch.kernels import band


def atomic_savez(path, **arrays) -> None:
    """Write `arrays` to the npz `path` through a temporary file in the
    same directory and a rename: a kill leaves the old file or the new
    one, never a torn one."""
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", dir=os.path.dirname(os.path.abspath(path)))
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class ResumableScorer:
    """Band-wise score-only alignment with durable checkpoints.

    >>> sc = ResumableScorer(q, s, "global", checkpoint_path="run.npz")
    >>> while sc.step():
    ...     pass           # safe to kill anywhere; resume() picks up
    >>> outs = sc.outputs()
    """

    def __init__(self, query, subject, mode="global",
                 scoring=LinearScoring(), band_rows: int = 4096,
                 checkpoint_path: str | None = None, device="cuda"):
        if not isinstance(scoring, LinearScoring):
            raise TypeError("ResumableScorer takes LinearScoring")
        self.q = as_tensor(query, device)
        self.s = as_tensor(subject, device)
        self.m = int(self.q.shape[0])
        self.n = int(self.s.shape[0])
        if self.m == 0 or self.n == 0:
            raise ValueError("empty sequences are not supported")
        self.mode = Mode.parse(mode)
        self.scoring = scoring
        self.H = band_rows
        self.path = checkpoint_path
        dev = self.s.device
        self.row = linmem.top_row(self.mode, scoring, self.n, dev)
        self.last_col = torch.full((self.m,), SCORE_MIN, dtype=torch.int32,
                                   device=dev)
        self.best = torch.tensor([SCORE_MIN, -1, -1], dtype=torch.int32,
                                 device=dev)
        self.band = 0
        self.num_bands = (self.m + self.H - 1) // self.H

    # -- persistence ---------------------------------------------------
    def save(self):
        if self.path:
            atomic_savez(self.path, band=self.band,
                         row=self.row.cpu().numpy(),
                         last_col=self.last_col.cpu().numpy(),
                         best=self.best.cpu().numpy(), m=self.m, n=self.n,
                         mode=self.mode.value, H=self.H)

    @classmethod
    def resume(cls, path, query, subject, mode="global",
               scoring=LinearScoring(), band_rows: int = 4096,
               device="cuda"):
        self = cls(query, subject, mode, scoring, band_rows, path, device)
        if os.path.exists(path):
            ck = np.load(path)
            if (int(ck["m"]) != self.m or int(ck["n"]) != self.n
                    or str(ck["mode"]) != self.mode.value
                    or int(ck["H"]) != band_rows):
                raise ValueError("checkpoint does not match this problem")
            dev = self.s.device
            self.band = int(ck["band"])
            self.row = torch.from_numpy(ck["row"]).to(dev)
            self.last_col = torch.from_numpy(ck["last_col"]).to(dev)
            self.best = torch.from_numpy(ck["best"]).to(dev)
        return self

    # -- execution -----------------------------------------------------
    def step(self) -> bool:
        """Process one band; returns False when finished."""
        if self.band >= self.num_bands:
            return False
        i0 = self.band * self.H
        h = min(self.H, self.m - i0)
        corner, col = linmem.left_col(self.mode, self.scoring, i0, h,
                                      self.s.device)
        outs = band.score_band(self.q[i0:i0 + h], self.s, self.row, corner,
                               col, self.mode, self.scoring)
        self.row = outs["last_row"]
        self.last_col[i0:i0 + h] = outs["last_col"]
        if self.mode is Mode.LOCAL:
            # the band's best is band-local; an equal later one loses
            cand = outs["best"] + torch.tensor([0, i0, 0], dtype=torch.int32,
                                               device=self.s.device)
            self.best = torch.where(cand[0] > self.best[0], cand, self.best)
        self.band += 1
        self.save()
        return self.band < self.num_bands

    def run(self):
        while self.step():
            pass
        return self.outputs()

    def outputs(self):
        """``last_row`` (n,), ``last_col`` (m,) and ``best`` (3,): int32
        tensors on the device; ``best`` stays (SCORE_MIN, -1, -1) outside
        LOCAL."""
        if self.band < self.num_bands:
            raise RuntimeError("scoring not finished")
        return {"last_row": self.row, "last_col": self.last_col,
                "best": self.best}

    def score(self):
        outs = self.outputs()
        return linmem.extract_score_from_outputs(outs, self.m, self.n,
                                                 self.mode)
