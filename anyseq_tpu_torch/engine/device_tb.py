"""Full-matrix traceback on the device.

The sweep emits packed predecessor codes (K2, or K5p for affine gaps),
the score and end cell are extracted on the device, and the walk (K3, or
the 3-state K6) writes the gapped strings there too: only the O(m + n)
strings and five integers come back to the host; the code matrix never
leaves the device.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import AffineScoring, Mode
from anyseq_tpu_torch.engine import linmem
from anyseq_tpu_torch.kernels import walk, wavefront
from anyseq_tpu_torch.utils import profiling


def fulltb(q, s, mode: Mode, sc):
    """q, s: 1-D uint8 tensors on one device. Returns (score, end, out_q,
    out_s, start) with numpy uint8 strings of length m + n."""
    mode = Mode.parse(mode)
    m, n = int(q.shape[0]), int(s.shape[0])
    outs = wavefront.score(q, s, mode, sc, emit_preds=True)
    end = linmem.extract_end(outs, m, n, mode)
    walker = walk.walk_affine if isinstance(sc, AffineScoring) else walk.walk
    out_q, out_s, start = walker(outs["preds"][None], q[None], s[None],
                                 end[None, 1:], mode)
    ints = torch.cat([end, start[0]])
    with profiling.wait():
        score, ei, ej, si, sj = ints.tolist()
        out_q, out_s = out_q[0].cpu().numpy(), out_s[0].cpu().numpy()
    return score, (ei, ej), out_q, out_s, (si, sj)
