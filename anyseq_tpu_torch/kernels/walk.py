"""K3 and K6 wrappers: the batched traceback walks over packed codes,
linear (``csrc/walk.cu``) and affine 3-state (``csrc/walk_affine.cu``),
one warp a walk over code windows staged in shared memory
(``csrc/walk_core.cuh``).

On a CPU tensor :func:`walk` and :func:`walk_affine` run the plain
versions (:data:`plain`, ``engine.batch.walk_batch_ends``, and
:data:`plain_affine`, ``engine.batch.walk_batch_affine_ends``); on a CUDA
tensor they launch the kernels.
"""
from __future__ import annotations

import torch

from anyseq_tpu_torch.core.types import EMPTY_SYM, Mode
from anyseq_tpu_torch.engine import batch
from anyseq_tpu_torch.engine.affine import CODES4_PER_WORD
from anyseq_tpu_torch.engine.linmem import CODES_PER_WORD
from anyseq_tpu_torch.kernels import _build

plain = batch.walk_batch_ends
plain_affine = batch.walk_batch_affine_ends


def _check(words, q, s, ends, per_word=CODES_PER_WORD) -> None:
    B, M, NW = words.shape
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError("words must be a contiguous (B, M, NW) int32 tensor")
    for name, t in (("q", q), ("s", s)):
        if (t.dtype != torch.uint8 or t.dim() != 2 or t.shape[0] != B
                or t.stride(1) != 1):
            raise ValueError(f"{name} must be a (B, L) uint8 tensor")
    if q.shape[1] != M or NW * per_word < s.shape[1]:
        raise ValueError("code words do not cover the sequences")
    if ends.shape != (B, 2):
        raise ValueError("ends must be (B, 2)")
    if len({words.device, q.device, s.device, ends.device}) != 1:
        raise ValueError("all tensors must be on one device")


def walk(words, q, s, ends, mode: Mode):
    """Walk B problems from their end cells. words: (B, M, NW) int32
    packed codes, q: (B, M) uint8, s: (B, N) uint8, ends: (B, 2) int32.
    Returns (out_q, out_s, starts) as ``batch.walk_batch_ends``."""
    mode = Mode.parse(mode)
    _check(words, q, s, ends)
    if words.device.type == "cpu":
        return plain(words, q, s, ends, mode)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    return launch(_build.library(), words, q, s, ends, mode)


def launch(lib, words, q, s, ends, mode: Mode):
    """Launch the kernel of `lib`, wherever the tensors lie."""
    B, M, NW = words.shape
    L = M + s.shape[1]
    dev = words.device
    ends = ends.to(torch.int32).contiguous()
    out_q = torch.full((B, L), EMPTY_SYM, dtype=torch.uint8, device=dev)
    out_s = torch.full((B, L), EMPTY_SYM, dtype=torch.uint8, device=dev)
    starts = torch.empty((B, 2), dtype=torch.int32, device=dev)
    err = lib.anyseq_walk(
        words.data_ptr(), M * NW, NW, q.data_ptr(), q.stride(0),
        s.data_ptr(), s.stride(0), ends.data_ptr(), B,
        int(mode is Mode.GLOBAL), out_q.data_ptr(), out_s.data_ptr(), L,
        starts.data_ptr(), _build.stream(dev),
    )
    _build.check(err, "walk")
    _build.launches["walk"] += 1
    return out_q, out_s, starts


def walk_affine(words, q, s, ends, mode: Mode, sgap=None, egap=None):
    """The 3-state affine walk of B problems from their end cells. words:
    (B, M, NW) int32 4-bit codes (``affine.pack_codes4``), q: (B, M)
    uint8, s: (B, N) uint8, ends: (B, 2) int32, sgap / egap: (B,) bool
    (all False when None). Returns (out_q, out_s, starts) as
    ``batch.walk_batch_affine_ends``."""
    mode = Mode.parse(mode)
    _check(words, q, s, ends, CODES4_PER_WORD)
    B = words.shape[0]
    flags = []
    for f in (sgap, egap):
        if f is None:
            f = torch.zeros(B, dtype=torch.bool, device=words.device)
        if f.shape != (B,) or f.device != words.device:
            raise ValueError("sgap / egap must be (B,) on the codes' device")
        flags.append(f.to(torch.bool).contiguous())
    if words.device.type == "cpu":
        return plain_affine(words, q, s, ends, mode, *flags)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    return launch_affine(_build.library(), words, q, s, ends, mode, *flags)


def launch_affine(lib, words, q, s, ends, mode: Mode, sgap, egap):
    """Launch the affine kernel of `lib`, wherever the tensors lie. It
    takes :data:`plain_affine`'s arguments, so that a launch can be held
    to the plain version, but the kernel reads no `sgap`: the start-gap
    flag only sets PE on row -1, where E and H both move left."""
    B, M, NW = words.shape
    L = M + s.shape[1]
    dev = words.device
    ends = ends.to(torch.int32).contiguous()
    out_q = torch.full((B, L), EMPTY_SYM, dtype=torch.uint8, device=dev)
    out_s = torch.full((B, L), EMPTY_SYM, dtype=torch.uint8, device=dev)
    starts = torch.empty((B, 2), dtype=torch.int32, device=dev)
    err = lib.anyseq_walk_affine(
        words.data_ptr(), M * NW, NW, q.data_ptr(), q.stride(0),
        s.data_ptr(), s.stride(0), ends.data_ptr(), egap.data_ptr(), B,
        int(mode is Mode.GLOBAL), out_q.data_ptr(), out_s.data_ptr(), L,
        starts.data_ptr(), _build.stream(dev),
    )
    _build.check(err, "walk_affine")
    _build.launches["walk_affine"] += 1
    return out_q, out_s, starts
