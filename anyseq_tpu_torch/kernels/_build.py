"""Build of the CUDA kernels in ``csrc/``, their ctypes binding, and one
launch counter per kernel.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into a shared
library with a plain C interface under ``anyseq_tpu_torch/_build/``
(named by a hash of the sources and flags, so an unchanged build is
reused), loaded with ctypes. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("walk.cu", "lastcols.cu", "walk_affine.cu", "lastcols_affine.cu",
           "swarm.cu", "band.cu", "band_affine.cu")
HEADERS = ("common.cuh", "band_sweep.cuh", "band_sweep_affine.cuh",
           "walk_core.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# Kernel launches made by the wrappers, by kernel: K1, K2, K3, K4, K5,
# K5p, K5L, K6, K7 score-only, K7 with codes (2-bit linear or 4-bit
# affine), K8, K8 affine, K10 and K10 affine (one launch a rank a band).
# K1 and K2 (K5 and K5p) run K8's (K8 affine's) entry and warp strip
# core at their own widths, and count as themselves.
launches = {"wavefront_score": 0, "wavefront_preds": 0, "walk": 0,
            "lastcols": 0, "wavefront_affine_score": 0,
            "wavefront_affine_preds": 0, "lastcols_affine": 0,
            "walk_affine": 0, "swarm_score": 0, "swarm_preds": 0,
            "band": 0, "band_affine": 0, "band_collective": 0,
            "band_collective_affine": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "anyseq_walk": (_P, _L, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _P,
                    _P),
    "anyseq_lastcols": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P, _P, _P, _I, _P),
    "anyseq_lastcols_width": (_P, _P, _I, _L),
    "anyseq_lastcols_grid": (_P, _P, _I, _I, _I),
    "anyseq_walk_affine": (_P, _L, _I, _P, _I, _P, _I, _P, _P, _I, _I, _P,
                           _P, _I, _P, _P),
    "anyseq_lastcols_affine": (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                               _P),
    "anyseq_lastcols_affine_width": (_P, _P, _I, _L),
    "anyseq_lastcols_affine_grid": (_P, _P, _I, _I, _I),
    "anyseq_swarm": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                     _P, _I, _I, _P),
    "anyseq_swarm_plan": (_P, _P, _I, _I, _I, _I, _I, _L, _P, _P),
    "anyseq_band": (_P, _I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                    _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "anyseq_band_affine": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "anyseq_band_grid": (_I, _I, _I, _I, _I),
    "anyseq_band_affine_grid": (_I, _I, _I, _I, _I),
    "anyseq_band_affine_strip": (),
    "anyseq_sweep": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P,
                     _P, _P, _P, _P, _P, _I, _P),
    "anyseq_sweep_width": (_I, _I, _I, _I),
    "anyseq_sweep_grid": (_I, _I, _I, _I, _I),
    "anyseq_sweep_affine": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _I, _P),
    "anyseq_sweep_affine_width": (_I, _I, _I, _I),
    "anyseq_sweep_affine_grid": (_I, _I, _I, _I, _I),
    "anyseq_enable_peer": (_I, _I),
}


class Build:
    """The loaded kernel library and what its build cost."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float):
        self.lib = lib
        self.path = path
        self.seconds = seconds


_loaded: Build | None = None


def load(path) -> ctypes.CDLL:
    """Load a kernel library and declare its C signatures."""
    from anyseq_tpu_torch.kernels import band

    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    if lib.anyseq_band_affine_strip() != band.AFFINE_STRIP:
        raise RuntimeError(f"{path}: K8 affine strips of "
                           f"{lib.anyseq_band_affine_strip()} columns, "
                           f"kernels/band.py sizes {band.AFFINE_STRIP}")
    return lib


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def build() -> Build:
    """Compile the kernels (unless this exact build exists) and load them."""
    global _loaded
    if _loaded is not None:
        return _loaded
    target = BUILD_DIR / f"libanyseq_kernels-{_source_hash()}.so"
    t0 = time.perf_counter()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)]
                      for name, obj in zip(SOURCES, objs)])
            lib = os.path.join(tmp, "lib.so")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
            os.replace(lib, target)
    _loaded = Build(load(target), target, time.perf_counter() - t0)
    return _loaded


def library() -> ctypes.CDLL:
    return build().lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch was refused (the C entry returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def stream(device):
    """The current CUDA stream of `device` as a pointer, None on the CPU."""
    import torch

    if device.type == "cuda":
        return torch.cuda.current_stream(device).cuda_stream
    return None
