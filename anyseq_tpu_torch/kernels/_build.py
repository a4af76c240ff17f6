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
SOURCES = ("wavefront.cu", "walk.cu", "lastcols.cu", "wavefront_affine.cu",
           "walk_affine.cu", "lastcols_affine.cu", "swarm.cu")
HEADERS = ("common.cuh", "sweep.cuh", "sweep_affine.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# Kernel launches made by the wrappers, by kernel: K1, K2, K3, K4, K5,
# K5p, K5L, K6, K7 score-only and K7 with codes.
launches = {"wavefront_score": 0, "wavefront_preds": 0, "walk": 0,
            "lastcols": 0, "wavefront_affine_score": 0,
            "wavefront_affine_preds": 0, "lastcols_affine": 0,
            "walk_affine": 0, "swarm_score": 0, "swarm_preds": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "anyseq_wavefront": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P, _P, _P, _I, _P),
    "anyseq_walk": (_P, _L, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _P,
                    _P),
    "anyseq_lastcols": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                        _P, _I, _P, _P, _I, _P),
    "anyseq_wavefront_affine": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "anyseq_walk_affine": (_P, _L, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I,
                           _P, _P, _I, _P, _P),
    "anyseq_lastcols_affine": (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                               _P),
    "anyseq_swarm": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P),
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
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
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
