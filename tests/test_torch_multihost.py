"""Multi-process runs of the port: two worker processes on 127.0.0.1,
joined by ``dist.mesh.init_distributed`` over torch.distributed (gloo),
each with a mesh of 4 CPU devices, so that the global sp ring has 8 ranks
(ranks 0-3 in process 0, 4-7 in process 1; the process edge lies at
column 4,096).

It mirrors ``tests/test_multihost.py`` (the same 150 x 900 GLOBAL score
and 600 x 800 GLOBAL construction at min_width=64) and adds sharded
scores in every mode whose columns cross the process edge in bands of 48
rows, LOCAL ties on both sides of the edge, the 2-D batch of pairs,
constructions whose endpoint passes cross the edge (linear and affine
Myers-Miller), the batch calls, and a checkpointed construction stopped
and resumed in both processes. Every result must be bit-identical in
both processes, to the port in one process and to the JAX package on
XLA:CPU in this pytest process.

Also the port's ``utils/profiling.py`` (its lines) and ``utils/debug.py``
(its tables, against the JAX package's ``format_dp_state``).
"""
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from anyseq_tpu.core import types as jt
from anyseq_tpu.engine import api as jax_api
from anyseq_tpu.engine import batch as jax_batch
from anyseq_tpu.engine import xla_affine, xla_linmem
from anyseq_tpu.engine.hirschberg import align_hirschberg as jax_hirschberg
from anyseq_tpu.utils import debug as jax_debug
from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring
from anyseq_tpu_torch.utils import debug, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240      # a worker pair's limit

# The cases, run by the workers over the two-process mesh and here by the
# port in one process (exec'd below); they import neither jax nor the JAX
# package.
CASES = r'''
import os

import numpy as np
import torch

import anyseq_tpu_torch as pt
from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring, Mode
from anyseq_tpu_torch.dist import batch as dist_batch
from anyseq_tpu_torch.dist import collective
from anyseq_tpu_torch.dist.sharded import score_pair_sharded
from anyseq_tpu_torch.engine import hirschberg, linmem
from anyseq_tpu_torch.kernels import wavefront

SC = LinearScoring(2, -1, -1)
ASC = AffineScoring(2, -1, -3, -1)
MODES = ("global", "semiglobal", "local")
ALPHA = np.frombuffer(b"ACGT", np.uint8)
KEYS = ("last_row", "last_col", "last_col_e", "best")


def dna(rng, n):
    return bytes(ALPHA[rng.integers(0, 4, n)])


def mutated(rng, seq):
    """seq with 10% of its symbols drawn anew."""
    a = np.frombuffer(seq, np.uint8).copy()
    hit = rng.random(len(a)) < 0.1
    a[hit] = ALPHA[rng.integers(0, 4, int(hit.sum()))]
    return bytes(a)


def tie_pair():
    """A LOCAL tie across the process edge (column 4,096): the query's
    rows 30-89 (b + c) end at column 4,090 on rank 3 (process 0), its
    rows 0-59 (a + b) at column 4,230 on rank 4 (process 1), which ends in
    an earlier row and wins; with a + b on both sides the earlier column
    (4,090, rank 3) wins."""
    rng = np.random.default_rng(7)
    a, b, c = (bytes(ALPHA[rng.integers(0, 4, 30)]) for _ in range(3))
    q = a + b + c
    return q, [b"N" * 4031 + b + c + b"N" * 80 + a + b + b"N" * 300,
               b"N" * 4031 + a + b + b"N" * 80 + a + b + b"N" * 300]


def score_inputs():
    """(name, q, s, mode, scoring, band rows) of the sharded scores."""
    rng = np.random.default_rng(0)
    q, s = dna(rng, 150), dna(rng, 900)      # tests/test_multihost.py's
    cases = [(f"linear {m} 150x900", q, s, m, SC, None) for m in MODES]
    rng = np.random.default_rng(1)
    q, s = dna(rng, 200), dna(rng, 6000)
    for name, sc in (("linear", SC), ("affine", ASC)):
        cases += [(f"{name} {m} 200x6000 bands of 48", q, s, m, sc, 48)
                  for m in MODES]
    q, ties = tie_pair()
    for name, sc in (("linear", SC), ("affine", ASC)):
        cases += [(f"{name} local tie {k}", q, s, "local", sc, 32)
                  for k, s in enumerate(ties)]
    return cases


def pairs_inputs():
    """Pairs for score_pairs_collective: three on a 2 x 4 mesh (a row a
    process), two wide ones on the 8-rank ring."""
    rng = np.random.default_rng(2)
    return ([(dna(rng, 60 + 40 * k), dna(rng, 900 + 700 * k))
             for k in range(3)],
            [(dna(rng, 90), dna(rng, 4500 + 400 * k)) for k in range(2)])


def as_t(x):
    return torch.frombuffer(bytearray(x), dtype=torch.uint8)


def run_score(mesh):
    res = {}
    for name, q, s, mode, sc, rows in score_inputs():
        affine = isinstance(sc, AffineScoring)
        if mesh is None:
            outs = wavefront.score(as_t(q), as_t(s), Mode.parse(mode), sc,
                                   **({"emit_col_e": True} if affine
                                      else {}))
        else:
            outs = score_pair_sharded(q, s, mode, sc, mesh, band_rows=rows)
        # the best cell is an output of LOCAL sweeps only
        res[name] = {k: outs[k].tolist() for k in KEYS
                     if k in outs and (k != "best" or mode == "local")}
    by_row, ring = pairs_inputs()
    for name, pairs, shape in (("2x4", by_row, (2, 4)),
                               ("1x8", ring, (1, 8))):
        for mode in MODES:
            if mesh is None:
                got = [linmem.extract_score_from_outputs(
                    wavefront.score(as_t(q), as_t(s), Mode.parse(mode), SC),
                    len(q), len(s), Mode.parse(mode)) for q, s in pairs]
            else:
                got = collective.score_pairs_collective(
                    [p[0] for p in pairs], [p[1] for p in pairs], mode, SC,
                    mesh.reshape(shape, ("dp", "sp")), band_rows=32)
            res[f"pairs {name} {mode}"] = [[int(v), list(map(int, e))]
                                           for v, e in got]
    return res


def aln(a):
    return [a.score, a.query_aligned.hex(), a.subject_aligned.hex(),
            list(a.start)]


def construct_inputs():
    """(name, q, s, mode, scoring) of the constructions over the mesh:
    the endpoint passes of the 200 x 5,000 pairs cross the edge."""
    rng = np.random.default_rng(3)
    q, s = dna(rng, 600), dna(rng, 800)      # tests/test_multihost.py's
    cases = [("linear global 600x800 min_width 64", q, s, "global", SC)]
    rng = np.random.default_rng(5)
    s = dna(rng, 5000)
    q = mutated(rng, s[3990:4190])           # across column 4,096
    for name, sc in (("linear", SC), ("affine", ASC)):
        cases += [(f"{name} {m} 200x5000", q, s, m, sc)
                  for m in ("semiglobal", "local")]
    q, s = dna(rng, 300), dna(rng, 1400)
    cases.append(("affine global 300x1400 levels over the mesh", q, s,
                  "global", ASC))
    return cases


def run_construct(mesh):
    res = {}
    for name, q, s, mode, sc in construct_inputs():
        if "min_width 64" in name:
            hirschberg.MIN_WIDTH, keep = 64, hirschberg.MIN_WIDTH
            try:
                got = hirschberg.align_hirschberg(q, s, mode, sc,
                                                  device="cpu", mesh=mesh)
            finally:
                hirschberg.MIN_WIDTH = keep
        elif "levels over the mesh" in name:
            got = hirschberg.align_hirschberg(q, s, mode, sc, device="cpu",
                                              mesh=mesh, sp_min_width=256)
        else:
            got = pt.align(q, s, mode, sc, traceback="hirschberg",
                           device="cpu", mesh=mesh)
        res[name] = aln(got)
    return res


def batch_inputs():
    rng = np.random.default_rng(6)
    qs, ss = [], []
    for _ in range(37):
        q = dna(rng, int(rng.integers(20, 200)))
        qs.append(q)
        ss.append(mutated(rng, q)[int(rng.integers(0, 10)):]
                  + dna(rng, int(rng.integers(0, 30))))
    return qs, ss


def run_batch(mesh):
    qs, ss = batch_inputs()
    res = {}
    for mode in MODES:
        for name, sc in (("linear", SC), ("affine", ASC)):
            res[f"scores {name} {mode}"] = (
                pt.align_scores_batch(qs, ss, mode, sc, device="cpu")
                if mesh is None else dist_batch.align_scores_batch_sharded(
                    qs, ss, mode, sc, mesh)).tolist()
        res[f"align linear {mode}"] = [aln(a) for a in pt.align_batch(
            qs, ss, mode, SC, device="cpu", mesh=mesh)]
    res["align affine local 6 pairs"] = [aln(a) for a in pt.align_batch(
        qs[:6], ss[:6], "local", ASC, device="cpu", mesh=mesh)]
    return res


class Stop(Exception):
    pass


def checkpoint_inputs():
    rng = np.random.default_rng(8)
    s = dna(rng, 1600)
    return [("linear", mutated(rng, s[200:1300]), s, SC),
            ("affine", mutated(rng, s[400:1500]), s, ASC)]


def run_checkpoint(mesh, workdir=None):
    """Semiglobal constructions (levels over the mesh from 256 columns):
    clean, and with a checkpoint stopped after its fourth save (the two
    endpoint stages and two levels) in every process, then resumed;
    with the levels each run logged."""
    res = {}
    for name, q, s, sc in checkpoint_inputs():
        os.environ["ANYSEQ_TIMING"] = "1"
        try:
            hirschberg.TIMING_LOG.clear()
            clean = hirschberg.align_hirschberg(q, s, "semiglobal", sc,
                                                device="cpu", mesh=mesh,
                                                sp_min_width=256)
            levels = [ln for ln in hirschberg.TIMING_LOG if "level" in ln]
            res[f"{name} clean"] = aln(clean)
            if mesh is None:
                continue
            res[f"{name} clean levels"] = len(levels)
            path = os.path.join(workdir, f"{name}.npz")
            save, saves = hirschberg._HbCheckpoint.save, [0]

            def save_then_stop(self, **arrays):
                save(self, **arrays)
                saves[0] += 1
                if saves[0] == 4:
                    raise Stop()

            hirschberg._HbCheckpoint.save = save_then_stop
            try:
                hirschberg.align_hirschberg(q, s, "semiglobal", sc,
                                            device="cpu", mesh=mesh,
                                            sp_min_width=256,
                                            checkpoint_path=path)
                res[f"{name} stopped"] = False
            except Stop:
                res[f"{name} stopped"] = True
            finally:
                hirschberg._HbCheckpoint.save = save
            hirschberg.TIMING_LOG.clear()
            again = hirschberg.align_hirschberg(q, s, "semiglobal", sc,
                                                device="cpu", mesh=mesh,
                                                sp_min_width=256,
                                                checkpoint_path=path)
            res[f"{name} resumed"] = aln(again)
            res[f"{name} resumed levels"] = sum(
                "level" in ln for ln in hirschberg.TIMING_LOG)
        finally:
            os.environ.pop("ANYSEQ_TIMING", None)
    return res


GROUPS = {"score": run_score, "construct": run_construct,
          "batch": run_batch, "checkpoint": run_checkpoint}
'''

WORKER = CASES + r'''

if __name__ == "__main__":
    import json
    import sys

    import torch

    from anyseq_tpu_torch.dist.mesh import (init_distributed, make_mesh,
                                            process_count, process_index)

    pid, port, group, workdir = sys.argv[1:]
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 2, int(pid))
    assert (process_index(), process_count()) == (int(pid), 2)
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.owner_list() == [0] * 4 + [1] * 4, mesh
    run = GROUPS[group]
    res = (run(mesh, workdir) if group == "checkpoint" else run(mesh))
    assert "jax" not in sys.modules and "anyseq_tpu" not in sys.modules
    print("RESULT " + json.dumps(res), flush=True)
'''

_cases: dict = {}
exec(compile(CASES, "multihost_cases", "exec"), _cases)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_processes(tmp_path, group: str) -> list[dict]:
    """The worker pair's results for `group`, process 0's then process
    1's. A worker pair that fails or passes TIMEOUT_S fails the test with
    both workers' output (both are killed)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("ANYSEQ_TIMING", None)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-u", str(script), str(pid), str(port), group,
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True, cwd=ROOT) for pid in range(2)]
    outs = ["", ""]
    try:
        for pid, p in enumerate(procs):
            outs[pid], _ = p.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for pid, p in enumerate(procs):
            p.kill()
            outs[pid] = p.communicate()[0]
        pytest.fail(f"worker pair {group!r} passed {TIMEOUT_S} s:\n"
                    + "\n".join(f"--- process {k}:\n{o[-3000:]}"
                                for k, o in enumerate(outs)))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{out[-4000:]}"
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert len(lines) == 1, out[-2000:]
        results.append(json.loads(lines[0][len("RESULT "):]))
    return results


def _jsc(sc):
    if isinstance(sc, AffineScoring):
        return jt.AffineScoring(sc.match, sc.mismatch, sc.gap_open,
                                sc.gap_extend)
    return jt.LinearScoring(sc.match, sc.mismatch, sc.gap)


def _aln(a):
    return [a.score, a.query_aligned.hex(), a.subject_aligned.hex(),
            list(map(int, a.start))]


def _jax_score(q, s, mode, sc, keys):
    """The JAX package's single-device row scan of the pair: the port's
    output names, cut to the pair."""
    _, _, m, n, qp, sp = jax_api._prep(q, s)
    jsc, jmode = _jsc(sc), jt.Mode(mode)
    if isinstance(sc, AffineScoring):
        outs = xla_affine.score_rows_affine(qp, sp, m, n, jmode, jsc,
                                            emit_col_e=True)
    else:
        outs = xla_linmem.score_rows(qp, sp, m, n, jmode, jsc)
    want = {}
    for k in keys:
        v = np.asarray(outs[k])
        want[k] = (v[:n] if k == "last_row" else v[:m] if k != "best"
                   else v).tolist()
    if mode != "local":
        want.pop("best", None)
    return want


def _jax_end(q, s, mode, sc):
    _, _, m, n, qp, sp = jax_api._prep(q, s)
    outs = {k: np.asarray(v) for k, v in xla_linmem.score_rows(
        qp, sp, m, n, jt.Mode(mode), _jsc(sc)).items()}
    score, end = xla_linmem.extract_score_from_outputs(
        outs, m, n, jt.Mode(mode), _jsc(sc))
    return [int(score), list(map(int, end))]


def _jax_group(group: str) -> dict:
    """The JAX package's results of a group's cases (the checkpoint
    group's clean runs), on XLA:CPU."""
    c = _cases
    res = {}
    if group == "score":
        for name, q, s, mode, sc, _ in c["score_inputs"]():
            keys = ["last_row", "last_col", "best"] + (
                ["last_col_e"] if isinstance(sc, AffineScoring) else [])
            res[name] = _jax_score(q, s, mode, sc, keys)
        by_row, ring = c["pairs_inputs"]()
        for name, pairs in (("2x4", by_row), ("1x8", ring)):
            for mode in c["MODES"]:
                res[f"pairs {name} {mode}"] = [_jax_end(q, s, mode, c["SC"])
                                               for q, s in pairs]
    elif group == "construct":
        for name, q, s, mode, sc in c["construct_inputs"]():
            width = 64 if "min_width 64" in name else 256
            res[name] = _aln(jax_hirschberg(q, s, jt.Mode(mode), _jsc(sc),
                                            min_width=width))
    elif group == "batch":
        qs, ss = c["batch_inputs"]()
        for mode in c["MODES"]:
            for name, sc in (("linear", c["SC"]), ("affine", c["ASC"])):
                res[f"scores {name} {mode}"] = jax_batch.align_scores_batch(
                    qs, ss, jt.Mode(mode), _jsc(sc)).tolist()
            res[f"align linear {mode}"] = [_aln(a) for a in
                                           jax_batch.align_batch(
                                               qs, ss, jt.Mode(mode),
                                               _jsc(c["SC"]))]
        res["align affine local 6 pairs"] = [_aln(a) for a in
                                             jax_batch.align_batch(
                                                 qs[:6], ss[:6], jt.Mode.LOCAL,
                                                 _jsc(c["ASC"]))]
    else:
        for name, q, s, sc in c["checkpoint_inputs"]():
            res[f"{name} clean"] = _aln(jax_hirschberg(
                q, s, jt.Mode.SEMIGLOBAL, _jsc(sc), min_width=256))
    return res


def _held(got: dict, want: dict, who: str):
    for name, value in want.items():
        v = got[name]
        if isinstance(value, dict):
            value = {k: x for k, x in value.items() if k in v}
            v = {k: x for k, x in v.items() if k in value}
        assert v == value, f"{name}: {who} differs"


@pytest.mark.parametrize("group", ["score", "construct", "batch",
                                   "checkpoint"])
def test_two_processes(tmp_path, group):
    """Both processes give the same results, equal to the port in one
    process and to the JAX package."""
    p0, p1 = _run_two_processes(tmp_path, group)
    assert p0 == p1, "the two processes differ"
    single = _cases["GROUPS"][group](None)
    _held(p0, single, "the port in one process")
    want = _jax_group(group)
    _held(single, want, "the JAX package")
    _held(p0, want, "the JAX package")
    if group == "score":
        # tests/test_multihost.py's check: H[m-1][n-1] of the 150 x 900
        # pair, on every process
        assert p0["linear global 150x900"]["last_col"][149] == \
            single["linear global 150x900"]["last_col"][149]
        # the ties: rank 4's earlier row, then rank 3's earlier column
        for scheme in ("linear", "affine"):
            assert p0[f"{scheme} local tie 0"]["best"] == [120, 59, 4230]
            assert p0[f"{scheme} local tie 1"]["best"] == [120, 59, 4090]
    if group == "checkpoint":
        for name in ("linear", "affine"):
            assert p0[f"{name} stopped"] is True
            assert p0[f"{name} resumed"] == p0[f"{name} clean"]
            # the resumed run divided only the levels left
            assert 0 < p0[f"{name} resumed levels"] < \
                p0[f"{name} clean levels"]


@pytest.mark.parametrize("cells", [None, 12_345])
def test_profiling_lines(cells):
    """timed prints the JAX package's "testing <name> N ms" line (plus
    GCUPS for a cell count), or one JSON object; Timer adds intervals."""
    buf = io.StringIO()
    with profiling.timed("pair", cells=cells, file=buf) as t:
        pass
    line = buf.getvalue().strip()
    want = f"testing pair {t.milliseconds()} ms"
    if cells:
        assert line.startswith(want + " (") and line.endswith(" GCUPS)")
    else:
        assert line == want
    buf = io.StringIO()
    with profiling.timed("pair", cells=cells, file=buf, emit_json=True):
        pass
    rec = json.loads(buf.getvalue())
    assert rec["name"] == "pair" and ("gcups" in rec) == bool(cells)
    timer = profiling.Timer()
    timer.start().stop()
    first = timer.elapsed
    timer.start().stop()
    assert timer.elapsed >= first >= 0 and timer.milliseconds() >= 0


def test_profiling_trace(tmp_path):
    """trace writes torch.profiler's Chrome trace of the block."""
    import torch

    with profiling.trace(str(tmp_path / "prof")):
        torch.arange(1000).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("scheme", ["linear", "affine", "affine ge=0",
                                    "affine go=0"])
@pytest.mark.parametrize("mode", ["global", "semiglobal", "local"])
def test_debug_tables_match_jax(mode, scheme):
    """format_dp_state (and so format_matrix, format_preds) gives the JAX
    package's text on small pairs, and dump_matrix prints it."""
    sc = {"linear": LinearScoring(2, -1, -1),
          "affine": AffineScoring(2, -1, -3, -1),
          "affine ge=0": AffineScoring(1, -6, -4, 0),
          "affine go=0": AffineScoring(2, -1, 0, -1)}[scheme]
    rng = np.random.default_rng(len(scheme) * 7 + len(mode))
    for _ in range(4):
        m, n = rng.integers(1, 9, 2)
        q = bytes(rng.choice(list(b"ACGT"), m))
        s = bytes(rng.choice(list(b"ACGT"), n))
        assert debug.format_dp_state(q, s, mode, sc) == \
            jax_debug.format_dp_state(q, s, mode, _jsc(sc))
    buf = io.StringIO()
    debug.dump_matrix(b"GATTACA", b"GCATGCT", mode, sc, file=buf)
    assert buf.getvalue() == debug.format_dp_state(
        b"GATTACA", b"GCATGCT", mode, sc) + "\n"
