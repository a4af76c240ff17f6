"""The port's spans (``anyseq_tpu_torch.utils.profiling``) on the CPU: off
by default and free, recorded under ``ANYSEQ_TIMING=1`` with the public
calls as roots, seen by ``torch.profiler`` as host ranges, the phase log
built on them; the benchmark's readers of them on span lists whose
values are known; and the CLI's timing lines on the same timer."""
import io
import re
import time
from pathlib import Path

import numpy as np
import pytest

import anyseq_tpu_torch as pt
from anyseq_tpu_torch import cli
from anyseq_tpu_torch.engine import batch, hirschberg
from anyseq_tpu_torch.utils import profiling

from conftest import mutate, random_dna

ROOT = Path(__file__).resolve().parents[1]
SC = pt.LinearScoring(2, -1, -1)
ASC = pt.AffineScoring(2, -1, -3, -1)
# the phase log's lines, in the JAX package's words, with ms to 3 places
LINE = re.compile(r"(aff )?(level P=\d+ maxh=\d+ maxmid=\d+ path=\S+"
                  r"|terminals n=\d+|fwd pass|rev pass) \d+\.\d{3}ms")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No switch and no spans left by another test of this process."""
    monkeypatch.delenv("ANYSEQ_TIMING", raising=False)
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def timing(monkeypatch):
    monkeypatch.setenv("ANYSEQ_TIMING", "1")


def _pairs(n=12, seed=3):
    rng = np.random.default_rng(seed)
    qs = [random_dna(rng, int(rng.integers(20, 160))) for _ in range(n)]
    return qs, [mutate(rng, q) + random_dna(rng, 30) for q in qs]


def _long_pair(seed=4):
    rng = np.random.default_rng(seed)
    q = random_dna(rng, 1400)
    return q, random_dna(rng, 90) + mutate(rng, q[100:1200])


def _entries():
    qs, ss = _pairs()
    q, s = _long_pair()
    return {
        "align_score": (lambda: pt.align_score(q, s, "semiglobal", SC,
                                               device="cpu"),
                        "api.align_score", {"api.wait"}),
        "align hirschberg": (
            lambda: pt.align(q, s, "semiglobal", SC, traceback="hirschberg",
                             device="cpu"),
            "api.align", {"hirschberg.align", "hirschberg.fwd_pass",
                          "hirschberg.rev_pass", "hirschberg.level",
                          "hirschberg.terminals", "hirschberg.terminal_chunk",
                          "hirschberg.result", "hirschberg.wait"}),
        "align hirschberg affine": (
            lambda: pt.align(q, s, "local", ASC, traceback="hirschberg",
                             device="cpu"),
            "api.align", {"hirschberg.align", "hirschberg.level",
                          "hirschberg.terminals", "hirschberg.result"}),
        "align full": (lambda: pt.align(q[:300], s[:300], "global", SC,
                                        device="cpu"),
                       "api.align", {"api.align_full_tb", "api.wait"}),
        "align_full_tb": (lambda: pt.align_full_tb(q[:300], s[:300], "local",
                                                   SC, device="cpu"),
                          "api.align_full_tb", {"api.wait"}),
        "align_batch": (lambda: pt.align_batch(qs, ss, "local", SC,
                                               device="cpu"),
                        "api.align_batch",
                        {"batch.stage", "batch.copy_in", "batch.wait",
                         "batch.sweep", "batch.copy_out", "batch.assemble"}),
        "align_batch affine": (lambda: pt.align_batch(qs[:3], ss[:3], "local",
                                                      ASC, device="cpu"),
                               "api.align_batch",
                               {"api.align", "api.align_full_tb"}),
        "align_scores_batch": (lambda: pt.align_scores_batch(
            qs, ss, "global", SC, device="cpu"), "api.align_scores_batch",
            {"batch.stage", "batch.copy_in", "batch.wait", "batch.sweep",
             "batch.copy_out"}),
    }


ENTRIES = list(_entries())


def test_off_records_nothing():
    """Without the switch a span is the one shared no-op, wait spans too,
    and a public call records nothing."""
    assert profiling.span("a.b") is profiling.span("c.d", pairs=3)
    assert profiling.wait() is profiling.span("a.b")
    with profiling.span("a.b"):
        pass
    pt.align_batch(*_pairs(4), "global", SC, device="cpu")
    pt.align_score(b"ACGT", b"AGT", device="cpu")
    assert profiling.spans() == [] and profiling.dropped == 0
    assert not profiling.recording()


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_records_its_span_tree(entry, timing):
    """Each public entry records one root call span and the child spans
    of its layers; every child lies inside its parent, and every span
    carries the root's call id."""
    fn, root_name, children = _entries()[entry]
    fn()
    fn()
    spans = profiling.spans()
    roots = [s for s in spans if s.parent < 0]
    assert [r.name for r in roots] == [root_name, root_name]
    assert [r.call for r in roots] == [roots[0].call, roots[0].call + 1]
    assert all(isinstance(r.attrs["launches"], int) for r in roots)
    assert children <= {s.name for s in spans}
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and s.call == p.call
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        if s.name.startswith("api.align") and s.parent >= 0:
            assert "launches" in s.attrs        # a nested public call
    for s in spans:
        if s.name.endswith(".wait"):            # named after its layer
            assert s.name.split(".")[0] == spans[s.parent].name.split(".")[0]
            assert not any(a.name.endswith(".wait") or a.name in
                           profiling.WAITS for a in _ancestors(spans, s))
    assert not profiling.recording()


def _ancestors(spans, s):
    while s.parent >= 0:
        s = spans[s.parent]
        yield s


def test_batch_spans_count_pairs_and_bytes(timing):
    """align_batch's spans: a chunk a bucket's pairs, and the bytes copied
    in (the padded rows and both lengths) and out (score, start and the
    two padded strings), from the chunk shapes."""
    qs, ss = _pairs(10)
    pt.align_batch(qs, ss, "local", SC, device="cpu")
    spans = profiling.spans()
    M = batch._bucket(np.array([len(q) for q in qs]))
    N = batch._bucket(np.array([len(s) for s in ss]))
    assert {int(x) for x in M} == {256} and {int(x) for x in N} == {256}
    B, M, N = len(qs), 256, 256
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s.attrs)
    assert sum(a["bytes"] for a in by["batch.copy_in"]) == B * (M + N + 8)
    assert sum(a["bytes"] for a in by["batch.copy_out"]) == \
        B * (12 + 2 * (M + N))
    assert [a["pairs"] for a in by["batch.sweep"]] == [B]
    assert [a["pairs"] for a in by["batch.assemble"]] == [B]
    assert by["batch.stage"] == [{"pairs": B}, {"pairs": B}]


@pytest.mark.parametrize("on", [True, False], ids=["recorded", "off"])
def test_assemble_spans_count_collections(monkeypatch, on):
    """Each batch.assemble span carries its pairs and the collector's
    passes inside it, 0 (the collector is off there); with the switch
    off nothing is recorded and the collector's counts are not read."""
    reads = []
    passes = batch._gc_passes
    monkeypatch.setattr(batch, "_gc_passes",
                        lambda: reads.append(1) or passes())
    if on:
        monkeypatch.setenv("ANYSEQ_TIMING", "1")
    qs, ss = _pairs(10)
    qs.append(b"ACGT" * 80)                 # a second bucket: two chunks
    ss.append(b"ACG")
    pt.align_batch(qs, ss, "local", SC, device="cpu")
    spans = [s for s in profiling.spans() if s.name == "batch.assemble"]
    if on:
        assert [s.attrs for s in spans] == [
            {"pairs": 10, "collections": 0}, {"pairs": 1, "collections": 0}]
        assert len(reads) == 4
    else:
        assert profiling.spans() == [] and reads == []


def test_nested_public_call_is_a_child(timing):
    """align_batch's affine path calls api.align pair by pair: child spans
    of the one call, with its call id."""
    qs, ss = _pairs(3)
    pt.align_batch(qs, ss, "global", ASC, device="cpu")
    spans = profiling.spans()
    assert len({s.call for s in spans}) == 1
    inner = [s for s in spans if s.name == "api.align"]
    assert len(inner) == 3 and all(spans[s.parent].name == "api.align_batch"
                                   for s in inner)


def test_profiler_sees_spans_without_the_switch():
    """Under torch.profiler with the switch off the spans are host events
    that enclose the torch operations of their phase, and nothing is
    recorded."""
    from torch.profiler import ProfilerActivity, profile

    qs, ss = _pairs(6)
    q, s = _long_pair()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.align_batch(qs, ss, "local", SC, device="cpu")
        pt.align(q, s, "global", SC, traceback="hirschberg", device="cpu")
    assert profiling.spans() == []
    events = [(e.time_range.start, e.time_range.end, e.name, e.thread)
              for e in prof.events()]
    names = {e[2] for e in events}
    assert {"api.align_batch", "batch.stage", "batch.copy_in", "batch.sweep",
            "batch.copy_out", "batch.assemble", "api.align",
            "hirschberg.align", "hirschberg.level", "hirschberg.terminals",
            "hirschberg.result", "hirschberg.wait"} <= names
    for phase in ("batch.sweep", "hirschberg.level"):
        for a, b, _, t in (e for e in events if e[2] == phase):
            assert any(e[2] == "aten::cummax" and e[3] == t
                       and a <= e[0] and e[1] <= b for e in events)


def test_timing_log_lines(timing, capsys):
    """TIMING_LOG keeps the JAX package's words, now with ms to three
    places, parsed as the benchmark parses them; each line's number is its
    span's time."""
    q, s = _long_pair()
    hirschberg.TIMING_LOG.clear()
    pt.align(q, s, "semiglobal", SC, traceback="hirschberg", device="cpu")
    log = list(hirschberg.TIMING_LOG)
    assert [ln.split()[0] for ln in log[:2]] == ["fwd", "rev"]
    assert log[-1].startswith("terminals n=")
    assert all(LINE.fullmatch(ln) for ln in log), log
    times = [float(ln.rsplit(" ", 1)[1].removesuffix("ms")) for ln in log]
    levels = [s for s in profiling.spans() if s.name == "hirschberg.level"]
    assert len(levels) == sum(ln.startswith("level") for ln in log) > 0
    assert times[2: 2 + len(levels)] == [round(x.ms, 3) for x in levels]
    assert "[hb] fwd pass " in capsys.readouterr().err
    hirschberg.TIMING_LOG.clear()
    pt.align(q, s, "global", ASC, traceback="hirschberg", device="cpu")
    assert all(LINE.fullmatch(ln) and ln.startswith("aff ")
               for ln in hirschberg.TIMING_LOG)


def test_terminals_span_and_line(timing):
    """The terminal phase keeps its span ``hirschberg.terminals`` (with
    ``stripes``, and ``k7_stripes``: the stripes K7 swept, none on the
    CPU), its chunks' spans and its phase-log line ``terminals n=<stripes>``,
    which the benchmark reads, with the span's time."""
    q, s = _long_pair()
    hirschberg.TIMING_LOG.clear()
    pt.align(q, s, "global", SC, traceback="hirschberg", device="cpu")
    (phase,) = [x for x in profiling.spans()
                if x.name == "hirschberg.terminals"]
    chunks = [x for x in profiling.spans()
              if x.name == "hirschberg.terminal_chunk"]
    n = phase.attrs["stripes"]
    assert phase.attrs == {"stripes": n, "k7_stripes": 0} and n > 0
    assert sum(c.attrs["stripes"] for c in chunks) == n
    assert all(c.parent == phase.index for c in chunks)
    assert hirschberg.TIMING_LOG[-1] == f"terminals n={n} {phase.ms:.3f}ms"


def test_span_cap_counts_dropped(timing, monkeypatch):
    """Past MAX_SPANS nothing more is kept, and ``dropped`` counts what
    was not; clear() forgets both."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    pt.align_batch(*_pairs(8), "local", SC, device="cpu")
    assert len(profiling.spans()) == 5 and profiling.dropped > 0
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped == 0


def _span(name, a, b, parent, call, **attrs):
    s = profiling.Span(name, attrs)
    s.start_ns, s.end_ns = a * 10**6, b * 10**6
    s.parent, s.call = parent, call
    return s


def _synthetic():
    """Two calls, times in ms: a batch call and a construction."""
    return [
        _span("api.align_batch", 0, 100, -1, 1, launches=3),       # 0
        _span("batch.stage", 0, 10, 0, 1, pairs=4),                # 1
        _span("batch.copy_in", 10, 20, 0, 1, bytes=1000),          # 2
        _span("batch.wait", 12, 18, 2, 1),                         # 3
        _span("batch.sweep", 20, 40, 0, 1, pairs=4),               # 4
        _span("batch.copy_out", 40, 60, 0, 1, bytes=500),          # 5
        _span("batch.assemble", 60, 90, 0, 1, pairs=4),            # 6
        _span("api.align", 100, 300, -1, 2, launches=5),           # 7
        _span("hirschberg.align", 100, 300, 7, 2, launches=5),     # 8
        _span("hirschberg.wait", 100, 105, 8, 2),                  # 9
        _span("hirschberg.level", 110, 200, 8, 2, parts=1),        # 10
        _span("hirschberg.wait", 150, 170, 10, 2),                 # 11
        _span("hirschberg.wait", 180, 190, 10, 2),                 # 12
        _span("hirschberg.terminals", 200, 280, 8, 2, stripes=2),  # 13
        _span("hirschberg.terminal_chunk", 200, 280, 13, 2,
              stripes=2),                                          # 14
        _span("hirschberg.wait", 210, 215, 14, 2),                 # 15
        _span("hirschberg.result", 280, 300, 8, 2, bytes=40),      # 16
    ]


# the readers' values on _synthetic(), from the definitions: waits 6 + 20
# and 5 + 20 + 10 + 5 + 20 ms; stage 10 + (10 - 6) ms; levels' waits 20 +
# 10 ms; each over the 2 calls
READINGS = {
    "api.wait_ms_per_call": (26 + 60) / 2,
    "api.host_ms_per_call": ((100 - 26) + (200 - 60)) / 2,
    "kernels.launches_per_call": (3 + 5) / 2,
    "batch.stage_ms_per_call": (10 + 4) / 2,
    "batch.assemble_ms_per_call": 30 / 2,
    "batch.copy_mb_per_call": (1000 + 500) / 1e6 / 2,
    "hirschberg.levels_wait_ms_per_call": (20 + 10) / 2,
}


def _reader(name):
    from benchmark import harness

    return harness._load(ROOT / "benchmark" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(READINGS))
def test_metric_readers(name, monkeypatch):
    """Each new per-layer metric's reader gives the value its definition
    gives on a known span list, and None where there is nothing to read:
    no spans, dropped spans, or a program without spans."""
    read = _reader(name).read
    monkeypatch.setattr(profiling, "_spans", _synthetic())
    assert read(None) == pytest.approx(READINGS[name], rel=1e-12)
    monkeypatch.setattr(profiling, "dropped", 1)
    assert read(None) is None
    monkeypatch.setattr(profiling, "dropped", 0)
    monkeypatch.setattr(profiling, "_spans", [])
    assert read(None) is None
    monkeypatch.setattr(profiling, "_spans", _synthetic())
    monkeypatch.delattr(profiling, "spans")
    assert read(None) is None


def test_metrics_in_a_traced_cpu_run():
    """A traced run of a small reads150.align_batch cell on the CPU
    reports every per-layer metric of the program's spans that
    BENCHMARK.json lists for it, and the bytes its chunk shapes give."""
    import copy

    from benchmark import harness

    cell = copy.deepcopy(harness.load_cell(ROOT, "reads150.align_batch"))
    cell.config["sequences"]["reference_bp"] = 20000
    cell.traffic.update(pairs_per_call=40, pool=2, profile_calls=1)
    result, _ = harness.run_cell(cell, 2**31 + 77, 0.3, True, "cpu")
    assert result["correct"]
    got = result["metrics"]
    for name in READINGS:
        if name != "hirschberg.levels_wait_ms_per_call":
            assert got[name]["value"] >= 0, name
    # 150 bp reads and 350 bp windows: rows of 256 and 512, strings of 768
    want = 40 * ((256 + 512 + 8) + (12 + 2 * 768)) / 1e6
    assert got["batch.copy_mb_per_call"]["value"] == pytest.approx(want)
    assert got["kernels.launches_per_call"]["value"] == 0      # the CPU's
    assert profiling.spans() and not profiling.recording()


class _Clock:
    """time.perf_counter advancing 12.3456 ms a reading."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.0123456
        return self.t


def test_cli_timing_lines(monkeypatch, tmp_path):
    """The CLI's "testing <name> N ms" lines come from profiling.Timer
    and keep their bytes: the name, a space, whole ms, " ms"."""
    monkeypatch.setattr(time, "perf_counter", _Clock())
    out = io.StringIO()
    assert cli._timed("global score", lambda: 7, out) == 7
    assert out.getvalue() == "testing global score 12 ms\n"
    qs, ss = tmp_path / "q.fa", tmp_path / "s.fa"
    qs.write_bytes(b">a\nACGTACGT\n>b\nGATTACA\n")
    ss.write_bytes(b">a\nACGTTCGT\n>b\nGATACA\n")
    for flags, line in ((["--score-only"], "testing batch local score 12 ms"),
                        ([], "testing batch local alignment 12 ms")):
        buf = io.StringIO()
        monkeypatch.setattr("sys.stdout", buf)
        assert cli.main(["-b", str(qs), str(ss), "--mode", "local",
                         "--device", "cpu", *flags]) == 0
        assert line + "\n" in buf.getvalue()


def test_span_inside_profiled_and_recorded_call(timing):
    """With the switch on and a profile active, spans are both recorded
    and host ranges of the profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.align_score(b"ACGTACGTTT", b"ACGTTCGT", "local", SC, device="cpu")
    names = [s.name for s in profiling.spans()]
    assert names == ["api.align_score", "api.wait", "api.wait"]
    assert {"api.align_score", "api.wait"} <= {e.name for e in prof.events()}
