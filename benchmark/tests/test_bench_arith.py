"""The arithmetic of the bound, the idle share, the rates and the
spreads, on fixed numbers."""
import pytest

from benchmark import bound, harness, spread, trace
from benchmark.harness import Run


def _reader(folder, name):
    return harness._load(harness.HERE / folder / f"{name}.py").read


def test_peak_is_the_data_sheets():
    assert bound.PEAK_INT32_OPS == pytest.approx(132 * 64 * 1.98e9)
    assert bound.ops_per_cell("local", {"kind": "linear"}) == 5.5
    assert bound.ops_per_cell("semiglobal", {"kind": "linear"}) == 5
    assert bound.ops_per_cell("global", {"kind": "affine"}) == 7


def test_bound_takes_the_larger_time():
    # 10^10 cells at 5 ops: 2.99 ms of operations, 200 kB: 60 ns of bytes
    t, what = bound.bound_seconds(5e10, 2e5)
    assert what == "operations" and t == pytest.approx(5e10 / 16.72704e12)
    t, what = bound.bound_seconds(1.0, 3.35e9)
    assert what == "bytes" and t == pytest.approx(1e-3)


def test_work_counts_cells_walk_steps_and_bytes():
    class A:
        query_aligned = b" AC_G "
        subject_aligned = b" A_TG "

    from benchmark.inputs import Item

    item = Item([b"ACG"], [b"ATG"], 9)
    ops, nbytes = harness._work(item, [A()], "alignment", 5.5)
    assert ops == 9 * 5.5 + 4 * bound.WALK_STEP
    assert nbytes == 6 + 2 * 6 + 12
    ops, nbytes = harness._work(item, [7], "score", 5)
    assert (ops, nbytes) == (45, 6 + 8)


def _summary():
    # two calls over 0-300 us; kernels 10-30 (two overlapping) and 200-250,
    # a copy 50-60; the host is in aten::cat over 110-190
    dev = [(10, 20, "k1", True), (15, 30, "k2", True),
           (50, 60, "Memcpy DtoH", False), (200, 250, "k1", True)]
    host = [(0, 100, trace.CALL_SPAN, 1), (30, 50, "aten::add", 1),
            (35, 45, "cudaLaunchKernel", 1), (100, 300, trace.CALL_SPAN, 1),
            (110, 190, "aten::cat", 1), (0, 300, "another thread", 2)]
    return trace.summarize(dev, host, 2)


def test_idle_and_busy():
    s = _summary()
    assert s.window_s == pytest.approx(300e-6)
    assert s.busy_s == pytest.approx(80e-6)          # 10-30, 50-60, 200-250
    assert s.kernel_s == pytest.approx(75e-6)        # 10 + 15 + 50
    assert s.device_ops == 4
    assert _reader("metrics", "engine.device_ops_per_call")(
        Run(cell=None, profile=s)) == 2


def test_idle_over_the_windows_time_a_call():
    """A trace of the device's activity alone: busy time is the union of
    its intervals; the idle share divides it, a call, by the window's
    time a call, not by the traced calls' own wall."""
    dev = [(10, 20, "k1", True), (15, 30, "k2", True),
           (50, 60, "Memcpy DtoH", False), (200, 250, "k1", True)]
    s = trace.device_summary(dev, 2, 400e-6)
    assert (s.window_s, s.busy_s, s.kernel_s, s.device_ops) == (
        400e-6, pytest.approx(80e-6), pytest.approx(75e-6), 4)
    assert s.idle_by_host == {}
    # 40 us busy a traced call; the window took 100 us a call
    run = Run(cell=None, profile=s, calls=5, window_s=500e-6)
    assert _reader("metrics", "device.idle_pct")(run) == pytest.approx(60)
    assert _reader("metrics", "device.idle_pct")(
        Run(cell=None, profile=s)) is None


def test_idle_gaps_are_named_by_the_innermost_host_op():
    gaps = dict(_summary().breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"python before aten::add": 10e-6,
                                  "cudaLaunchKernel": 20e-6,
                                  "aten::cat": 140e-6,
                                  "benchmark.call": 50e-6})


def test_rooflines():
    s = _summary()
    run = Run(cell=None, profile=s,
              profiled_ops=0.5 * 75e-6 * bound.PEAK_INT32_OPS,
              profiled_bytes=10)
    assert _reader("metrics", "kernels_roofline")(run) == pytest.approx(50)


def test_gcups_counts_the_whole_window():
    run = Run(cell=None, calls=3, cells_done=3 * 10**10,
              window_s=1.5)
    assert _reader("end_to_end", "gcups")(run) == pytest.approx(20)
    assert _reader("end_to_end", "gcups")(Run(cell=None)) is None


def test_readers_find_nothing_without_a_trace():
    run = Run(cell=None)
    for name in ("device.idle_pct", "kernels_roofline",
                 "engine.device_ops_per_call", "device.peak_mem_gib",
                 "hirschberg.levels_ms_per_call",
                 "hirschberg.terminals_ms_per_call"):
        assert _reader("metrics", name)(run) is None


def test_hirschberg_spans():
    run = Run(cell=None, timing_logs=[
        ["fwd pass 33ms", "level P=1 maxh=9 maxmid=4 path=per-half 42ms",
         "level P=2 maxh=5 maxmid=2 path=batched 8ms", "terminals n=4 100ms"],
        ["fwd pass 30ms", "level P=1 maxh=9 maxmid=4 path=per-half 40ms",
         "terminals n=4 110ms"]])
    assert _reader("metrics", "hirschberg.levels_ms_per_call")(run) == 45
    assert _reader("metrics", "hirschberg.terminals_ms_per_call")(run) == 105


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [10, 11, 12, 13, 14, 15]
    q1, _, q3 = 10.75, 12.5, 14.25       # statistics.quantiles, exclusive
    assert spread.spread(vals) == pytest.approx((q3 - q1) / 12.5)
