"""A configuration, a traffic mix, a cell and a metric are added by new
files and new entries of BENCHMARK.json alone: no file that is there
changes."""
import json
import shutil

from benchmark import harness

NEW_METRIC = '''
def read(run):
    return float(run.calls) if run.calls else None
'''


def _copy(tmp_path, root):
    """(the copy's benchmark folder, its files' bytes, BENCHMARK.json)."""
    base = tmp_path / "benchmark"
    shutil.copytree(root / "benchmark", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    return base, before, json.loads((root / "BENCHMARK.json").read_text())


def test_new_files_make_a_new_cell(tmp_path, root):
    base, before, spec = _copy(tmp_path, root)

    config = json.loads((base / "configs" / "reads150.json").read_text())
    config.update(name="reads100", read_length=100)
    config["sequences"].update(read_length=100, trimmed_lengths=[50, 99],
                               reference_bp=20000)
    (base / "configs" / "reads100.json").write_text(json.dumps(config))
    (base / "traffic" / "scores_batch.tiny.json").write_text(json.dumps(
        {"entry": "align_scores_batch", "pool": 2, "pairs_per_call": 16,
         "profile_calls": 2, "checked_calls": "all"}))
    (base / "metrics" / "calls.done.py").write_text(NEW_METRIC)
    spec["configs"].append({"name": "reads100", "source": "a test",
                            "file": "benchmark/configs/reads100.json",
                            "reduced": ["read_length"], "why": "a test"})
    spec["workloads"].append({"name": "reads100.scores_batch",
                              "config": "reads100",
                              "traffic": "scores_batch.tiny", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "calls.done", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "public API", "moves": "gcups",
                              "workloads": ["reads100.scores_batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell(tmp_path, "reads100.scores_batch", base=base)
    assert cell.config["read_length"] == 100
    assert "calls.done" in [m["name"] for m in cell.per_layer]
    result, checks = harness.run_cell(cell, 2**33 + 5, 0.3, True, "cpu")
    assert result["correct"] and result["metrics"]["calls.done"]["value"] > 0
    # the cells that were there do not see the new metric
    old = harness.load_cell(tmp_path, "reads150.scores_batch", base=base)
    assert "calls.done" not in [m["name"] for m in old.per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_new_files_make_an_affine_cell(tmp_path, root):
    """bwa mem's affine scoring (a=1, b=4, o=6, e=1: a gap of k costs -6 -
    k) on reads150's reads, at a size the CPU runs: a configuration and a
    traffic mix added as files, the cell as entries, and the run compares
    its scores, end cells and alignments with the affine reference."""
    base, before, spec = _copy(tmp_path, root)
    config = json.loads((base / "configs" / "reads150.json").read_text())
    config.update(name="reads150_bwa", scoring={
        "kind": "affine", "match": 1, "mismatch": -4, "gap_open": -6,
        "gap_extend": -1})
    config["sequences"].update(reference_bp=20000)
    (base / "configs" / "reads150_bwa.json").write_text(json.dumps(config))
    (base / "traffic" / "align_batch.bwa_affine.tiny.json").write_text(
        json.dumps({"entry": "align_batch", "pool": 2, "pairs_per_call": 8,
                    "profile_calls": 1, "checked_calls": "all"}))
    spec["configs"].append({"name": "reads150_bwa", "source": "a test",
                            "file": "benchmark/configs/reads150_bwa.json",
                            "reduced": ["reference_bp"], "why": "a test"})
    spec["workloads"].append({"name": "reads150_bwa.align_batch",
                              "config": "reads150_bwa",
                              "traffic": "align_batch.bwa_affine.tiny",
                              "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell(tmp_path, "reads150_bwa.align_batch", base=base)
    result, checks = harness.run_cell(cell, 2**33 + 6, 0.3, True, "cpu")
    assert result["correct"], checks
    assert set(checks) == {"failed_calls", "missing", "score_mismatch",
                           "end_mismatch", "invalid_alignment"}
    assert all(c["value"] == 0 for c in checks.values())
    assert result["window"]["calls"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
