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


def test_new_files_make_a_new_cell(tmp_path, root):
    base = tmp_path / "benchmark"
    shutil.copytree(root / "benchmark", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())

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
