"""The command exits non-zero and prints no result where it cannot
measure: no card (it never falls back to the CPU), or a checkout that
holds only the benchmark and not the program."""
import shutil
import subprocess
import sys

import pytest

ARGS = ["--workload", "contig100k.score", "--seed", "3", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_no_card_no_result(root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(root)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_benchmark_alone_no_result(tmp_path, root):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
