"""Tests of the benchmark itself (not collected by ``pytest tests/``):

    python3 -m pytest benchmark/tests -q

Tests marked ``chip`` need a CUDA device; they decide that inside the
test and skip on a machine without one.
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def small_cell():
    return _small_cell


def _small_cell(name: str, pairs: int = 24, length: int = 300):
    """The cell `name` of the repository's BENCHMARK.json, cut to a size
    the CPU runs in seconds: `pairs` pairs a batch over a pool of 2, or
    pairs of `length` bp."""
    from benchmark import harness

    cell = harness.load_cell(ROOT, name)
    cell = copy.deepcopy(cell)
    seq = cell.config["sequences"]
    if seq["class"] == "related_pair":
        seq["length"] = length
    else:
        seq["reference_bp"] = 20000
        cell.traffic["pairs_per_call"] = pairs
        cell.traffic["pool"] = 2
    cell.traffic["profile_calls"] = 2
    return cell
