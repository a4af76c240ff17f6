"""The inputs a cell makes from its seed."""
import hashlib
import json

import numpy as np
import pytest

from benchmark import inputs

SEEDS = [0, 7, -5, 2**31 + 12345, 3 * 2**40 + 1]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["contig100k.align", "reads150.align_batch"])
def test_same_seed_same_bytes(small_cell, cell, seed):
    c = small_cell(cell)
    a = inputs.make_pool(c.config, c.traffic, seed)
    b = inputs.make_pool(c.config, c.traffic, seed)
    assert [(x.queries, x.subjects, x.cells) for x in a] == [
        (x.queries, x.subjects, x.cells) for x in b]


def test_other_seed_other_bytes_same_work(small_cell):
    c = small_cell("reads150.scores_batch", pairs=200)
    a = inputs.make_pool(c.config, c.traffic, 1)
    b = inputs.make_pool(c.config, c.traffic, 2)
    assert a[0].queries != b[0].queries
    # every seed has the same multiset of read lengths, so the same cells
    # a batch unless an indel moved a read past its source
    assert sorted(map(len, a[0].subjects)) == sorted(map(len, b[0].subjects))
    assert abs(a[0].cells - b[0].cells) <= 0.001 * a[0].cells


def test_reads_follow_the_configuration(small_cell):
    c = small_cell("reads150.align_batch", pairs=1000)
    spec = c.config["sequences"]
    item = inputs.make_pool(c.config, c.traffic, 5)[0]
    lens = np.array([len(q) for q in item.queries])
    assert (lens == spec["read_length"]).all()
    # the window is the read's span and a flank on each side
    assert all(len(s) == n + 2 * spec["flank"]
               for s, n in zip(item.subjects, lens))
    # a read lies in its window: 2% substitutions leave most of it
    hits = sum(q[:20] in s or q[-20:] in s
               for q, s in zip(item.queries, item.subjects))
    assert hits > 0.9 * len(lens)


def test_trimmed_reads_spread_evenly():
    lens = inputs.read_lengths(1000, 150, 0.9, (75, 149))
    assert (lens == 150).sum() == 900
    assert lens[900:].min() == 75 and lens[900:].max() == 149
    assert (inputs.read_lengths(10, 150) == 150).all()


def test_related_pair_is_chip_smokes():
    """The frozen copy gives what the bring-up checks' generator gives:
    the digest of its pair for seed 0, taken from chip_smoke.py's
    related_pair when the copy was made."""
    q, s = inputs.related_pair(np.random.default_rng(0), 1000)
    assert hashlib.sha256(q + b"|" + s).hexdigest() == (
        "8b0a33dc1af8a16cf4925759bad1ef30d8b7e80c4181d782f5e1017a657020c1")


@pytest.mark.parametrize("name", ["contig100k", "reads150"])
def test_config_files_hold_what_benchmark_json_says(name, root):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}[name]
    config = json.loads((root / entry["file"]).read_text())
    assert config["name"] == name and config["source"] == entry["source"]
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
