"""The control: the plain reference in the narrower integer type that each
configuration names, handed to the comparison that decides ``correct``,
comes out as not correct."""
import pytest

from benchmark import check, control, harness


def test_int8_control_fails_short_reads(small_cell):
    cell = small_cell("reads150.scores_batch", pairs=64)
    assert cell.config["control"]["dtype"] == "int8"
    counts = control.control_counts(cell, 21, "cpu")
    assert counts["score_mismatch"] > 0 and not check.passed(counts)


BWA = {"kind": "affine", "match": 1, "mismatch": -4, "gap_open": -6,
       "gap_extend": -1}


@pytest.mark.parametrize("name", ["reads150.align_batch",
                                  "reads150.scores_batch"])
def test_int8_control_fails_affine_reads(small_cell, monkeypatch, name):
    """bwa mem's affine scoring on the same reads: a 150 bp read scores up
    to 150, past int8's 127."""
    cell = small_cell(name, pairs=64)
    monkeypatch.setitem(cell.config, "scoring", BWA)
    assert cell.config["control"]["dtype"] == "int8"
    counts = control.control_counts(cell, 24, "cpu")
    assert counts["score_mismatch"] > 0 and not check.passed(counts)


def test_int32_in_the_controls_place_is_correct_affine(small_cell,
                                                       monkeypatch):
    cell = small_cell("reads150.align_batch", pairs=64)
    monkeypatch.setitem(cell.config, "scoring", BWA)
    monkeypatch.setitem(cell.config, "control", {"dtype": "int32"})
    counts = control.control_counts(cell, 25, "cpu")
    assert check.passed(counts), counts


def test_int16_control_fails_long_pairs(small_cell):
    """Scores pass 32,767 from ~26 kbp on; a pool of two 27 kbp pairs."""
    cell = small_cell("contig100k.align", length=27_000)
    assert cell.config["control"]["dtype"] == "int16"
    counts = control.control_counts(cell, 22, "cpu")
    assert counts["score_mismatch"] == 2 and counts["end_mismatch"] > 0
    assert counts["invalid_alignment"] == 0 and not check.passed(counts)


def test_int32_in_the_controls_place_is_correct(small_cell, monkeypatch):
    """The same path with the reference's own type passes: what fails the
    control is its type alone."""
    cell = small_cell("contig100k.align", length=2_000)
    monkeypatch.setitem(cell.config, "control", {"dtype": "int32"})
    counts = control.control_counts(cell, 23, "cpu")
    assert check.passed(counts), counts


@pytest.mark.chip
@pytest.mark.parametrize("name", ["contig100k.align", "reads150.align_batch",
                                  "contig100k.score",
                                  "reads150.scores_batch"])
def test_control_fails_every_cell_at_its_size(cuda_device, root, name):
    cell = harness.load_cell(root, name)
    for seed in (31, 32, 33):
        counts = control.control_counts(cell, seed, cuda_device)
        assert counts["score_mismatch"] > 0, (seed, counts)
        assert not check.passed(counts), (seed, counts)
