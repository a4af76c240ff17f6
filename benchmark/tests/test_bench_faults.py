"""A run with the timed path broken underneath comes out as not correct.

Each test skips the harness's look for a chip and drives the rest of a
run on the CPU at a small size (the port's CPU path runs its kernels'
plain versions), once sound and once with a fault planted in the program
where its answers are produced: half of a batch left out, a score
altered, a constructed alignment's symbol altered. (The cells have no
state carried between steps and no exchange between chips.)"""
import numpy as np
import pytest
import torch

from benchmark import harness

CELLS = ["contig100k.align", "reads150.align_batch", "contig100k.score",
         "reads150.scores_batch"]


@pytest.fixture
def hirschberg_at_small_sizes(monkeypatch):
    """`align` takes the Hirschberg construction at any size, as it does
    above 2^22 cells."""
    from anyseq_tpu_torch.engine import api

    monkeypatch.setattr(api, "FULL_TB_MAX_CELLS", 0)


def _run(cell, seed=2**32 + 17):
    return harness.run_cell(cell, seed, 0.3, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, hirschberg_at_small_sizes, name):
    result, checks = _run(small_cell(name))
    assert result["correct"], checks
    assert all(c["value"] == 0 for c in checks.values())


@pytest.mark.parametrize("name", ["reads150.align_batch",
                                  "reads150.scores_batch"])
def test_half_the_batch_left_out(small_cell, monkeypatch, name):
    import anyseq_tpu_torch as pt

    entry = {"reads150.align_batch": "align_batch",
             "reads150.scores_batch": "align_scores_batch"}[name]
    whole = getattr(pt, entry)

    def half(queries, subjects, *args, **kwargs):
        k = len(queries) // 2
        return whole(queries[:k], subjects[:k], *args, **kwargs)

    monkeypatch.setattr(pt, entry, half)
    result, checks = _run(small_cell(name))
    assert not result["correct"] and checks["missing"]["value"] > 0


def _plus_one_at(monkeypatch, module, name, first_only=True):
    """Wrap `module.name` (which returns a score tensor, or a tuple whose
    first member is one) so that the first score comes out one higher."""
    original = getattr(module, name)

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        scores = out[0] if isinstance(out, tuple) else out
        scores = scores.clone()
        scores.view(-1)[0] += 1
        return (scores, *out[1:]) if isinstance(out, tuple) else scores

    monkeypatch.setattr(module, name, altered)


@pytest.mark.parametrize("name", CELLS)
def test_a_score_altered_where_it_is_produced(small_cell, monkeypatch,
                                              hirschberg_at_small_sizes,
                                              name):
    from anyseq_tpu_torch.engine import batch, linmem

    if name.startswith("reads150"):
        _plus_one_at(monkeypatch, batch, "extract_batch")
    else:
        _plus_one_at(monkeypatch, linmem, "extract_end")
    if name == "contig100k.align":
        # the construction holds its forward score to its reverse one and
        # raises: the run ends in its set-up, with no result
        with pytest.raises(RuntimeError, match="endpoint reduction"):
            _run(small_cell(name))
        return
    result, checks = _run(small_cell(name))
    assert not result["correct"] and checks["score_mismatch"]["value"] > 0


def _one_symbol_altered(monkeypatch, module, name):
    """Wrap `module.name` (which returns out_q, out_s, ...) so that the
    first walked query symbol comes out altered."""
    original = getattr(module, name)

    def altered(*args, **kwargs):
        out_q, *rest = original(*args, **kwargs)
        out_q = out_q.clone()
        flat = out_q.view(-1)
        k = int(torch.nonzero((flat != ord(" ")) & (flat != ord("_")))[0])
        flat[k] = ord("A") if int(flat[k]) != ord("A") else ord("C")
        return (out_q, *rest)

    monkeypatch.setattr(module, name, altered)


@pytest.mark.parametrize("name", ["contig100k.align",
                                  "reads150.align_batch"])
def test_a_symbol_altered_where_it_is_produced(small_cell, monkeypatch,
                                               hirschberg_at_small_sizes,
                                               name):
    if name == "contig100k.align":
        from anyseq_tpu_torch.engine import batch

        _one_symbol_altered(monkeypatch, batch, "preds_walk_batch")
    else:
        from anyseq_tpu_torch.kernels import walk

        _one_symbol_altered(monkeypatch, walk, "walk")
    result, checks = _run(small_cell(name))
    assert not result["correct"]
    assert checks["invalid_alignment"]["value"] > 0


def test_a_failed_call_is_not_correct(small_cell, monkeypatch):
    import anyseq_tpu_torch as pt

    whole, calls = pt.align_score, []

    def broken(*args, **kwargs):
        calls.append(1)
        if len(calls) > 3:                # past the set-up's warm calls
            raise RuntimeError("planted")
        return whole(*args, **kwargs)

    monkeypatch.setattr(pt, "align_score", broken)
    result, checks = _run(small_cell("contig100k.score"))
    assert not result["correct"] and result["failed"] > 0
    assert np.isfinite(checks["failed_calls"]["value"])
