"""Command-line front end, format-compatible with the reference binary: the
port of the JAX package's ``anyseq_tpu/cli.py``, with the same flags and
output lines.

    python -m anyseq_tpu_torch.cli -i <query file> <subject file>
    python -m anyseq_tpu_torch.cli -r [min len] [max len]
    python -m anyseq_tpu_torch.cli -b <queries> <subjects> [--score-only]
    python -m anyseq_tpu_torch.cli --parity <binary or directory>

Reference: src/main.cpp:124-235. ``-i`` and ``-r`` print the same
"testing <name> <N> ms" timing lines for the six API calls
(main.cpp:29-57); ``-b`` aligns record i of one file against record i of
the other through the batch API. ``--device`` (default ``cuda``) is the
device every call runs on; ``--device cpu`` runs the kernels' plain torch
versions. ``--mesh`` is not ported yet and exits with an error.

Deviations from the reference (as in the JAX package): random mode uses
numpy's seeded PCG64 instead of C++'s ``mt19937_64``; ``--mode``,
``--print``, ``--fulltb``, ``--scores`` and ``--affine`` extend it.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _random_string(rng, minlen: int, maxlen: int) -> bytes:
    length = int(rng.integers(minlen, maxlen + 1))
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bytes(alphabet[rng.integers(0, 4, size=length)])


def _timed(name: str, fn, out):
    print(f"testing {name}", end="", flush=True, file=out)
    t0 = time.perf_counter()
    result = fn()
    ms = int(round((time.perf_counter() - t0) * 1000))
    print(f" {ms} ms", file=out)
    return result


def benchmark_alignments(query: bytes, subject: bytes, scoring, out,
                         fulltb: bool = False, do_print: bool = False,
                         device="cuda"):
    """The reference's benchmark_alignments (main.cpp:60-86): three score
    calls then three alignment constructions."""
    import anyseq_tpu_torch as pt
    from anyseq_tpu_torch.io.alignment import print_alignment

    for mode in ("global", "semiglobal", "local"):
        _timed(
            f"{mode} score",
            lambda m=mode: pt.align_score(query, subject, m, scoring,
                                          device=device),
            out,
        )

    traceback = "full" if fulltb else "auto"
    for mode in ("global", "semiglobal", "local"):
        aln = _timed(
            f"{mode} alignment",
            lambda m=mode: pt.align(query, subject, m, scoring,
                                    traceback=traceback, device=device),
            out,
        )
        if do_print:
            print_alignment(aln, file=out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="align",
        description="pairwise sequence alignment on a CUDA card "
                    "(anyseq_tpu_torch)",
    )
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument(
        "-i", "--in", dest="files", nargs=2, metavar=("QUERY", "SUBJECT"),
        help="read sequences from input files (first record each)",
    )
    group.add_argument(
        "-r", "--rand", dest="rand", nargs="*", type=int, metavar="LEN",
        help="generate random input sequences [min len] [max len]",
    )
    group.add_argument(
        "-b", "--batch", dest="batch", nargs=2,
        metavar=("QUERIES", "SUBJECTS"),
        help="align ALL records of two files pairwise (record i vs "
             "record i) through the batch API",
    )
    group.add_argument(
        "--parity", metavar="REF",
        help="diff a real reference binary (or a directory of recorded "
             "`align -r` outputs) against the committed golden corpus "
             "(tests/golden/); see anyseq_tpu_torch/parity.py",
    )
    parser.add_argument(
        "--score-only", action="store_true",
        help="batch mode: report scores without constructing alignments",
    )
    parser.add_argument(
        "--mesh", action="store_true",
        help="distribute over all visible devices (not ported yet)",
    )
    parser.add_argument(
        "--mode", choices=["all", "global", "semiglobal", "local"],
        default="all", help="restrict to one alignment scheme",
    )
    parser.add_argument(
        "--scores", nargs=3, type=int, metavar=("MATCH", "MISMATCH", "GAP"),
        default=[2, -1, -1],
        help="linear scoring parameters (reference hard-codes 2 -1 -1)",
    )
    parser.add_argument(
        "--affine", nargs=2, type=int, metavar=("GAP_OPEN", "GAP_EXTEND"),
        default=None,
        help="use affine (Gotoh) gap scoring instead of linear",
    )
    parser.add_argument("--fulltb", action="store_true",
                        help="use full-matrix traceback instead of Hirschberg")
    parser.add_argument("--print", dest="do_print", action="store_true",
                        help="print the constructed alignments")
    parser.add_argument("--seed", type=int, default=0,
                        help="random-mode seed (deterministic by default)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu "
                             "runs the kernels' plain torch versions)")
    args = parser.parse_args(argv)

    out = sys.stdout

    from anyseq_tpu_torch.core.types import AffineScoring, LinearScoring

    if args.affine is not None:
        scoring = AffineScoring(args.scores[0], args.scores[1],
                                args.affine[0], args.affine[1])
    else:
        scoring = LinearScoring(*args.scores)

    if args.mesh:
        print("--mesh: multi-device runs are not ported yet (ROADMAP "
              "queue 1, item 12)", file=sys.stderr)
        return 2

    if args.parity:
        from anyseq_tpu_torch.parity import run_parity

        return run_parity(args.parity, out)

    if args.batch:
        from anyseq_tpu_torch.io.fasta import make_sequence_reader

        qf, sf = args.batch
        try:
            qs = [r.data for r in make_sequence_reader(qf) if r.data]
            ss = [r.data for r in make_sequence_reader(sf) if r.data]
        except Exception as e:
            print(str(e), file=sys.stderr)
            return 1
        npairs = min(len(qs), len(ss))
        if npairs == 0:
            print("no records", file=sys.stderr)
            return 1
        qs, ss = qs[:npairs], ss[:npairs]
        mode = args.mode if args.mode != "all" else "global"
        print(f"batch: {npairs} pairs, mode {mode}", file=out)
        import anyseq_tpu_torch as pt

        if args.score_only:
            t0 = time.perf_counter()
            scores = pt.align_scores_batch(qs, ss, mode, scoring,
                                           device=args.device)
            ms = int(round((time.perf_counter() - t0) * 1000))
            print(f"testing batch {mode} score {ms} ms", file=out)
            for i, sc_ in enumerate(scores):
                print(f"pair {i}: score {int(sc_)}", file=out)
        else:
            from anyseq_tpu_torch.io.alignment import print_alignment

            t0 = time.perf_counter()
            alns = pt.align_batch(qs, ss, mode, scoring, device=args.device)
            ms = int(round((time.perf_counter() - t0) * 1000))
            print(f"testing batch {mode} alignment {ms} ms", file=out)
            for i, aln in enumerate(alns):
                print(f"pair {i}: score {aln.score}", file=out)
                if args.do_print:
                    print_alignment(aln, file=out)
        return 0

    if args.files:
        from anyseq_tpu_torch.io.fasta import read_first_sequence

        qf, sf = args.files
        print(f"input sequences: {qf}, {sf}", file=out)
        try:
            query = read_first_sequence(qf)
            subject = read_first_sequence(sf)
        except Exception as e:  # reference prints and continues (main.cpp:191)
            print(str(e), file=sys.stderr)
            return 1
    else:
        rand = args.rand if args.rand else []
        minlen = rand[0] if len(rand) > 0 else 256
        maxlen = rand[1] if len(rand) > 1 else 1024
        if minlen < 1 or maxlen < 1:
            print("String lengths must be greater than zero!", file=sys.stderr)
            return 1
        if maxlen < minlen:
            minlen, maxlen = maxlen, minlen
        print(f"random strings with length from [{minlen},{maxlen}]", file=out)
        rng = np.random.default_rng(args.seed)
        query = _random_string(rng, minlen, maxlen)
        subject = _random_string(rng, minlen, maxlen)

    print(f"sequence lengths: {len(query)}, {len(subject)}", file=out)

    if args.mode == "all":
        benchmark_alignments(query, subject, scoring, out, args.fulltb,
                             args.do_print, device=args.device)
    else:
        import anyseq_tpu_torch as pt
        from anyseq_tpu_torch.io.alignment import print_alignment

        _timed(f"{args.mode} score",
               lambda: pt.align_score(query, subject, args.mode, scoring,
                                      device=args.device),
               out)
        aln = _timed(
            f"{args.mode} alignment",
            lambda: pt.align(query, subject, args.mode, scoring,
                             traceback="full" if args.fulltb else "auto",
                             device=args.device),
            out,
        )
        if args.do_print:
            print_alignment(aln, file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
