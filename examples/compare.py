"""Score comparison against external oracle TSVs (reference: examples/compare.rs).

Reads tab-separated (query, reference, score) files produced by external
aligner benchmarks (the reference uses TSVs from the adaptivebandbench and
diff-bench repositories) and reports agreement of this block aligner and
of a plain full-DP run against the recorded scores.

Usage: python examples/compare.py data/scores.tsv [--nuc] [--min 32] [--max 256]
"""

import argparse
import sys

from common import *  # noqa: F401,F403 (path setup)

from block_aligner_jax import BLOSUM62, BatchAligner, Gaps, NucMatrix
from block_aligner_jax.core.full_dp import global_align_score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tsv")
    ap.add_argument("--nuc", action="store_true")
    ap.add_argument("--min", type=int, default=32)
    ap.add_argument("--max", type=int, default=256)
    ap.add_argument("--gap-open", type=int, default=None)
    ap.add_argument("--gap-extend", type=int, default=None)
    args = ap.parse_args()

    if args.nuc:
        matrix = NucMatrix.new_simple(1, -1)
        gaps = Gaps(args.gap_open or -2, args.gap_extend or -1)
    else:
        matrix = BLOSUM62
        gaps = Gaps(args.gap_open or -11, args.gap_extend or -1)

    rows = []
    with open(args.tsv) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            rows.append((parts[0].encode(), parts[1].encode(), int(parts[2])))
    if not rows:
        print("no rows parsed; expected TSV of query<TAB>reference<TAB>score")
        sys.exit(1)

    max_len = max(max(len(q), len(r)) for q, r, _ in rows)
    al = BatchAligner(matrix, gaps, (args.min, args.max), batch=256,
                      seq_cap=max_len + 32)
    res = al.align_all([(q, r) for q, r, _ in rows])

    agree = 0
    dp_agree = 0
    for (q, r, want), got in zip(rows, res):
        if got.score == want:
            agree += 1
        if global_align_score(q, r, matrix, gaps) == want:
            dp_agree += 1
    print(f"total {len(rows)}: block-aligner agrees {agree}, "
          f"exact full-DP agrees {dp_agree}")


if __name__ == "__main__":
    main()
