"""Two-sequence debug CLI (reference: examples/debug.rs).

Aligns two sequences, prints the score, CIGAR, and the rendered alignment,
plus the exact-oracle score for comparison.

Usage: python examples/debug.py QUERY REFERENCE [--nuc] [--min 32] [--max 256]
"""

import argparse

from common import *  # noqa: F401,F403 (path setup)

from block_aligner_jax import (
    BLOSUM62,
    BlockOracle,
    Gaps,
    NucMatrix,
    PaddedBytes,
)
from block_aligner_jax.core.full_dp import global_align_score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("query")
    ap.add_argument("reference")
    ap.add_argument("--nuc", action="store_true")
    ap.add_argument("--min", type=int, default=32)
    ap.add_argument("--max", type=int, default=256)
    args = ap.parse_args()

    q = args.query.encode()
    r = args.reference.encode()
    if args.nuc:
        matrix = NucMatrix.new_simple(1, -1)
        gaps = Gaps(open=-2, extend=-1)
    else:
        matrix = BLOSUM62
        gaps = Gaps(open=-11, extend=-1)

    a = BlockOracle(trace=True)
    pq = PaddedBytes.from_bytes(q, args.max, matrix)
    pr = PaddedBytes.from_bytes(r, args.max, matrix)
    a.align(pq, pr, matrix, gaps, (args.min, args.max), 0)
    res = a.res()
    cig = a.cigar_eq(pq, pr, res.query_idx, res.reference_idx)
    top, bot = cig.format(q, r)
    print(f"score: {res.score}  end: ({res.query_idx}, {res.reference_idx})")
    print(f"cigar: {cig}")
    print(top)
    print(bot)
    print(f"exact full-DP score: {global_align_score(q, r, matrix, gaps)}")


if __name__ == "__main__":
    main()
