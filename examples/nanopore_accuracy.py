"""Long-read (Nanopore-style) global alignment accuracy.

Port of the reference program (reference: examples/nanopore_accuracy.rs):
real or simulated long DNA pairs, NucMatrix(2, -4) scores with gaps -6/-2,
adaptive block sizes percent_len(max_len, 1%)..=10%, compared against the
exact full-DP oracle for pairs < 15kbp and a fixed-8192-block run otherwise.

Usage: python examples/nanopore_accuracy.py [--pairs 100] [--max-len 10000]
"""

import argparse
import time

import numpy as np

from common import load_nanopore_pairs

from block_aligner_jax import BatchAligner, Gaps, NucMatrix, percent_len
from block_aligner_jax.core.full_dp import global_align_score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--max-len", type=int, default=10000)
    ap.add_argument("--dataset", default="seq_pairs.10kbps.5000")
    args = ap.parse_args()

    matrix = NucMatrix.new_simple(2, -4)
    gaps = Gaps(open=-6, extend=-2)
    pairs = load_nanopore_pairs(args.dataset, n_pairs=args.pairs,
                                max_len=args.max_len)
    max_len = max(max(len(q), len(r)) for q, r in pairs)
    min_size = percent_len(max_len, 0.01)
    max_size = percent_len(max_len, 0.10)
    print(f"# {len(pairs)} pairs, max len {max_len}, "
          f"sizes {min_size}..{max_size}")

    # whole sequences stay in device memory at any length
    seq_cap = max_len + max_len // 8 + 64
    al = BatchAligner(matrix, gaps, size=(min_size, max_size),
                      batch=min(64, len(pairs)), seq_cap=seq_cap)
    al.align_batch(pairs[: al.batch_size])  # compile
    t0 = time.perf_counter()
    res = al.align_all(pairs)
    dt = time.perf_counter() - t0

    wrong = 0
    total_err = 0
    for (q, r), got in zip(pairs, res):
        want = global_align_score(q, r, matrix, gaps)
        if got.score != want:
            wrong += 1
            total_err += want - got.score
    print(f"wrong: {wrong} / {len(pairs)} "
          f"(avg err {total_err / wrong if wrong else 0:.2f}), "
          f"{dt:.2f}s ({dt / len(pairs) * 1e3:.2f} ms/pair)")


if __name__ == "__main__":
    main()
