"""X-drop score and end-position accuracy vs the exact full-DP x-drop oracle.

Port of the reference program (reference: examples/x_drop_accuracy.rs):
the oracle is the scalar full-DP x-drop alignment (reference slow_align,
examples/x_drop_accuracy.rs:109-160), x_drop = 50, block sizes 32..64.

Usage: python examples/x_drop_accuracy.py [--iters 100] [--len 300]
"""

import argparse

import numpy as np

from common import DNA, rand_mutate, rand_seq

from block_aligner_jax import BatchAligner, Gaps, NucMatrix
from block_aligner_jax.core.full_dp import x_drop_score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--len", type=int, dest="length", default=300)
    args = ap.parse_args()

    matrix = NucMatrix.new_simple(1, -1)
    gaps = Gaps(open=-2, extend=-1)
    x = 50
    rng = np.random.default_rng(1234)

    pairs = []
    for _ in range(args.iters):
        q = rand_seq(rng, DNA, args.length)
        r = rand_mutate(rng, q, args.length // 10, DNA)
        pairs.append((q, r))

    al = BatchAligner(matrix, gaps, size=(32, 64), batch=128,
                      seq_cap=args.length + args.length // 8 + 32, x_drop=x)
    res = al.align_all(pairs)

    wrong_score = 0
    wrong_pos = 0
    for (q, r), got in zip(pairs, res):
        ws, wi, wj = x_drop_score(q, r, matrix, gaps, x)
        if got.score != ws:
            wrong_score += 1
        elif (got.query_idx, got.reference_idx) != (wi, wj):
            wrong_pos += 1
    print(f"wrong score: {wrong_score} / {args.iters}, "
          f"wrong end position: {wrong_pos} / {args.iters}")
    print("Done!")


if __name__ == "__main__":
    main()
