"""Random-pair accuracy vs the exact full-DP oracle.

Port of the reference accuracy harness (reference: examples/accuracy.rs):
random DNA/protein pairs with k in {len/10, len/5, len/2} mutations, global
alignment with block-size ranges, compared against an exact
Needleman-Wunsch-Gotoh oracle (the rust-bio role, here native C++ full DP).

Usage: python examples/accuracy.py [--lens 100,1000] [--iters 100]
"""

import argparse
import sys
import time

import numpy as np

from common import AA, DNA, rand_mutate, rand_seq

from block_aligner_jax import BLOSUM62, BatchAligner, Gaps, NucMatrix
from block_aligner_jax.core.full_dp import global_align_score


def run(alpha, matrix, gaps, lens, iters, sizes):
    rng = np.random.default_rng(1234)
    total_wrong = 0
    for length in lens:
        for k_div in (10, 5, 2):
            k = length // k_div
            pairs = []
            for _ in range(iters):
                q = rand_seq(rng, alpha, length)
                r = rand_mutate(rng, q, k, alpha)
                pairs.append((q, r))
            for (mn, mx) in sizes:
                al = BatchAligner(
                    matrix, gaps, size=(mn, mx),
                    batch=min(len(pairs), 256),
                    seq_cap=length + k + 32,
                )
                t0 = time.perf_counter()
                res = al.align_all(pairs)
                dt = time.perf_counter() - t0
                wrong = 0
                worst = 0
                for (q, r), got in zip(pairs, res):
                    want = global_align_score(q, r, matrix, gaps)
                    if got.score != want:
                        wrong += 1
                        worst = max(worst, abs(want - got.score))
                total_wrong += wrong
                print(
                    f"len {length}, k {k}, size {mn}-{mx}: wrong {wrong} / "
                    f"{iters} (max err {worst}), {dt:.3f}s"
                )
    return total_wrong


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lens", default="100,1000")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    lens = [int(x) for x in args.lens.split(",")]

    print("# protein, BLOSUM62, gaps -10/-1 (reference: examples/accuracy.rs)")
    run(AA, BLOSUM62, Gaps(open=-10, extend=-1), lens, args.iters,
        [(32, 32), (32, 256)])
    print("# DNA, match 1 / mismatch -1, gaps -2/-1")
    run(DNA, NucMatrix.new_simple(1, -1), Gaps(open=-2, extend=-1), lens,
        args.iters, [(32, 32), (32, 256)])
    print("Done!")


if __name__ == "__main__":
    main()
