"""Long-read x-drop benchmark (reference: examples/nanopore_bench.rs).

X-drop alignment (x = 50 and 100) over 25kbp-style reads plus random pairs,
block sizes 32..64.

Usage: python examples/nanopore_bench.py [--pairs 100] [--max-len 10000]
"""

import argparse
import time

import numpy as np

from common import DNA, load_nanopore_pairs, rand_seq

from block_aligner_jax import BatchAligner, Gaps, NucMatrix


def bench(pairs, x, max_len):
    matrix = NucMatrix.new_simple(2, -4)
    gaps = Gaps(open=-6, extend=-2)
    al = BatchAligner(matrix, gaps, size=(32, 64), batch=64,
                      seq_cap=max_len + max_len // 8 + 64, x_drop=x)
    al.align_batch(pairs[: min(len(pairs), al.batch_size)])  # compile
    t0 = time.perf_counter()
    al.align_all(pairs)
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--max-len", type=int, default=10000)
    args = ap.parse_args()

    real = load_nanopore_pairs(n_pairs=args.pairs, max_len=args.max_len)
    rng = np.random.default_rng(1234)
    rand_pairs = [
        (rand_seq(rng, DNA, args.max_len), rand_seq(rng, DNA, args.max_len))
        for _ in range(min(args.pairs, 32))
    ]
    max_len = max(max(len(q), len(r)) for q, r in real + rand_pairs)

    for x in (50, 100):
        dt = bench(real, x, max_len)
        print(f"reads, x_drop {x}: {dt:.3f}s ({dt / len(real) * 1e3:.2f} ms/pair)")
        dt = bench(rand_pairs, x, max_len)
        print(f"random, x_drop {x}: {dt:.3f}s ({dt / len(rand_pairs) * 1e3:.2f} ms/pair)")


if __name__ == "__main__":
    main()
