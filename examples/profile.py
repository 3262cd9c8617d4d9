"""Tight alignment loop for profilers (reference: examples/profile.rs).

Runs repeated batched alignments of one staged input so device profilers
(e.g. the JAX profiler) see a steady kernel stream.

Usage: python examples/profile.py [--iters 20] [--batch 2048] [--trace-dir DIR]
"""

import argparse
import time

import numpy as np

from common import AA, rand_mutate, rand_seq

from block_aligner_jax import BLOSUM62, BatchAligner, Gaps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--len", type=int, dest="length", default=1000)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import jax

    rng = np.random.default_rng(1234)
    pairs = []
    for _ in range(args.batch):
        q = rand_seq(rng, AA, args.length)
        pairs.append((q, rand_mutate(rng, q, args.length // 10, AA)))

    al = BatchAligner(BLOSUM62, Gaps(-11, -1), (32, 32), batch=args.batch,
                      seq_cap=args.length + args.length // 4)
    staged = al.stage(pairs)
    al.align_staged(staged)  # compile

    if args.trace_dir:
        jax.profiler.start_trace(args.trace_dir)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        al.align_staged(staged)
    dt = time.perf_counter() - t0
    if args.trace_dir:
        jax.profiler.stop_trace()
    print(f"{args.iters} x {args.batch} pairs, route {al.route}: {dt:.3f}s "
          f"({dt / args.iters / args.batch * 1e6:.2f} us/pair)")


if __name__ == "__main__":
    main()
