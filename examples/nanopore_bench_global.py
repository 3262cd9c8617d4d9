"""Long-read global-mode wall time (reference: examples/nanopore_bench_global.rs).

Times adaptive 1%-1% and 1%-10% band configurations over long DNA pair sets
(the reference compares edlib/ksw2/WFA2/parasail; those baselines are
recorded in BASELINE.md).

Usage: python examples/nanopore_bench_global.py [--pairs 200] [--max-len 10000]
"""

import argparse
import time

import numpy as np

from common import load_nanopore_pairs

from block_aligner_jax import BatchAligner, Gaps, NucMatrix, percent_len


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=200)
    ap.add_argument("--max-len", type=int, default=10000)
    ap.add_argument("--dataset", default="seq_pairs.10kbps.5000")
    ap.add_argument("--trace", action="store_true",
                    help="trace + CIGAR variant (the reference's traced "
                         "1%%-10%% rows, nanopore_bench_global.rs:144-227)")
    args = ap.parse_args()

    matrix = NucMatrix.new_simple(2, -4)
    gaps = Gaps(open=-6, extend=-2)
    pairs = load_nanopore_pairs(args.dataset, n_pairs=args.pairs,
                                max_len=args.max_len)
    max_len = max(max(len(q), len(r)) for q, r in pairs)

    for lo_pct, hi_pct, label in ((0.01, 0.01, "1%-1%"), (0.01, 0.10, "1%-10%")):
        mn = percent_len(max_len, lo_pct)
        mx = percent_len(max_len, hi_pct)
        cap = max_len + max_len // 8 + 64
        al = BatchAligner(matrix, gaps, size=(mn, mx), batch=64,
                          seq_cap=cap, trace=args.trace)

        def run_batch(chunk):
            if args.trace and isinstance(al, BatchAligner):
                al.align_all_trace(chunk, eq=False)
            else:
                got = al.align_batch(chunk)
                if args.trace:
                    for k, (q, r) in enumerate(chunk):
                        al.cigar(k, len(q), len(r))
                return got

        run_batch(pairs[: min(len(pairs), al.batch_size)])  # compile
        t0 = time.perf_counter()
        for k in range(0, len(pairs), al.batch_size):
            run_batch(pairs[k : k + al.batch_size])
        dt = time.perf_counter() - t0
        mode = " +trace+cigar" if args.trace else ""
        print(f"{label} (sizes {mn}-{mx}{mode}): {dt:.3f}s "
              f"({dt / len(pairs) * 1e3:.2f} ms/pair)")


if __name__ == "__main__":
    main()
