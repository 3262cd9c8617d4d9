"""Uniclust30 wall-time benchmark (reference: examples/uc_bench.rs).

Pads/packs all pairs up front, then times batched alignment per block-size
configuration, with and without traceback -- the reference's
bench_scan_aa_core shape (reference: examples/uc_bench.rs:79-104).

Usage: python examples/uc_bench.py [--dataset uc30] [--per-bucket 1000]
"""

import argparse
import time

import numpy as np

from common import load_uc_pairs

from block_aligner_jax import BLOSUM62, BatchAligner, Gaps


def bench(pairs, size, trace, max_len):
    al = BatchAligner(
        BLOSUM62, Gaps(open=-11, extend=-1), size=size,
        batch=256 if trace else 1024,
        seq_cap=max_len + 32, trace=trace,
    )
    # warmup (compile)
    al.align_batch(pairs[: min(len(pairs), al.batch_size)])
    t0 = time.perf_counter()
    n_cigar_ops = 0
    for k in range(0, len(pairs), al.batch_size):
        chunk = pairs[k : k + al.batch_size]
        res = al.align_batch(chunk)
        if trace:
            cigs = al.trace().cigars_all(
                [(g.query_idx, g.reference_idx) for g in res])
            n_cigar_ops += sum(len(c) for c in cigs)
    dt = time.perf_counter() - t0
    return dt, n_cigar_ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="uc30")
    ap.add_argument("--per-bucket", type=int, default=1000)
    args = ap.parse_args()

    data = load_uc_pairs(args.dataset, per_bucket=args.per_bucket)
    pairs = [(q, r) for q, r, _ in data]
    max_len = max(max(len(q), len(r)) for q, r in pairs)
    print(f"# {len(pairs)} pairs, max len {max_len} ({args.dataset})")

    for size in ((32, 32), (32, 256), (256, 256)):
        dt, _ = bench(pairs, size, False, max_len)
        print(f"size {size[0]}-{size[1]} no trace: {dt:.3f}s "
              f"({dt / len(pairs) * 1e6:.1f} us/pair)")


    dt, ops = bench(pairs, (32, 32), True, max_len)
    print(f"size 32-32 with trace+cigar: {dt:.3f}s "
          f"({dt / len(pairs) * 1e6:.1f} us/pair, {ops} cigar ops)")


if __name__ == "__main__":
    main()
