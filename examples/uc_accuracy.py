"""Uniclust30 protein-pair accuracy sweep with DP-fraction telemetry.

Port of the reference program (reference: examples/uc_accuracy.rs):
per-identity-bucket wrong-score counts vs the exact oracle, plus the mean
fraction of DP cells actually computed (from the trace block telemetry).
Emits the same CSV schema: dataset, size, total, wrong, wrong_avg, dp_frac.

Usage: python examples/uc_accuracy.py [--dataset uc30] [--per-bucket 100]
"""

import argparse
import sys
import time

import numpy as np

from common import load_uc_pairs

from block_aligner_jax import BLOSUM62, BatchAligner, Gaps
from block_aligner_jax.core.full_dp import global_align_score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="uc30")
    ap.add_argument("--per-bucket", type=int, default=100)
    ap.add_argument("--trace", action="store_true", help="compute DP fraction")
    args = ap.parse_args()

    gaps = Gaps(open=-11, extend=-1)
    data = load_uc_pairs(args.dataset, per_bucket=args.per_bucket)
    max_len = max(max(len(q), len(r)) for q, r, _ in data)

    print("dataset,size,total,wrong,wrong_avg,dp_frac")
    for (mn, mx) in ((32, 32), (32, 256), (256, 256)):
        al = BatchAligner(
            BLOSUM62, gaps, size=(mn, mx), batch=256,
            seq_cap=max_len + 32, trace=args.trace,
        )
        wrong = 0
        wrong_err = 0
        dp_cells = 0
        dp_total = 0
        t0 = time.perf_counter()
        bucket_wrong = {}
        for k in range(0, len(data), al.batch_size):
            chunk = data[k : k + al.batch_size]
            res = al.align_batch([(q, r) for q, r, _ in chunk])
            for bi, ((q, r, bucket), got) in enumerate(zip(chunk, res)):
                want = global_align_score(q, r, BLOSUM62, gaps)
                if got.score != want:
                    wrong += 1
                    wrong_err += want - got.score
                    bucket_wrong[bucket] = bucket_wrong.get(bucket, 0) + 1
                if args.trace:
                    blocks = al.trace().blocks(bi)
                    dp_cells += sum(b.width * b.height for b in blocks)
                    dp_total += (len(q) + 1) * (len(r) + 1)
        dt = time.perf_counter() - t0
        frac = dp_cells / dp_total if dp_total else 0.0
        avg = (wrong_err / wrong) if wrong else 0.0
        print(
            f"{args.dataset},{mn}-{mx},{len(data)},{wrong},{avg:.2f},{frac:.4f}"
            f"  # {dt:.2f}s"
        )
        if bucket_wrong:
            print("# wrong by seq-id bucket:",
                  dict(sorted(bucket_wrong.items())), file=sys.stderr)


if __name__ == "__main__":
    main()
