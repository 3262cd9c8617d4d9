"""CIGAR structural-consistency check (reference: examples/verify_trace.rs).

Every traceback's operations must sum exactly to the alignment end position
(reference: examples/verify_trace.rs:8-29), across random pairs and block
sizes 32..256.

Usage: python examples/verify_trace.py [--iters 200]
"""

import argparse

import numpy as np

from common import AA, rand_mutate, rand_seq

from block_aligner_jax import BLOSUM62, BatchAligner, Gaps
from block_aligner_jax.core.cigar import Operation


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    rng = np.random.default_rng(1234)
    gaps = Gaps(open=-11, extend=-1)
    bad = 0
    for (mn, mx) in ((32, 32), (32, 256), (256, 256)):
        pairs = []
        for _ in range(args.iters):
            n = int(rng.integers(20, 400))
            q = rand_seq(rng, AA, n)
            pairs.append((q, rand_mutate(rng, q, n // 3, AA)))
        max_len = max(max(len(q), len(r)) for q, r in pairs)
        al = BatchAligner(BLOSUM62, gaps, size=(mn, mx), batch=64,
                          seq_cap=max_len + 32, trace=True)
        for k in range(0, len(pairs), al.batch_size):
            chunk = pairs[k : k + al.batch_size]
            res = al.align_batch(chunk)
            for bi, ((q, r), got) in enumerate(zip(chunk, res)):
                cig = al.cigar_eq(bi, q, r, got.query_idx, got.reference_idx)
                di = dj = 0
                for ol in cig.to_vec():
                    if ol.op in (Operation.M, Operation.Eq, Operation.X):
                        di += ol.len
                        dj += ol.len
                    elif ol.op == Operation.I:
                        di += ol.len
                    else:
                        dj += ol.len
                if (di, dj) != (got.query_idx, got.reference_idx):
                    bad += 1
                    print(f"INCONSISTENT size {mn}-{mx}: {cig} vs "
                          f"({got.query_idx}, {got.reference_idx})")
        print(f"size {mn}-{mx}: checked {len(pairs)}")
    print(f"Done! inconsistent: {bad}")


if __name__ == "__main__":
    main()
