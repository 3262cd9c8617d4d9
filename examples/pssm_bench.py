"""Sequence-to-PSSM wall time (reference: examples/pssm_bench.rs).

Usage: python examples/pssm_bench.py [--pairs 500]
"""

import argparse
import time

from common import load_scop_profiles

from block_aligner_jax import ProfileAligner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=500)
    args = ap.parse_args()

    data = load_scop_profiles(n_pairs=args.pairs)
    max_q = max(len(q) for q, _ in data)
    max_p = max(p.len() for _, p in data)
    cap = max(max_q, max_p)

    for (mn, mx) in ((32, 32), (32, 64), (64, 64), (64, 128), (128, 128)):
        pa = ProfileAligner(size=(mn, mx), batch=256, seq_cap=cap + 32)
        pa.align_batch(data[: min(len(data), pa.batch_size)])  # compile
        t0 = time.perf_counter()
        for k in range(0, len(data), pa.batch_size):
            pa.align_batch(data[k : k + pa.batch_size])
        dt = time.perf_counter() - t0
        print(f"size {mn}-{mx}: {dt:.3f}s ({dt / len(data) * 1e6:.1f} us/pair)")


if __name__ == "__main__":
    main()
