"""Sequence-to-PSSM accuracy vs the largest-block self-oracle.

Port of the reference program (reference: examples/pssm_accuracy.rs):
correctness = agreement with a (2048, 2048) full-block run,
position-specific gap open costs, gap close 0.

Two oracle modes:

* default: the reference's own methodology verbatim -- a DEVICE run at
  block (2048, 2048) through the big-kernel profile path (round 5;
  reference: examples/pssm_accuracy.rs:80-82), which the engine profile
  tests show equals the exact full DP;
* --exact-oracle: the exact profile full-DP on the host (stronger: it
  would catch a systematic bias shared by all block sizes).

Usage: python examples/pssm_accuracy.py [--pairs 200] [--exact-oracle]
"""

import argparse

import numpy as np

from common import load_scop_profiles

from block_aligner_jax import ProfileAligner
from block_aligner_jax.core.full_dp import global_align_profile_score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=200)
    ap.add_argument("--exact-oracle", action="store_true",
                    help="exact host full-DP instead of the reference's "
                         "2048-block device self-oracle")
    args = ap.parse_args()

    data = load_scop_profiles(n_pairs=args.pairs)
    max_q = max(len(q) for q, _ in data)
    max_p = max(p.len() for _, p in data)
    cap = max(max_q, max_p)

    if args.exact_oracle:
        want = [global_align_profile_score(q, prof) for q, prof in data]
    else:
        # the reference's self-oracle: one fixed (2048, 2048) block run
        po = ProfileAligner(size=(2048, 2048), batch=128,
                            seq_cap=max(max_q, max_p) + 16)
        want = []
        for k in range(0, len(data), po.batch_size):
            chunk = data[k : k + po.batch_size]
            want.extend(r.score for r in po.align_batch(chunk))

    print("size,total,correct")
    for (mn, mx) in ((32, 32), (32, 64), (64, 64), (64, 128), (128, 128)):
        pa = ProfileAligner(size=(mn, mx), batch=256, seq_cap=cap + 32)
        correct = 0
        for k in range(0, len(data), pa.batch_size):
            chunk = data[k : k + pa.batch_size]
            res = pa.align_batch(chunk)
            for (_, w), got in zip(
                    zip(chunk, want[k : k + pa.batch_size]), res):
                if got.score == w:
                    correct += 1
        print(f"{mn}-{mx},{len(data)},{correct}")


if __name__ == "__main__":
    main()
