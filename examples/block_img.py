"""Render the computed DP blocks and traceback path (reference: examples/block_img.rs).

Writes a PNG (via matplotlib when available, else a PPM) showing which
rectangles of the DP matrix the adaptive algorithm computed, with the
traceback path overlaid -- the README figure of the reference.

Usage: python examples/block_img.py [--out blocks.png] [--len 500]
"""

import argparse

import numpy as np

from common import DNA, rand_mutate, rand_seq

from block_aligner_jax import BlockOracle, Gaps, NucMatrix, PaddedBytes
from block_aligner_jax.core.cigar import Operation


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="blocks.png")
    ap.add_argument("--len", type=int, dest="length", default=500)
    ap.add_argument("--min", type=int, default=32)
    ap.add_argument("--max", type=int, default=128)
    args = ap.parse_args()

    rng = np.random.default_rng(1234)
    q = rand_seq(rng, DNA, args.length)
    r = rand_mutate(rng, q, args.length // 5, DNA)
    matrix = NucMatrix.new_simple(1, -1)
    gaps = Gaps(open=-2, extend=-1)

    a = BlockOracle(trace=True)
    pq = PaddedBytes.from_bytes(q, args.max, matrix)
    pr = PaddedBytes.from_bytes(r, args.max, matrix)
    a.align(pq, pr, matrix, gaps, (args.min, args.max), 0)
    res = a.res()

    n, m = len(q) + 1, len(r) + 1
    img = np.zeros((n, m), dtype=np.uint8)
    for b in a.trace_blocks():
        img[b.row : b.row + b.height, b.col : b.col + b.width] = 1

    cig = a.cigar(res.query_idx, res.reference_idx)
    i, j = res.query_idx, res.reference_idx
    for ol in reversed(cig.to_vec()):
        for _ in range(ol.len):
            img[i, j] = 2
            if ol.op in (Operation.M, Operation.Eq, Operation.X):
                i -= 1
                j -= 1
            elif ol.op == Operation.I:
                i -= 1
            else:
                j -= 1
    img[0, 0] = 2

    frac = (img > 0).sum() / img.size
    print(f"score {res.score}, computed fraction {frac:.3f}")
    colors = np.array(
        [[255, 255, 255], [120, 170, 255], [220, 40, 40]], dtype=np.uint8
    )
    rgb = colors[img]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(6, 6 * n / m))
        plt.imshow(rgb)
        plt.xlabel("reference")
        plt.ylabel("query")
        plt.title(f"computed blocks (score {res.score})")
        plt.savefig(args.out, dpi=150, bbox_inches="tight")
        print(f"wrote {args.out}")
    except Exception:
        out = args.out.rsplit(".", 1)[0] + ".ppm"
        with open(out, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (m, n))
            f.write(rgb.tobytes())
        print(f"matplotlib unavailable; wrote {out}")


if __name__ == "__main__":
    main()
