"""Per-pair accuracy records for the vis figure set.

The reference's accuracy notebook (reference:
vis/block_aligner_accuracy_vis.ipynb) builds its scatter figures from
per-pair CSVs (``data/uc_accuracy.csv``, ``data/nanopore_accuracy.csv``,
``data/pssm_accuracy.csv``: true score, predicted score, lengths, sequence
identity, largest gap).  This collector emits the same records from the
batched aligners vs the exact full-DP oracles into ``vis/data/*.csv`` so
``vis/make_figs.py`` can render the mirrored figure set.

CPU-runnable at reduced N (the default); pass --full on hardware.

Usage: python examples/accuracy_perpair.py [--per-bucket 40]
       [--nanopore-pairs 32] [--nanopore-len 6000] [--pssm-pairs 200]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if "--gpu" not in sys.argv:
    # default to CPU: the figure data is score-exactness, not speed; pass
    # --gpu on a card
    import jax

    jax.config.update("jax_platforms", "cpu")

from common import AA, DNA, load_scop_profiles, load_uc_pairs, rand_mutate, \
    rand_seq  # noqa: E402

from block_aligner_jax import (  # noqa: E402
    BLOSUM62,
    BatchAligner,
    Gaps,
    NucMatrix,
    ProfileAligner,
    percent_len,
)
from block_aligner_jax.core.full_dp import (  # noqa: E402
    global_align_profile_score,
    global_align_score,
)

OUT = Path(__file__).resolve().parents[1] / "vis" / "data"


def uc_perpair(per_bucket):
    gaps = Gaps(open=-11, extend=-1)
    rows = ["dataset,size,seq id,query len,reference len,true score,"
            "pred score"]
    for dataset, name in (("uc30_0.95", "uc30_0.95"), ("uc30", "uc30")):
        data = load_uc_pairs(name, per_bucket=per_bucket)
        max_len = max(max(len(q), len(r)) for q, r, _ in data)
        for (mn, mx) in ((32, 32), (32, 256), (256, 256)):
            al = BatchAligner(BLOSUM62, gaps, size=(mn, mx), batch=256,
                              seq_cap=max_len + 32)
            for k in range(0, len(data), al.batch_size):
                chunk = data[k : k + al.batch_size]
                res = al.align_batch([(q, r) for q, r, _ in chunk])
                for (q, r, bucket), got in zip(chunk, res):
                    want = global_align_score(q, r, BLOSUM62, gaps)
                    rows.append(f"{dataset},{mn}-{mx},{bucket},{len(q)},"
                                f"{len(r)},{want},{got.score}")
            print(f"uc {dataset} {mn}-{mx}: {len(data)} pairs",
                  file=sys.stderr)
    (OUT / "uc_accuracy.csv").write_text("\n".join(rows) + "\n")


def nanopore_perpair(n_pairs, max_len):
    """ONT-like pairs with recorded structural indels (the synthetic
    stand-in for the reference's real read set; largest inserted/deleted
    run is the 'largest gap' column)."""
    matrix = NucMatrix.new_simple(2, -4)
    gaps = Gaps(open=-6, extend=-2)
    rng = np.random.default_rng(99)
    pairs = []
    for _ in range(n_pairs):
        n = int(rng.integers(max_len // 2, max_len))
        q = rand_seq(rng, DNA, n)
        r = rand_mutate(rng, q, n // 12, DNA)
        largest = 0
        for _ in range(int(rng.integers(0, 4))):
            ln = int(rng.integers(16, max(17, n // 12)))
            pos = int(rng.integers(0, max(len(r) - ln, 1)))
            if rng.integers(0, 2) and len(r) > ln + 16:
                r = r[:pos] + r[pos + ln:]
            else:
                r = r[:pos] + rand_seq(rng, DNA, ln) + r[pos:]
            largest = max(largest, ln)
        pairs.append((q, r, largest))
    ml = max(max(len(q), len(r)) for q, r, _ in pairs)
    mn, mx = percent_len(ml, 0.01), percent_len(ml, 0.10)
    al = BatchAligner(matrix, gaps, size=(mn, mx), batch=128,
                      seq_cap=ml + ml // 8 + 64)
    rows = ["dataset,size,largest gap,true score,pred score"]
    for k in range(0, len(pairs), al.batch_size):
        chunk = pairs[k : k + al.batch_size]
        res = al.align_batch([(q, r) for q, r, _ in chunk])
        for (q, r, largest), got in zip(chunk, res):
            want = global_align_score(q, r, matrix, gaps)
            rows.append(f"nanopore <10kbp,{mn}-{mx},{largest},{want},"
                        f"{got.score}")
    print(f"nanopore: {len(pairs)} pairs at ({mn},{mx})", file=sys.stderr)
    (OUT / "nanopore_accuracy.csv").write_text("\n".join(rows) + "\n")


def pssm_perpair(n_pairs):
    data = load_scop_profiles(n_pairs=n_pairs)
    max_len = max(max(len(q), p.str_len) for q, p in data)
    rows = ["dataset,size,query len,profile len,true score,pred score"]
    for (mn, mx) in ((32, 32), (32, 64)):
        al = ProfileAligner(size=(mn, mx), batch=256, seq_cap=max_len + 32)
        for k in range(0, len(data), al.batch_size):
            chunk = data[k : k + al.batch_size]
            res = al.align_batch(chunk)
            for (q, p), got in zip(chunk, res):
                want = global_align_profile_score(q, p)
                rows.append(f"scop,{mn}-{mx},{len(q)},{p.str_len},{want},"
                            f"{got.score}")
        print(f"pssm {mn}-{mx}: {len(data)} pairs", file=sys.stderr)
    (OUT / "pssm_accuracy.csv").write_text("\n".join(rows) + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-bucket", type=int, default=40)
    ap.add_argument("--nanopore-pairs", type=int, default=32)
    ap.add_argument("--nanopore-len", type=int, default=6000)
    ap.add_argument("--pssm-pairs", type=int, default=200)
    ap.add_argument("--skip", default="", help="comma list: uc,nanopore,pssm")
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (default: forced CPU)")
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    skip = set(args.skip.split(","))
    if "uc" not in skip:
        uc_perpair(args.per_bucket)
    if "nanopore" not in skip:
        nanopore_perpair(args.nanopore_pairs, args.nanopore_len)
    if "pssm" not in skip:
        pssm_perpair(args.pssm_pairs)
    print("Done!", file=sys.stderr)


if __name__ == "__main__":
    main()
