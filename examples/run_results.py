"""Measure the reference's benchmark rows end to end on one GPU.

Each row mirrors a reference benchmark (BASELINE.md) and times the public
API (``align_all`` / ``align_all_trace`` / ``ProfileAligner.align_all``)
after one warm-up call: host pack, transfer, the device route, and decode
(plus the CIGAR walk in traced rows).  Accuracy counts scores that differ
from the exact full-DP optimum (native C++), as the reference counts
against rust-bio/parasail; block scores are lower bounds of it by design.
Data are seeded synthetic sets shaped like the reference's
(examples/common.py).  Prints a markdown table.

    python examples/run_results.py [--scale 1.0]
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from common import AA, DNA, load_nanopore_pairs, load_scop_profiles, load_uc_pairs  # noqa: E402

from block_aligner_jax import (NW1, BLOSUM62, BatchAligner, Gaps,  # noqa: E402
                               LongAdaptiveAligner, LongBatchAligner,
                               NucMatrix, ProfileAligner, compile_cache)
from block_aligner_jax.api import backend_of, pick_route  # noqa: E402
from block_aligner_jax.core.full_dp import global_align_score  # noqa: E402

BL_GAPS = Gaps(open=-11, extend=-1)
NUC = NucMatrix.new_simple(2, -4)
NUC_GAPS = Gaps(open=-6, extend=-2)
ROWS = []
SCALE = 1.0


def n_of(n):
    return max(8, int(n * SCALE))


def row(name, route, n, dt, baseline_us, wrong=None, note=""):
    us = dt / n * 1e6
    speed = f"{baseline_us / us:.2f}x" if baseline_us else "-"
    acc = "-" if wrong is None else f"{wrong}/{n}"
    ROWS.append((name, route, n, f"{us:.2f}", baseline_us or "-", speed, acc,
                 note))
    print(ROWS[-1], flush=True)


def route_of(size, **flags):
    return pick_route(*size, backend=backend_of(), **flags)


def timed(fn, *args):
    fn(*args)  # warm-up: compile, build
    t0 = time.perf_counter()
    out = fn(*args)
    return time.perf_counter() - t0, out


def wrong_vs_exact(pairs, got, matrix, gaps, every=1):
    ks = range(0, len(pairs), every)
    return sum(1 for k in ks
               if got[k].score != global_align_score(*pairs[k], matrix, gaps))


def bench_uc():
    for name, base in (("uc30_0.95", (8.14, 12.7, 24.3, 21.7)),
                       ("uc30", (None, None, None, None))):
        data = load_uc_pairs(name, per_bucket=n_of(1000))
        pairs = [(q, r) for q, r, _ in data]
        cap = max(max(len(q), len(r)) for q, r in pairs) + 32
        for k, size in enumerate(((32, 32), (32, 256))):
            al = BatchAligner(BLOSUM62, BL_GAPS, size, batch=8192,
                              seq_cap=cap)
            dt, got = timed(al.align_all, pairs)
            row(f"{name} global {size[0]}-{size[1]}", al.route, len(pairs),
                dt, base[k], wrong_vs_exact(pairs, got, BLOSUM62, BL_GAPS))
        for k, size in enumerate(((32, 32), (32, 256))):
            alt = BatchAligner(BLOSUM62, BL_GAPS, size, batch=1024,
                               seq_cap=cap, trace=True)
            dt, _ = timed(alt.align_all_trace, pairs)
            row(f"{name} {size[0]}-{size[1]} + trace + CIGAR", alt.route,
                len(pairs), dt, base[2 + k])
    al = BatchAligner(BLOSUM62, BL_GAPS, (256, 256), batch=8192, seq_cap=cap)
    dt, _ = timed(al.align_all, pairs)
    row("uc30 global 256-256", al.route, len(pairs), dt, 28.5)


def mutated(rng, n, err):
    r = bytes(rng.choice(list(DNA), size=n).tolist())
    q = bytearray(r)
    for _ in range(max(1, int(n * err))):
        op = int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(q), 1)))
        if op == 0:
            q[pos % len(q)] = int(rng.choice(list(DNA)))
        elif op == 1 and len(q) > 1:
            del q[pos % len(q)]
        else:
            q.insert(pos, int(rng.choice(list(DNA))))
    return bytes(q), r


def bench_reads():
    """Illumina 150 bp (ref 3.31 us/pair) and nanopore 1 kbp (ref 28.5
    us/pair) traced global rows at the 1%-1% band (block 32), then
    nanopore <10 kbp bands and <50 kbp (512, 8192)."""
    rng = np.random.default_rng(77)
    for name, n, lo, hi, err, base in (("illumina 150bp", 16384, 100, 151,
                                        0.01, 3.31),
                                       ("nanopore 1kbp", 8192, 800, 1000,
                                        0.1, 28.5)):
        pairs = [mutated(rng, int(rng.integers(lo, hi)), err)
                 for _ in range(n_of(n))]
        alt = BatchAligner(NUC, NUC_GAPS, (32, 32), batch=2048,
                           seq_cap=hi + 64, trace=True)
        dt, _ = timed(alt.align_all_trace, pairs)
        row(f"{name} global 32-32 + trace + CIGAR", alt.route, len(pairs),
            dt, base)
    pairs = load_nanopore_pairs(n_pairs=n_of(256), max_len=10000)
    for size, base in (((128, 128), 246.0), ((128, 1024), 350.0)):
        al = LongAdaptiveAligner(NUC, NUC_GAPS, size, batch=256)
        dt, got = timed(al.align_batch, pairs)
        row(f"nanopore <10kbp global {size[0]}-{size[1]}", route_of(size),
            len(pairs), dt, base,
            wrong_vs_exact(pairs, got, NUC, NUC_GAPS, every=31))
    pairs = load_nanopore_pairs(name="seq_pairs.50kbps.10000",
                                n_pairs=n_of(32), max_len=50000)
    al = LongAdaptiveAligner(NUC, NUC_GAPS, (512, 8192), batch=32)
    dt, _ = timed(al.align_batch, pairs)
    row("nanopore <50kbp global 512-8192", route_of((512, 8192)), len(pairs),
        dt, 6030.0)


def bench_xdrop():
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(n_of(8192)):
        n = int(rng.integers(800, 1000))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 10):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(list(AA)))
        pairs.append((q, bytes(r)))
    al = BatchAligner(BLOSUM62, BL_GAPS, (32, 32), batch=8192, seq_cap=1100,
                      x_drop=50)
    dt, _ = timed(al.align_all, pairs)
    row("random protein 1k x-drop 32-32", al.route, len(pairs), dt, None)

    # reference 25 kbp x-drop conditions (examples/nanopore_bench.rs:95-120:
    # NW1, gaps -2/-1, x=50, fixed 32, 100-base random tails; ref 0.991 s
    # for ~100 pairs)
    rng = np.random.default_rng(1234)
    pairs = []
    for _ in range(n_of(100)):
        q, r = mutated(rng, int(rng.integers(20000, 25000)), 0.1)
        tail = bytes(rng.choice(list(DNA), size=200).tolist())
        pairs.append((q + tail[:100], r + tail[100:]))
    al = LongBatchAligner(NW1, Gaps(open=-2, extend=-1), block=32,
                          batch=128, x_drop=50)
    dt, _ = timed(al.align_batch, pairs)
    row("nanopore 25kbp x-drop(50) 32-32", route_of((32, 32)), len(pairs),
        dt, 9910.0)


def bench_rand_scan():
    """The reference's rand_scan rows (bench notebook cell 11): random
    protein 100x100 k=10 (3.9 us/pair) and 10000x10000 k=1000 (231.7
    us/pair), global block 32."""
    from bench import rand_protein_pairs

    for n, length, k, base in ((131072, 100, 10, 3.9),
                               (2048, 10000, 1000, 231.7)):
        pairs = rand_protein_pairs(np.random.default_rng(1234), n_of(n),
                                   length, k)
        al = BatchAligner(BLOSUM62, BL_GAPS, (32, 32), batch=16384,
                          seq_cap=length + length // 4)
        dt, _ = timed(al.align_all, pairs)
        row(f"random protein {length}x{length} global 32-32", al.route,
            len(pairs), dt, base)


def bench_pssm():
    data = load_scop_profiles(n_pairs=n_of(8192))
    cap = max(max(len(q) for q, _ in data), max(p.len() for _, p in data))
    for size, base in (((32, 32), 13.4), ((128, 128), 18.6)):
        pa = ProfileAligner(size, batch=2048, seq_cap=cap + size[1])
        dt, _ = timed(pa.align_all, data)
        row(f"SCOP-style seq-PSSM {size[0]}-{size[1]}", pa.route, len(data),
            dt, base)


def main():
    global SCALE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every row's pair count")
    SCALE = ap.parse_args().scale
    import jax

    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    bench_uc()
    bench_reads()
    bench_xdrop()
    bench_rand_scan()
    bench_pssm()
    dev = jax.devices()[0]
    print(f"\n# Reference rows end to end ({dev.device_kind}; {card})\n")
    print("| workload | route | pairs | us/pair | ref us/pair | speedup "
          "| wrong vs exact | note |")
    print("|---|---|---|---|---|---|---|---|")
    for r in ROWS:
        print("| " + " | ".join(str(x) for x in r) + " |")


if __name__ == "__main__":
    main()
