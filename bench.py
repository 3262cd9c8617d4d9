"""Benchmark: the headline alignment throughput on one GPU.

Mirrors the reference bench (reference: benches/rand_scan.rs): random
protein pairs of length 1000 with k=100 edits, BLOSUM62, gaps -11/-1,
global, no trace, a fixed block of 32.  The reference's single-core AVX2
baseline is 24.1 us/pair for its adaptive 32-2048 run (BASELINE.md).

End to end through ``BatchAligner.align_all``: host packing, transfer,
the device route, and decoding into ``AlignResult``s; the route the public
API picks on the GPU (the CUDA fixed-block kernel) and the XLA engine
(``use_lane_kernel=False``) are timed in the same process, after a warm-up
call each, and must agree on every pair.

Prints one JSON line (last line of stdout) with the card's name and power
limit; exits non-zero without a GPU or on any mismatch.

    python bench.py [--pairs 16384]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

BASELINE_US_PER_PAIR = 24.1  # reference bench notebook cell 11 (1k protein)
METRIC = "random_protein_1000x1000_global_block32_us_per_pair"


def rand_protein_pairs(rng, n_pairs, length, k):
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    # vectorized simulate-seqs-style mutate: substitutions at k random
    # positions plus a few indels via re-splicing
    pairs = []
    qs = rng.choice(aa, size=(n_pairs, length))
    for q in qs:
        r = q.copy()
        pos = rng.integers(0, length, size=k)
        r[pos] = rng.choice(aa, size=k)
        ndel = int(rng.integers(0, k // 4 + 1))
        if ndel:
            keep = np.ones(length, dtype=bool)
            keep[rng.integers(0, length, size=ndel)] = False
            r = r[keep]
        nins = int(rng.integers(0, k // 4 + 1))
        if nins:
            at = rng.integers(0, len(r), size=nins)
            r = np.insert(r, at, rng.choice(aa, size=nins))
        pairs.append((q.tobytes(), r.tobytes()))
    return pairs


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_align_all(al, pairs, reps):
    """Seconds per ``align_all`` over ``pairs`` (after one warm-up call)
    and the results of the last call."""
    al.align_all(pairs)
    t0 = time.perf_counter()
    for _ in range(reps):
        got = al.align_all(pairs)
    return (time.perf_counter() - t0) / reps, got


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from block_aligner_jax import BLOSUM62, BatchAligner, Gaps, compile_cache

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: JAX found no GPU (backend {jax.default_backend()!r})")
    name_power = card()
    compile_cache.enable()
    dev = jax.devices()[0]
    pairs = rand_protein_pairs(np.random.default_rng(1234), args.pairs,
                               1000, 100)
    gaps = Gaps(open=-11, extend=-1)
    kw = dict(batch=args.pairs, seq_cap=1100)
    fast = BatchAligner(BLOSUM62, gaps, (32, 32), **kw)
    eng = BatchAligner(BLOSUM62, gaps, (32, 32), use_lane_kernel=False, **kw)
    t_fast, got = time_align_all(fast, pairs, args.reps)
    t_eng, want = time_align_all(eng, pairs, max(1, args.reps // 3))
    if got != want:
        sys.exit("bench: the routes disagree")
    us = t_fast / len(pairs) * 1e6
    print(json.dumps({
        "metric": METRIC,
        "value": round(us, 4),
        "unit": "us_per_pair",
        "vs_baseline": round(BASELINE_US_PER_PAIR / us, 3),
        "route": fast.route,
        "engine_us_per_pair": round(t_eng / len(pairs) * 1e6, 3),
        "pairs": len(pairs),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": name_power,
    }), flush=True)


if __name__ == "__main__":
    main()
