"""Open-ended differential soak: random (matrix, gaps, size, mode) configs
through the public aligners (the engine route when run on the CPU), each
batch checked against the scalar oracle.

Runs until killed; prints one line per round and stops on the first
mismatch with a full repro tuple.  Use idle CPU to widen the fuzz surface
beyond the fixed-seed suite (tests/test_fuzz_differential.py).

  python scripts/soak_fuzz.py [start_seed]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from block_aligner_jax import (BLOSUM45, BLOSUM62, BLOSUM90, PAM120,
                               BlockOracle, Gaps, NucMatrix, PaddedBytes)
from block_aligner_jax.api import BatchAligner

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"
MATRICES = [
    (BLOSUM62, AA, (-11, -1)),
    (BLOSUM45, AA, (-10, -2)),
    (BLOSUM90, AA, (-13, -1)),
    (PAM120, AA, (-12, -2)),
    (NucMatrix.new_simple(1, -1), DNA, (-2, -1)),
    (NucMatrix.new_simple(2, -4), DNA, (-6, -2)),
]


def rand_pair(rng, alpha, lo, hi, related):
    n = int(rng.integers(lo, hi))
    q = bytes(rng.choice(list(alpha), size=n).tolist())
    if not related:
        m = int(rng.integers(lo, hi))
        return q, bytes(rng.choice(list(alpha), size=m).tolist())
    r = bytearray(q)
    for _ in range(max(1, n // int(rng.integers(2, 10)))):
        op = int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(r), 1)))
        if op == 0 and len(r) > 0:
            r[pos % len(r)] = int(rng.choice(list(alpha)))
        elif op == 1 and len(r) > 1:
            del r[pos % len(r)]
        else:
            r.insert(pos, int(rng.choice(list(alpha))))
    if rng.integers(0, 3) == 0:  # structural indel: fires the grow ladder
        ins = bytes(rng.choice(list(alpha),
                               size=int(rng.integers(30, 200))).tolist())
        pos = int(rng.integers(0, max(len(r), 1)))
        r = r[:pos] + bytearray(ins) + r[pos:]
    return q, bytes(r)


def one_round(seed, n_pairs=10):
    rng = np.random.default_rng(seed)
    matrix, alpha, (go, ge) = MATRICES[int(rng.integers(len(MATRICES)))]
    gaps = Gaps(open=go, extend=ge)
    mins = int(2 ** rng.integers(4, 8))  # 16..128
    maxs = mins * int(2 ** rng.integers(0, 4))  # x1..x8 (may cross 512)
    maxs = min(maxs, 1024)
    mode = int(rng.integers(0, 5))
    x_drop = int(rng.integers(20, 150)) if mode == 1 else None
    local_start = mode == 2
    fqs = mode == 3
    trace = mode == 4
    lo, hi = (1, 120) if maxs <= 256 else (50, 450)
    pairs = [rand_pair(rng, alpha, lo, hi, bool(rng.integers(0, 2)))
             for _ in range(n_pairs)]
    longest = max(max(len(q), len(r)) for q, r in pairs)
    al = BatchAligner(matrix, gaps, (mins, maxs), batch=16,
                      seq_cap=longest + 32, x_drop=x_drop,
                      local_start=local_start, free_query_start_gaps=fqs,
                      trace=trace)
    kern = al.route
    got = al.align_batch(pairs)
    orc = BlockOracle(x_drop=x_drop is not None, local_start=local_start,
                      free_query_start_gaps=fqs, trace=trace)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, maxs, matrix)
        pr = PaddedBytes.from_bytes(r, maxs, matrix)
        orc.align(pq, pr, matrix, gaps, (mins, maxs), x_drop or 0)
        w = orc.res()
        ok = got[k].score == w.score
        if x_drop is not None:
            ok = ok and (got[k].query_idx, got[k].reference_idx) == (
                w.query_idx, w.reference_idx)
        if ok and trace and (len(q) or len(r)):
            wc = str(orc.cigar(w.query_idx, w.reference_idx))
            gc = str(al.cigar(k, got[k].query_idx, got[k].reference_idx))
            ok = gc == wc
        if not ok:
            print(f"MISMATCH seed={seed} pair={k} kern={kern} "
                  f"cfg=({mins},{maxs}) mode={mode} got={got[k]} "
                  f"want=({w.score},{w.query_idx},{w.reference_idx})",
                  flush=True)
            return False
    print(f"seed {seed}: ok ({kern}, ({mins},{maxs}), mode {mode}, "
          f"{matrix.kind})", flush=True)
    return True


def one_round_long(seed, n_pairs=3):
    """Long-read soak: LongBatchAligner (fixed block) or
    LongAdaptiveAligner, random trace flag, 0.5-1.4 kbp sequences,
    oracle-checked scores (+ CIGARs when traced)."""
    from block_aligner_jax.api import LongAdaptiveAligner, LongBatchAligner

    rng = np.random.default_rng(seed)
    matrix, alpha, (go, ge) = MATRICES[int(rng.integers(len(MATRICES)))]
    gaps = Gaps(open=go, extend=ge)
    trace = bool(rng.integers(0, 2))
    adaptive = bool(rng.integers(0, 2))
    # byte matrices have no x-drop, like the reference
    x_drop = None
    if adaptive and matrix.kind != "byte" and rng.integers(0, 2):
        x_drop = int(rng.integers(40, 150))
    pairs = [rand_pair(rng, alpha, 500, 1400, True)
             for _ in range(n_pairs)]
    if adaptive:
        size = (int(2 ** rng.integers(5, 8)), 1024)
        al = LongAdaptiveAligner(
            matrix, gaps, size, batch=4, seq_cap=4096,
            trace=trace, x_drop=x_drop,
        )
        kern = "long-adaptive"
    else:
        blk = int(2 ** rng.integers(5, 8))
        size = (blk, blk)
        al = LongBatchAligner(
            matrix, gaps, blk, batch=4, trace=trace,
        )
        kern = "long-fixed"
    got = al.align_batch(pairs)
    orc = BlockOracle(trace=trace, x_drop=x_drop is not None)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, size[1], matrix)
        pr = PaddedBytes.from_bytes(r, size[1], matrix)
        orc.align(pq, pr, matrix, gaps, size, x_drop or 0)
        w = orc.res()
        ok = got[k].score == w.score
        if x_drop is not None:
            ok = ok and (got[k].query_idx, got[k].reference_idx) == (
                w.query_idx, w.reference_idx)
        if ok and trace:
            wc = str(orc.cigar(w.query_idx, w.reference_idx))
            gc = str(al.cigar(k, got[k].query_idx, got[k].reference_idx))
            ok = gc == wc
        if not ok:
            print(f"MISMATCH seed={seed} pair={k} kern={kern} "
                  f"size={size} trace={trace} x_drop={x_drop} "
                  f"got={got[k]} want={w}", flush=True)
            return False
    print(f"seed {seed}: ok ({kern}, {size}, trace={trace}, "
          f"x_drop={x_drop}, {matrix.kind})", flush=True)
    return True


def one_round_profile(seed, n_pairs=4):
    """PSSM soak: random consensus-boosted profiles + queries with
    structural indels through ProfileAligner at bands past 512,
    oracle-checked."""
    from block_aligner_jax import AAProfile
    from block_aligner_jax.api import ProfileAligner

    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_pairs):
        n = int(rng.integers(60, 400))
        cons = bytes(rng.choice(list(AA), size=n).tolist())
        if rng.integers(0, 2):
            prof = AAProfile.from_bytes(
                cons, 1024, int(rng.integers(3, 8)),
                -int(rng.integers(2, 6)), -int(rng.integers(8, 14)), 0,
                -int(rng.integers(8, 14)), -1)
        else:
            prof = AAProfile(n, 1024, -1)
            base = rng.integers(-4, 3, size=(n, 26))
            base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = (
                rng.integers(4, 12, size=n))
            prof.pos_scores[1 : n + 1, :26] = base
            prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
            prof.gap_close_C[: n + 1] = rng.integers(-3, 1, size=n + 1)
            prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
        q = bytearray(cons)
        for _ in range(n // int(rng.integers(3, 10))):
            op = int(rng.integers(0, 3))
            pos = int(rng.integers(0, max(len(q), 1)))
            if op == 0 and len(q) > 0:
                q[pos % len(q)] = int(rng.choice(list(AA)))
            elif op == 1 and len(q) > 1:
                del q[pos % len(q)]
            else:
                q.insert(pos, int(rng.choice(list(AA))))
        if rng.integers(0, 3) == 0:  # structural insert: grow ladder
            ins = bytes(rng.choice(
                list(AA), size=int(rng.integers(100, 300))).tolist())
            pos = int(rng.integers(0, max(len(q), 1)))
            q = q[:pos] + bytearray(ins) + q[pos:]
        pairs.append((bytes(q), prof))

    mins = int(2 ** rng.integers(7, 10))  # 128..512
    size = (mins, 1024)
    longest = max(max(len(q), p.str_len) for q, p in pairs)
    pa = ProfileAligner(size, batch=4, seq_cap=longest + 32)
    got = pa.align_batch(pairs)
    orc = BlockOracle()
    for k, (q, prof) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, size[1], prof)
        orc.align_profile(pq, prof, size, 0)
        if got[k].score != orc.res().score:
            print(f"MISMATCH seed={seed} pair={k} kern=profile "
                  f"size={size} got={got[k]} want={orc.res()}", flush=True)
            return False
    print(f"seed {seed}: ok (profile, {size})", flush=True)
    return True


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    while True:
        t0 = time.time()
        if not one_round(seed):
            sys.exit(1)
        seed += 1


if __name__ == "__main__":
    main()
