"""Randomized differential fuzzing across configurations and backends.

One bounded sweep per run: random (matrix, gaps, mode, block range,
sequence shape) configurations, each checked engine-vs-oracle.  The reference relies on fixed-seed randomized
examples for the same purpose (reference: examples/accuracy.rs).
"""

import numpy as np
import pytest

from block_aligner_jax import (BLOSUM45, BLOSUM62, BLOSUM90, BlockOracle,
                               Gaps, NucMatrix, PaddedBytes, PAM120)
from block_aligner_jax.core.traceback import EngineTrace
from block_aligner_jax.ops.engine import EngineConfig, build_engine, pack_pairs

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
        return q, bytes(rng.choice(list(alpha), size=int(rng.integers(lo, hi))).tolist())
    r = bytearray(q)
    for _ in range(max(1, n // int(rng.integers(2, 8)))):
        op = int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(r), 1)))
        if op == 0 and len(r) > 0:
            r[pos % len(r)] = int(rng.choice(list(alpha)))
        elif op == 1 and len(r) > 1:
            del r[pos % len(r)]
        else:
            r.insert(pos, int(rng.choice(list(alpha))))
    return q, bytes(r)


@pytest.mark.parametrize("round_seed", [101, 202, 303])
def test_fuzz_engine_vs_oracle(round_seed):
    rng = np.random.default_rng(round_seed)
    for _ in range(4):
        matrix, alpha, (go, ge) = MATRICES[int(rng.integers(0, len(MATRICES)))]
        gaps = Gaps(open=go, extend=ge)
        min_size = int(16 * 2 ** rng.integers(0, 2))
        max_size = min_size * int(2 ** rng.integers(0, 3))
        x_drop = int(rng.integers(20, 120)) if rng.integers(0, 2) else None
        trace = bool(rng.integers(0, 2))
        pairs = [
            rand_pair(rng, alpha, 5, 160, bool(rng.integers(0, 2)))
            for _ in range(6)
        ]
        cfg = EngineConfig(
            batch=len(pairs), min_size=min_size, max_size=max_size,
            seq_cap=384, n_rows=getattr(matrix, "ROWS", 1),
            trace=trace, x_drop=x_drop is not None,
        )
        fn = build_engine(cfg)
        args = pack_pairs(pairs, matrix, cfg)
        out = fn(*args, gaps.open, gaps.extend, x_drop or 0)
        if trace:
            score, qi, rj, iters, tr, meta = out
            et = EngineTrace(np.asarray(tr), np.asarray(meta), int(iters))
        else:
            score, qi, rj, _ = out
            et = None
        score = np.asarray(score)
        qi = np.asarray(qi)
        rj = np.asarray(rj)

        a = BlockOracle(trace=trace, x_drop=x_drop is not None)
        for k, (q, r) in enumerate(pairs):
            pq = PaddedBytes.from_bytes(q, max_size, matrix)
            pr = PaddedBytes.from_bytes(r, max_size, matrix)
            a.align(pq, pr, matrix, gaps, (min_size, max_size), x_drop or 0)
            res = a.res()
            ctx = (round_seed, matrix.kind, gaps, min_size, max_size,
                   x_drop, trace, k, q, r)
            assert int(score[k]) == res.score, ctx
            assert (int(qi[k]), int(rj[k])) == (
                res.query_idx, res.reference_idx), ctx
            if trace:
                want = str(a.cigar(res.query_idx, res.reference_idx))
                got = str(et.cigar(k, int(qi[k]), int(rj[k])))
                assert got == want, ctx


@pytest.mark.parametrize("round_seed", [101, 202])
def test_fuzz_adaptive_kernel_vs_oracle(round_seed):
    """Randomized adaptive sweeps: random matrices/gaps/ranges and
    shape corners (empty, single-char, strongly asymmetric, unrelated)
    checked against the oracle's grow/shrink machine."""
    from block_aligner_jax.api import BatchAligner

    rng = np.random.default_rng(round_seed)
    for it in range(3):
        matrix, alpha, (go, ge) = MATRICES[int(rng.integers(len(MATRICES)))]
        mins = int(2 ** rng.integers(4, 6))  # 16 or 32
        maxs = mins * int(2 ** rng.integers(1, 3))  # x2 or x4
        gaps = Gaps(open=go, extend=ge)
        pairs = [
            (b"", b""), (b"A", b"A"), (b"", bytes(alpha[:3])),
            (bytes(alpha[:1]) * 60, bytes(alpha[:1])),
        ]
        for _ in range(12):
            pairs.append(rand_pair(rng, alpha, 1, 120,
                                   bool(rng.integers(0, 2))))
        al = BatchAligner(matrix, gaps, (mins, maxs), batch=16, seq_cap=200)
        assert al.route == "engine"
        got = al.align_batch(pairs)
        orc = BlockOracle()
        for k, (q, r) in enumerate(pairs):
            pq = PaddedBytes.from_bytes(q, maxs, matrix)
            pr = PaddedBytes.from_bytes(r, maxs, matrix)
            orc.align(pq, pr, matrix, gaps, (mins, maxs), 0)
            assert got[k].score == orc.res().score, (
                it, k, mins, maxs, got[k].score, orc.res().score)


@pytest.mark.parametrize("round_seed", [107, 211])
def test_fuzz_big_kernel_vs_oracle(round_seed):
    """Randomized large-band sweeps across max sizes crossing 512 and mode
    flags (global / x-drop / local-start / free-query-start-gaps), shape
    corners included, checked against the oracle's grow/shrink machine."""
    from block_aligner_jax.api import BatchAligner

    rng = np.random.default_rng(round_seed)
    for it in range(2):
        matrix, alpha, (go, ge) = MATRICES[int(rng.integers(len(MATRICES)))]
        mins = int(2 ** rng.integers(5, 8))  # 32..128
        maxs = 1024
        gaps = Gaps(open=go, extend=ge)
        mode = int(rng.integers(0, 3))
        x_drop = int(rng.integers(30, 150)) if mode == 0 else None
        local_start = mode == 1
        fqs = mode == 2
        pairs = [
            (b"", b""), (b"A", b"A"),
            (bytes(alpha[:1]) * 60, bytes(alpha[:1])),
        ]
        for _ in range(8):
            pairs.append(rand_pair(rng, alpha, 1, 400,
                                   bool(rng.integers(0, 2))))
        al = BatchAligner(matrix, gaps, (mins, maxs), batch=16,
                          seq_cap=1024, x_drop=x_drop,
                          local_start=local_start,
                          free_query_start_gaps=fqs)
        assert al.route == "engine"
        got = al.align_batch(pairs)
        orc = BlockOracle(x_drop=x_drop is not None, local_start=local_start,
                          free_query_start_gaps=fqs)
        for k, (q, r) in enumerate(pairs):
            pq = PaddedBytes.from_bytes(q, maxs, matrix)
            pr = PaddedBytes.from_bytes(r, maxs, matrix)
            orc.align(pq, pr, matrix, gaps, (mins, maxs), x_drop or 0)
            w = orc.res()
            if x_drop is not None:
                assert (got[k].score, got[k].query_idx,
                        got[k].reference_idx) == (
                    w.score, w.query_idx, w.reference_idx), (it, k, mode)
            else:
                assert got[k].score == w.score, (
                    it, k, mode, got[k].score, w.score)
