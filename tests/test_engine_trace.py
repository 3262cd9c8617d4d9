"""Batched-engine traceback vs the scalar oracle: exact CIGAR parity.

Mirrors the reference trace tests (reference: src/scan_block.rs:2052-2103)
plus randomized parity in the spirit of examples/verify_trace.rs.
"""

import numpy as np
import pytest

from block_aligner_jax import BLOSUM62, BlockOracle, Gaps, NW1, PaddedBytes
from block_aligner_jax.core.traceback import EngineTrace
from block_aligner_jax.ops.engine import EngineConfig, build_engine, pack_pairs

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"


def rand_seq(rng, alpha, n):
    return bytes(rng.choice(list(alpha), size=n).tolist())


def mutate(rng, s, k, alpha):
    s = bytearray(s)
    for _ in range(k):
        op = int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(s), 1)))
        if op == 0 and len(s) > 0:
            s[pos % len(s)] = int(rng.choice(list(alpha)))
        elif op == 1 and len(s) > 1:
            del s[pos % len(s)]
        else:
            s.insert(pos, int(rng.choice(list(alpha))))
    return bytes(s)


def run_engine_trace(pairs, matrix, gaps, size, seq_cap=256, x_drop=None):
    cfg = EngineConfig(
        batch=len(pairs),
        min_size=size[0],
        max_size=size[1],
        seq_cap=seq_cap,
        n_rows=getattr(matrix, "ROWS", 1),
        trace=True,
        x_drop=x_drop is not None,
    )
    fn = build_engine(cfg)
    Sprof, CRow, qlen, rlen = pack_pairs(pairs, matrix, cfg)
    score, qi, rj, iters, trace, meta = fn(
        Sprof, CRow, qlen, rlen, gaps.open, gaps.extend, x_drop or 0
    )
    et = EngineTrace(np.asarray(trace), np.asarray(meta), int(iters))
    return (
        np.asarray(score),
        np.asarray(qi),
        np.asarray(rj),
        et,
    )


def oracle_cigar(q, r, matrix, gaps, size, x_drop=None):
    a = BlockOracle(trace=True, x_drop=x_drop is not None)
    pq = PaddedBytes.from_bytes(q, size[1], matrix)
    pr = PaddedBytes.from_bytes(r, size[1], matrix)
    a.align(pq, pr, matrix, gaps, size, x_drop or 0)
    res = a.res()
    cig = a.cigar(res.query_idx, res.reference_idx)
    return res, str(cig)


def check_pairs(pairs, matrix, gaps, size, seq_cap=256, x_drop=None):
    score, qi, rj, et = run_engine_trace(
        pairs, matrix, gaps, size, seq_cap=seq_cap, x_drop=x_drop
    )
    for k, (q, r) in enumerate(pairs):
        res, want = oracle_cigar(q, r, matrix, gaps, size, x_drop=x_drop)
        assert int(score[k]) == res.score, (k, int(score[k]), res.score)
        assert int(qi[k]) == res.query_idx and int(rj[k]) == res.reference_idx, k
        got = str(et.cigar(k, int(qi[k]), int(rj[k])))
        assert got == want, f"pair {k}: engine {got} != oracle {want}\nq={q!r}\nr={r!r}"


def test_trace_golden():
    # reference: src/scan_block.rs:2052-2103 (test_trace) incl. the README
    # example 2M6I16M3D
    gaps = Gaps(open=-11, extend=-1)
    pairs = [
        (b"AAAA", b"AARA"),
        (b"AAAA", b"RRRR"),
        (b"AAAA", b"AAA"),
        (b"CAGGATTAGCGGATCACG", b"CTGGAGTCTTTTAGCGGATCACGC"),
    ]
    check_pairs(pairs, BLOSUM62, gaps, (16, 16), seq_cap=128)
    check_pairs(pairs, BLOSUM62, gaps, (16, 64), seq_cap=128)


def test_trace_random_protein_adaptive():
    rng = np.random.default_rng(42)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(12):
        n = int(rng.integers(20, 150))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 5, AA)))
    check_pairs(pairs, BLOSUM62, gaps, (16, 64), seq_cap=384)


def test_trace_random_dna_grow_shrink():
    rng = np.random.default_rng(7)
    gaps = Gaps(open=-2, extend=-1)
    pairs = []
    for _ in range(8):
        n = int(rng.integers(50, 200))
        q = rand_seq(rng, DNA, n)
        pairs.append((q, mutate(rng, q, n // 3, DNA)))
    check_pairs(pairs, NW1, gaps, (16, 128), seq_cap=512)


def test_trace_x_drop():
    rng = np.random.default_rng(3)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(8):
        n = int(rng.integers(30, 120))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 6, AA)))
    check_pairs(pairs, BLOSUM62, gaps, (16, 32), seq_cap=384, x_drop=50)


def test_trace_cigar_consistency():
    # CIGAR ops must sum to the end position (examples/verify_trace.rs:8-29)
    rng = np.random.default_rng(11)
    gaps = Gaps(open=-5, extend=-1)
    pairs = []
    for _ in range(10):
        n = int(rng.integers(10, 180))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 2, AA)))
    score, qi, rj, et = run_engine_trace(pairs, BLOSUM62, gaps, (16, 64), seq_cap=512)
    from block_aligner_jax.core.cigar import Operation

    for k in range(len(pairs)):
        cig = et.cigar(k, int(qi[k]), int(rj[k]))
        di = dj = 0
        for ol in cig.to_vec():
            if ol.op in (Operation.M, Operation.Eq, Operation.X):
                di += ol.len
                dj += ol.len
            elif ol.op == Operation.I:
                di += ol.len
            else:
                dj += ol.len
        assert di == int(qi[k]) and dj == int(rj[k])
