"""Batched-engine sequence-to-PSSM alignment vs the scalar oracle.

Mirrors the reference profile tests (reference: src/scan_block.rs:2122-2168)
plus randomized position-specific score / gap-cost parity.
"""

import numpy as np
import pytest

from block_aligner_jax import AAProfile, BlockOracle, PaddedBytes
from block_aligner_jax.core.traceback import EngineTrace
from block_aligner_jax.ops.engine import EngineConfig, build_engine, pack_profiles

AA = b"ACDEFGHIKLMNPQRSTVWY"


def rand_profile(rng, n, block_size, gap_extend=-1):
    p = AAProfile(n, block_size, gap_extend)
    for i in range(1, n + 1):
        for c in AA:
            p.set(i, c, int(rng.integers(-8, 12)))
        # other letters stay at -128-ish default? give them small scores too
        for c in b"BJOUXZ":
            p.set(i, c, int(rng.integers(-8, 2)))
    for i in range(n + 1):
        p.set_gap_open_C(i, int(rng.integers(-14, -2)))
        p.set_gap_close_C(i, int(rng.integers(-3, 1)))
        p.set_gap_open_R(i, int(rng.integers(-14, -2)))
    return p


def rand_seq(rng, n):
    return bytes(rng.choice(list(AA), size=n).tolist())


def run_engine(pairs, size, seq_cap, trace=False, x_drop=None):
    cfg = EngineConfig(
        batch=len(pairs),
        min_size=size[0],
        max_size=size[1],
        seq_cap=seq_cap,
        n_rows=27,
        profile=True,
        trace=trace,
        x_drop=x_drop is not None,
    )
    fn = build_engine(cfg)
    Sprof, CRow, qlen, rlen, GOC, GCC, GOR, ge = pack_profiles(pairs, cfg)
    out = fn(Sprof, CRow, qlen, rlen, 0, ge, x_drop or 0,
             GOC=GOC, GCC=GCC, GOR=GOR)
    if trace:
        score, qi, rj, iters, tr, meta = out
        et = EngineTrace(np.asarray(tr), np.asarray(meta), int(iters))
        return np.asarray(score), np.asarray(qi), np.asarray(rj), et
    score, qi, rj, iters = out
    return np.asarray(score), np.asarray(qi), np.asarray(rj), None


def oracle_profile(q, prof, size, trace=False, x_drop=None):
    a = BlockOracle(trace=trace, x_drop=x_drop is not None)
    pq = PaddedBytes.from_bytes(q, size[1], prof)
    a.align_profile(pq, prof, size, x_drop or 0)
    res = a.res()
    cig = None
    if trace:
        cig = str(a.cigar(res.query_idx, res.reference_idx))
    return res, cig


def check(pairs, size, seq_cap, trace=False, x_drop=None):
    score, qi, rj, et = run_engine(pairs, size, seq_cap, trace=trace, x_drop=x_drop)
    for k, (q, prof) in enumerate(pairs):
        res, cig = oracle_profile(q, prof, size, trace=trace, x_drop=x_drop)
        assert int(score[k]) == res.score, (k, int(score[k]), res.score)
        assert (int(qi[k]), int(rj[k])) == (res.query_idx, res.reference_idx), k
        if trace:
            got = str(et.cigar(k, int(qi[k]), int(rj[k])))
            assert got == cig, f"pair {k}: engine {got} != oracle {cig}"


def test_profile_golden():
    # reference test_profile semantics: simple match/mismatch profile with
    # uniform gap costs behaves like a matrix (reference: src/scan_block.rs:2122)
    prof = AAProfile.from_bytes(b"AAAA", 16, 1, -1, -1, 0, -1, -1)
    pairs = [(b"AAAA", prof), (b"AARA", prof), (b"AAA", prof)]
    check(pairs, (16, 16), 128)


def test_profile_random_small():
    rng = np.random.default_rng(21)
    pairs = []
    for _ in range(10):
        n = int(rng.integers(8, 60))
        prof = rand_profile(rng, n, 64)
        q = rand_seq(rng, int(rng.integers(8, 60)))
        pairs.append((q, prof))
    check(pairs, (16, 64), 192)


def test_profile_random_adaptive_trace():
    rng = np.random.default_rng(22)
    pairs = []
    for _ in range(6):
        n = int(rng.integers(30, 100))
        prof = rand_profile(rng, n, 64, gap_extend=-2)
        q = rand_seq(rng, int(rng.integers(30, 100)))
        pairs.append((q, prof))
    check(pairs, (16, 64), 256, trace=True)


def test_profile_x_drop():
    rng = np.random.default_rng(23)
    pairs = []
    for _ in range(6):
        n = int(rng.integers(20, 80))
        prof = rand_profile(rng, n, 32)
        q = rand_seq(rng, int(rng.integers(20, 80)))
        pairs.append((q, prof))
    check(pairs, (16, 32), 192, x_drop=50)
