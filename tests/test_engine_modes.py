"""Engine mode flags (LOCAL_START, FREE_QUERY_START/END_GAPS) vs the oracle.

Mirrors the reference mode tests (reference: src/scan_block.rs:2170-2230)
plus randomized parity including trace CIGARs.
"""

import numpy as np
import pytest

from block_aligner_jax import BLOSUM62, BlockOracle, Gaps, PaddedBytes
from block_aligner_jax.core.traceback import EngineTrace
from block_aligner_jax.ops.engine import EngineConfig, build_engine, pack_pairs

AA = b"ACDEFGHIKLMNPQRSTVWY"


def rand_seq(rng, n):
    return bytes(rng.choice(list(AA), size=n).tolist())


def mutate(rng, s, k):
    s = bytearray(s)
    for _ in range(k):
        op = int(rng.integers(0, 3))
        pos = int(rng.integers(0, max(len(s), 1)))
        if op == 0 and len(s) > 0:
            s[pos % len(s)] = int(rng.choice(list(AA)))
        elif op == 1 and len(s) > 1:
            del s[pos % len(s)]
        else:
            s.insert(pos, int(rng.choice(list(AA))))
    return bytes(s)


def run_both(pairs, size, seq_cap, *, local_start=False, fq_start=False,
             fq_end=False, x_drop=None, trace=False):
    cfg = EngineConfig(
        batch=len(pairs), min_size=size[0], max_size=size[1], seq_cap=seq_cap,
        n_rows=27, trace=trace, x_drop=x_drop is not None,
        local_start=local_start, free_query_start_gaps=fq_start,
        free_query_end_gaps=fq_end,
    )
    fn = build_engine(cfg)
    Sprof, CRow, qlen, rlen = pack_pairs(pairs, BLOSUM62, cfg)
    gaps = Gaps(open=-11, extend=-1)
    out = fn(Sprof, CRow, qlen, rlen, gaps.open, gaps.extend, x_drop or 0)
    if trace:
        score, qi, rj, iters, tr, meta = out
        et = EngineTrace(np.asarray(tr), np.asarray(meta), int(iters),
                         local_start=local_start,
                         free_query_start_gaps=fq_start)
    else:
        score, qi, rj, _ = out
        et = None

    for k, (q, r) in enumerate(pairs):
        a = BlockOracle(
            trace=trace, x_drop=x_drop is not None, local_start=local_start,
            free_query_start_gaps=fq_start, free_query_end_gaps=fq_end,
        )
        pq = PaddedBytes.from_bytes(q, size[1], BLOSUM62)
        pr = PaddedBytes.from_bytes(r, size[1], BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, size, x_drop or 0)
        res = a.res()
        assert int(score[k]) == res.score, (k, int(score[k]), res.score)
        assert (int(qi[k]), int(rj[k])) == (res.query_idx, res.reference_idx), k
        if trace:
            want = str(a.cigar(res.query_idx, res.reference_idx))
            got = str(et.cigar(k, int(qi[k]), int(rj[k])))
            assert got == want, (k, got, want)


def _pairs(seed, n, lo, hi, related=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rand_seq(rng, int(rng.integers(lo, hi)))
        b = mutate(rng, a, len(a) // 4) if related else rand_seq(
            rng, int(rng.integers(lo, hi)))
        out.append((a, b))
    return out


def test_local_start():
    # local start zero-clamps block scores; x-drop result semantics
    # (reference: src/scan_block.rs:2170-2230 uses it with x_drop)
    pairs = _pairs(31, 8, 10, 100)
    run_both(pairs, (16, 32), 192, local_start=True, x_drop=100, trace=True)


def test_free_query_start_gaps():
    pairs = _pairs(32, 8, 10, 100, related=False)
    run_both(pairs, (16, 32), 192, fq_start=True, trace=True)
    run_both(pairs, (16, 32), 192, fq_start=True, x_drop=50, trace=True)


def test_free_query_end_gaps():
    # query must fit in the min block (reference: src/scan_block.rs:860)
    rng = np.random.default_rng(33)
    pairs = []
    for _ in range(8):
        q = rand_seq(rng, int(rng.integers(5, 14)))
        r = rand_seq(rng, int(rng.integers(20, 120)))
        pairs.append((q, r))
    run_both(pairs, (16, 32), 192, fq_end=True)
    run_both(pairs, (16, 16), 192, fq_end=True, fq_start=True)
