"""Randomized accuracy tests: scalar oracle vs exact full DP, in the spirit
of the reference accuracy harness (reference: examples/accuracy.rs)."""

import numpy as np
import pytest

from block_aligner_jax import BLOSUM62, BlockOracle, Gaps, NW1, PaddedBytes
from block_aligner_jax.core.full_dp import global_align_score

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"


def rand_seq(rng, alpha, length):
    return bytes(rng.choice(list(alpha)) for _ in range(length))


def mutate(rng, s, k, alpha, insert_len=0):
    s = bytearray(s)
    for _ in range(k):
        op = rng.integers(0, 3)
        pos = int(rng.integers(0, len(s)))
        if op == 0:  # substitute
            s[pos] = int(rng.choice(list(alpha)))
        elif op == 1:  # delete
            del s[pos]
        else:  # insert
            s.insert(pos, int(rng.choice(list(alpha))))
    if insert_len:
        pos = int(rng.integers(0, len(s)))
        ins = [int(rng.choice(list(alpha))) for _ in range(insert_len)]
        s[pos:pos] = ins
    return bytes(s)


@pytest.mark.parametrize("length,k", [(50, 5), (100, 10), (100, 50)])
def test_random_dna_global(length, k):
    rng = np.random.default_rng(1234)
    gaps = Gaps(open=-2, extend=-1)
    a = BlockOracle()
    wrong = 0
    total = 20
    for _ in range(total):
        q = rand_seq(rng, DNA, length)
        r = mutate(rng, q, k, DNA)
        exact = global_align_score(q, r, NW1, gaps)
        pq = PaddedBytes.from_bytes(q, 256, NW1)
        pr = PaddedBytes.from_bytes(r, 256, NW1)
        a.align(pq, pr, NW1, gaps, (32, 256), 0)
        got = a.res().score
        # the block heuristic only ever scores real paths
        assert got <= exact, (q, r, got, exact)
        if got != exact:
            wrong += 1
    assert wrong <= total // 10, f"{wrong}/{total} wrong"


def test_random_protein_global():
    rng = np.random.default_rng(42)
    gaps = Gaps(open=-11, extend=-1)
    a = BlockOracle()
    wrong = 0
    total = 20
    for _ in range(total):
        q = rand_seq(rng, AA, 80)
        r = mutate(rng, q, 8, AA)
        exact = global_align_score(q, r, BLOSUM62, gaps)
        pq = PaddedBytes.from_bytes(q, 256, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 256, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (32, 256), 0)
        got = a.res().score
        assert got <= exact
        if got != exact:
            wrong += 1
    assert wrong <= 2


@pytest.mark.parametrize("length,alpha_name", [
    (100, "dna"), (1000, "dna"), (100, "aa"), (1000, "aa"),
])
def test_reference_len_k_grid(length, alpha_name):
    """The reference accuracy sweep's len x k grid (reference:
    examples/accuracy.rs:17-34: lengths 100/1k/10k, k from len/10 to
    len/2, rand_mutate + big inserts): block scores are always real-path
    lower bounds of the exact score, and the adaptive band recovers the
    exact score for the overwhelming majority of pairs."""
    rng = np.random.default_rng(1234)
    if alpha_name == "dna":
        alpha, matrix, gaps = DNA, NW1, Gaps(open=-2, extend=-1)
    else:
        alpha, matrix, gaps = AA, BLOSUM62, Gaps(open=-11, extend=-1)
    size = (32, 256) if length <= 100 else (32, 2048)
    a = BlockOracle()
    n_per_k = 4
    wrong = 0
    total = 0
    for k in (length // 10, length // 5, length // 2):
        for _ in range(n_per_k):
            q = rand_seq(rng, alpha, length)
            insert = int(rng.integers(0, max(length // 10, 2)))
            r = mutate(rng, q, k, alpha, insert_len=insert)
            exact = global_align_score(q, r, matrix, gaps)
            pq = PaddedBytes.from_bytes(q, size[1], matrix)
            pr = PaddedBytes.from_bytes(r, size[1], matrix)
            a.align(pq, pr, matrix, gaps, size, 0)
            got = a.res().score
            # the block heuristic only ever scores real paths
            assert got <= exact, (length, k, got, exact)
            total += 1
            if got != exact:
                wrong += 1
    # the reference's observed wrong rates at these bands are <= a few
    # percent; allow slack for the k = len/2 extremes
    assert wrong <= total // 4, f"{wrong}/{total} wrong"


def test_reference_10k_band():
    """The grid's 10 kbp row (one pair per k; full-DP oracle ~100M cells,
    so kept small): reference sizes 32..2048."""
    rng = np.random.default_rng(99)
    gaps = Gaps(open=-2, extend=-1)
    a = BlockOracle()
    length = 10000
    for k in (length // 10, length // 2):
        q = rand_seq(rng, DNA, length)
        r = mutate(rng, q, k, DNA, insert_len=100)
        exact = global_align_score(q, r, NW1, gaps)
        pq = PaddedBytes.from_bytes(q, 2048, NW1)
        pr = PaddedBytes.from_bytes(r, 2048, NW1)
        a.align(pq, pr, NW1, gaps, (32, 2048), 0)
        got = a.res().score
        assert got <= exact, (k, got, exact)


def test_cigar_consistency_random():
    """CIGARs must sum to the end position and rescore to the reported score
    (reference: examples/verify_trace.rs:8-29)."""
    rng = np.random.default_rng(7)
    gaps = Gaps(open=-2, extend=-1)
    a = BlockOracle(trace=True)
    from block_aligner_jax import Operation

    for _ in range(10):
        q = rand_seq(rng, DNA, 60)
        r = mutate(rng, q, 10, DNA)
        pq = PaddedBytes.from_bytes(q, 64, NW1)
        pr = PaddedBytes.from_bytes(r, 64, NW1)
        a.align(pq, pr, NW1, gaps, (32, 64), 0)
        res = a.res()
        cg = a.cigar_eq(pq, pr, res.query_idx, res.reference_idx)
        di = dj = 0
        score = 0
        i = j = 0
        for ol in cg.to_vec():
            if ol.op in (Operation.M, Operation.Eq, Operation.X):
                for _k in range(ol.len):
                    score += NW1.get(q[i], r[j])
                    i += 1
                    j += 1
            elif ol.op == Operation.I:
                score += gaps.open + (ol.len - 1) * gaps.extend
                i += ol.len
            elif ol.op == Operation.D:
                score += gaps.open + (ol.len - 1) * gaps.extend
                j += ol.len
        assert (i, j) == (res.query_idx, res.reference_idx)
        assert score == res.score
