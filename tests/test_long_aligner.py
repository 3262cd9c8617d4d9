"""Long-sequence aligners vs the oracle: whole sequences on the device,
capacity sized per batch."""

import numpy as np

from block_aligner_jax import (BLOSUM62, BlockOracle, Gaps, LongBatchAligner,
                               NucMatrix, PaddedBytes)

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


def test_long_segmented_global():
    rng = np.random.default_rng(71)
    gaps = Gaps(open=-6, extend=-2)
    matrix = NucMatrix.new_simple(2, -4)
    pairs = []
    for _ in range(6):
        n = int(rng.integers(600, 1200))
        q = rand_seq(rng, DNA, n)
        pairs.append((q, mutate(rng, q, n // 8, DNA)))
    pairs.append((b"ACGT" * 10, b"ACGT" * 10))
    pairs.append((rand_seq(rng, DNA, 900), rand_seq(rng, DNA, 700)))

    al = LongBatchAligner(matrix, gaps, block=32, batch=8)
    res = al.align_batch(pairs)

    a = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 32, matrix)
        pr = PaddedBytes.from_bytes(r, 32, matrix)
        a.align(pq, pr, matrix, gaps, (32, 32), 0)
        assert res[k].score == a.res().score, (k, res[k].score, a.res().score)


def test_long_segmented_x_drop():
    rng = np.random.default_rng(72)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(5):
        n = int(rng.integers(500, 1000))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 10, AA)))

    al = LongBatchAligner(BLOSUM62, gaps, block=32, batch=8,
                          x_drop=100)
    res = al.align_batch(pairs)
    a = BlockOracle(x_drop=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 32, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 32, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (32, 32), 100)
        got = (res[k].score, res[k].query_idx, res[k].reference_idx)
        want = (a.res().score, a.res().query_idx, a.res().reference_idx)
        assert got == want, (k, got, want)


def test_long_segmented_trace_cigars():
    # long trace: CIGARs must match the scalar oracle exactly
    rng = np.random.default_rng(75)
    gaps = Gaps(open=-6, extend=-2)
    matrix = NucMatrix.new_simple(2, -4)
    pairs = []
    for _ in range(5):
        n = int(rng.integers(600, 1100))
        q = rand_seq(rng, DNA, n)
        pairs.append((q, mutate(rng, q, n // 8, DNA)))
    pairs.append((b"ACGT" * 10, b"ACGT" * 10))

    al = LongBatchAligner(matrix, gaps, block=32, batch=8,
                          trace=True)
    res = al.align_batch(pairs)

    for k, (q, r) in enumerate(pairs):
        a = BlockOracle(trace=True)
        pq = PaddedBytes.from_bytes(q, 32, matrix)
        pr = PaddedBytes.from_bytes(r, 32, matrix)
        a.align(pq, pr, matrix, gaps, (32, 32), 0)
        assert res[k].score == a.res().score, (k, res[k].score, a.res().score)
        want = str(a.cigar(len(q), len(r)))
        got = str(al.cigar(k, len(q), len(r)))
        assert got == want, (k, got, want)


def test_long_segmented_trace_x_drop():
    rng = np.random.default_rng(76)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(4):
        n = int(rng.integers(500, 900))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 10, AA)))

    al = LongBatchAligner(BLOSUM62, gaps, block=32, batch=8,
                          x_drop=100, trace=True)
    res = al.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        a = BlockOracle(trace=True, x_drop=True)
        pq = PaddedBytes.from_bytes(q, 32, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 32, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (32, 32), 100)
        got = (res[k].score, res[k].query_idx, res[k].reference_idx)
        want = (a.res().score, a.res().query_idx, a.res().reference_idx)
        assert got == want, (k, got, want)
        wc = str(a.cigar(want[1], want[2]))
        gc = str(al.cigar(k, got[1], got[2]))
        assert gc == wc, (k, gc, wc)


def _rand_profile(rng, n, S, ge=-1):
    from block_aligner_jax import AAProfile

    prof = AAProfile(n, 2048, ge)
    base = rng.integers(-4, 3, size=(n, 26))
    cons = rand_seq(rng, AA, n)
    base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = (
        rng.integers(4, 12, size=n)
    )
    prof.pos_scores[1 : n + 1, :26] = base
    prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
    prof.gap_close_C[: n + 1] = 0
    prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
    return prof, cons


def test_long_segmented_profile():
    """Sequence-to-PSSM for profiles/queries of several hundred
    positions, bit-exact vs the scalar oracle."""
    rng = np.random.default_rng(9)
    gaps = Gaps(open=-11, extend=-1)
    S = 16
    pairs = []
    for _ in range(6):
        n = int(rng.integers(300, 700))
        prof, cons = _rand_profile(rng, n, S)
        q = bytearray(cons)
        for _ in range(n // 5):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), prof))
    al = LongBatchAligner(BLOSUM62, gaps, block=S, batch=8,
                          profile=True)
    got = al.align_batch(pairs)
    orc = BlockOracle()
    for k, (q, prof) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, S, prof)
        orc.align_profile(pq, prof, (S, S), 0)
        assert got[k].score == orc.res().score, (k, got[k], orc.res())


def test_long_segmented_profile_trace():
    rng = np.random.default_rng(31)
    gaps = Gaps(open=-11, extend=-1)
    S = 16
    pairs = []
    for _ in range(4):
        n = int(rng.integers(300, 500))
        prof, cons = _rand_profile(rng, n, S)
        q = bytearray(cons)
        for _ in range(n // 6):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), prof))
    al = LongBatchAligner(BLOSUM62, gaps, block=S, batch=8,
                          profile=True, trace=True)
    got = al.align_batch(pairs)
    for k, (q, prof) in enumerate(pairs):
        orc = BlockOracle(trace=True)
        pq = PaddedBytes.from_bytes(q, S, prof)
        orc.align_profile(pq, prof, (S, S), 0)
        w = orc.res()
        assert got[k].score == w.score, (k, got[k], w)
        wc = str(orc.cigar(w.query_idx, w.reference_idx))
        gc = str(al.cigar(k, got[k].query_idx, got[k].reference_idx))
        assert gc == wc, (k, gc, wc)


def test_long_segmented_local_start():
    rng = np.random.default_rng(43)
    gaps = Gaps(open=-11, extend=-1)
    S = 16
    pairs = []
    for _ in range(6):
        n = int(rng.integers(300, 600))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 6, AA)))
    al = LongBatchAligner(BLOSUM62, gaps, block=S, batch=8,
                          local_start=True, x_drop=100)
    got = al.align_batch(pairs)
    orc = BlockOracle(local_start=True, x_drop=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        orc.align(pq, pr, BLOSUM62, gaps, (S, S), 100)
        w = orc.res()
        assert (got[k].score, got[k].query_idx, got[k].reference_idx) == (
            w.score, w.query_idx, w.reference_idx), (k, got[k], w)


def test_long_segmented_local_start_trace():
    """Long local-start trace: the zero-mask bit must reach the walker
    with the mode flags; CIGARs oracle-exact."""
    rng = np.random.default_rng(47)
    gaps = Gaps(open=-11, extend=-1)
    S = 16
    pairs = []
    for _ in range(5):
        n = int(rng.integers(300, 600))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 6, AA)))
    al = LongBatchAligner(BLOSUM62, gaps, block=S, batch=8,
                          local_start=True, x_drop=100, trace=True)
    got = al.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        orc = BlockOracle(local_start=True, x_drop=True, trace=True)
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        orc.align(pq, pr, BLOSUM62, gaps, (S, S), 100)
        w = orc.res()
        assert (got[k].score, got[k].query_idx, got[k].reference_idx) == (
            w.score, w.query_idx, w.reference_idx), (k, got[k], w)
        wc = str(orc.cigar(w.query_idx, w.reference_idx))
        gc = str(al.cigar(k, got[k].query_idx, got[k].reference_idx))
        assert gc == wc, (k, gc, wc)


def test_long_segmented_free_query_start_gaps_trace():
    """Long trace with free leading query gaps: the walker must keep its
    i==0 termination."""
    rng = np.random.default_rng(53)
    gaps = Gaps(open=-11, extend=-1)
    S = 16
    pairs = []
    for _ in range(5):  # unrelated pairs: leading query gaps matter
        pairs.append((rand_seq(rng, AA, int(rng.integers(200, 400))),
                      rand_seq(rng, AA, int(rng.integers(300, 600)))))
    al = LongBatchAligner(BLOSUM62, gaps, block=S, batch=8,
                          free_query_start_gaps=True, trace=True)
    got = al.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        orc = BlockOracle(free_query_start_gaps=True, trace=True)
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        orc.align(pq, pr, BLOSUM62, gaps, (S, S), 0)
        w = orc.res()
        assert got[k].score == w.score, (k, got[k], w)
        wc = str(orc.cigar(w.query_idx, w.reference_idx))
        gc = str(al.cigar(k, got[k].query_idx, got[k].reference_idx))
        assert gc == wc, (k, gc, wc)


def test_long_segmented_free_query_end_gaps():
    """Short query vs long reference with free trailing query gaps
    (the reference's semiglobal read-anchoring mode)."""
    rng = np.random.default_rng(59)
    gaps = Gaps(open=-11, extend=-1)
    S = 32
    pairs = []
    for _ in range(6):
        r = rand_seq(rng, AA, int(rng.integers(400, 700)))
        pos = int(rng.integers(0, len(r) - 40))
        q = bytearray(r[pos : pos + int(rng.integers(12, 28))])
        for _ in range(3):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), r))
    al = LongBatchAligner(BLOSUM62, gaps, block=S, batch=8,
                          free_query_start_gaps=True,
                          free_query_end_gaps=True)
    got = al.align_batch(pairs)
    orc = BlockOracle(free_query_start_gaps=True, free_query_end_gaps=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        orc.align(pq, pr, BLOSUM62, gaps, (S, S), 0)
        w = orc.res()
        assert (got[k].score, got[k].query_idx, got[k].reference_idx) == (
            w.score, w.query_idx, w.reference_idx), (k, got[k], w)


def test_long_segmented_block_512():
    """Block 512 (the reference's 1% band for 50 kbp reads) with trace:
    scores and CIGARs oracle-exact."""
    from block_aligner_jax import NucMatrix

    rng = np.random.default_rng(4)
    DNA = b"ACGT"
    matrix = NucMatrix.new_simple(2, -4)
    gaps = Gaps(open=-6, extend=-2)
    pairs = []
    for _ in range(2):
        n = int(rng.integers(2500, 3000))
        r = bytes(rng.choice(list(DNA), size=n).tolist())
        q = bytearray(r)
        for _ in range(n // 10):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(DNA)))
        pairs.append((bytes(q), r))
    al = LongBatchAligner(matrix, gaps, block=512, batch=8,
                          trace=True)
    got = al.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        orc = BlockOracle(trace=True)
        pq = PaddedBytes.from_bytes(q, 512, matrix)
        pr = PaddedBytes.from_bytes(r, 512, matrix)
        orc.align(pq, pr, matrix, gaps, (512, 512), 0)
        w = orc.res()
        assert got[k].score == w.score, (k, got[k], w)
        assert str(al.cigar(k, w.query_idx, w.reference_idx)) == \
            str(orc.cigar(w.query_idx, w.reference_idx)), k


def test_long_adaptive_x_drop():
    """Adaptive x-drop over 1.5-2.5 kbp reads: scores, best positions and
    the X_DROP_ITER termination match the oracle, including grow/restore
    around an inserted block and an early x-drop stop."""
    from block_aligner_jax import LongAdaptiveAligner

    rng = np.random.default_rng(73)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(4):
        n = int(rng.integers(1500, 2500))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 10, AA)))
    # inserted block: grow + checkpoint restore
    n = 1800
    q = rand_seq(rng, AA, n)
    r = q[: n // 2] + rand_seq(rng, AA, 300) + q[n // 2 :]
    pairs.append((q, r))
    # divergent tail: x-drop terminates mid-sequence
    q = rand_seq(rng, AA, 2000)
    r = q[:700] + rand_seq(rng, AA, 1300)
    pairs.append((q, r))

    al = LongAdaptiveAligner(BLOSUM62, gaps, (128, 512), batch=8,
                             seq_cap=4096, x_drop=100)
    res = al.align_batch(pairs)
    a = BlockOracle(x_drop=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 512, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 512, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (128, 512), 100)
        got = (res[k].score, res[k].query_idx, res[k].reference_idx)
        want = (a.res().score, a.res().query_idx, a.res().reference_idx)
        assert got == want, (k, got, want)


def test_batch_aligner_over_budget_delegation():
    """A BatchAligner declared for 20 kbp sequences keeps them whole in
    device memory on the engine: adaptive x-drop bands and fixed blocks
    stay oracle-exact with no segmenting or delegation."""
    from block_aligner_jax.api import BatchAligner

    rng = np.random.default_rng(74)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(3):
        n = int(rng.integers(400, 800))
        q = rand_seq(rng, AA, n)
        pairs.append((q, mutate(rng, q, n // 10, AA)))

    ba = BatchAligner(BLOSUM62, gaps, size=(128, 512), batch=4,
                      seq_cap=20000, x_drop=100)
    assert ba.route == "engine" and ba.seq_capacity >= 20000
    res = ba.align_batch(pairs)
    a = BlockOracle(x_drop=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 512, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 512, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (128, 512), 100)
        assert res[k] == a.res(), (k, res[k], a.res())

    ba2 = BatchAligner(BLOSUM62, gaps, size=(128, 128), batch=4,
                       seq_cap=20000)
    assert ba2.route == "engine"
    res2 = ba2.align_batch(pairs)
    a2 = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 128, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 128, BLOSUM62)
        a2.align(pq, pr, BLOSUM62, gaps, (128, 128), 0)
        assert res2[k].score == a2.res().score, (k, res2[k], a2.res())
