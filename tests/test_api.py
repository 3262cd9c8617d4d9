"""High-level BatchAligner / ProfileAligner API behavior."""

import numpy as np

import pytest

from block_aligner_jax import (
    AAProfile,
    BatchAligner,
    BLOSUM62,
    BlockOracle,
    Gaps,
    NW1,
    PaddedBytes,
    ProfileAligner,
)
from block_aligner_jax.api import pick_route


def oracle(q, r, matrix, gaps, size, trace=False, x_drop=None):
    a = BlockOracle(trace=trace, x_drop=x_drop is not None)
    pq = PaddedBytes.from_bytes(q, size[1], matrix)
    pr = PaddedBytes.from_bytes(r, size[1], matrix)
    a.align(pq, pr, matrix, gaps, size, x_drop or 0)
    return a


def test_batch_aligner_trace_cigars():
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, size=(16, 32), batch=4, seq_cap=128, trace=True)
    pairs = [
        (b"CAGGATTAGCGGATCACG", b"CTGGAGTCTTTTAGCGGATCACGC"),
        (b"MKVLAT", b"MKVIATQ"),
    ]
    res = al.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        o = oracle(q, r, BLOSUM62, gaps, (16, 32), trace=True)
        assert res[k].score == o.res().score
        want = str(o.cigar(o.res().query_idx, o.res().reference_idx))
        got = str(al.cigar(k, res[k].query_idx, res[k].reference_idx))
        assert got == want
        want_eq = str(o.cigar_eq(
            PaddedBytes.from_bytes(q, 32, BLOSUM62),
            PaddedBytes.from_bytes(r, 32, BLOSUM62),
            o.res().query_idx, o.res().reference_idx,
        ))
        got_eq = str(al.cigar_eq(k, q, r, res[k].query_idx, res[k].reference_idx))
        assert got_eq == want_eq


def test_batch_aligner_lane_routing():
    gaps = Gaps(open=-2, extend=-1)
    al = BatchAligner(NW1, gaps, size=(16, 16), batch=8, seq_cap=100)
    # fixed-size global no-trace: the CUDA kernel on a GPU, the engine here
    assert al.route == "engine"
    assert pick_route(16, 16, backend="gpu") == "cuda"
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(5):
        n = int(rng.integers(10, 90))
        pairs.append((
            bytes(rng.choice(list(b"ACGT"), size=n).tolist()),
            bytes(rng.choice(list(b"ACGT"), size=n).tolist()),
        ))
    res = al.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        o = oracle(q, r, NW1, gaps, (16, 16))
        assert res[k].score == o.res().score, k


def test_align_all_pipelined_multibatch():
    """align_all with >1 chunk uses the stage/dispatch/decode pipeline
    (pack of batch k+1 overlaps device compute of batch k); results must
    match the sequential align_batch loop and the oracle, sorted or not."""
    gaps = Gaps(open=-11, extend=-1)
    rng = np.random.default_rng(11)
    aa = list(b"ACDEFGHIKLMNPQRSTVWY")
    pairs = []
    for _ in range(20):
        n = int(rng.integers(8, 100))
        q = bytes(rng.choice(aa, size=n).tolist())
        r = bytearray(q)
        for p in rng.integers(0, n, size=max(1, n // 8)):
            r[p] = aa[int(rng.integers(0, 20))]
        pairs.append((q, bytes(r)))

    for size in [(32, 32), (16, 32)]:  # fixed block / adaptive
        al = BatchAligner(BLOSUM62, gaps, size=size, batch=8, seq_cap=128)
        for sort in (True, False):
            res = al.align_all(pairs, sort=sort)
            for k, (q, r) in enumerate(pairs):
                o = oracle(q, r, BLOSUM62, gaps, size)
                assert res[k].score == o.res().score, (size, sort, k)
            seq = []
            for k in range(0, len(pairs), 8):
                seq.extend(al.align_batch(pairs[k : k + 8]))
            assert [x.score for x in res] == [x.score for x in seq]


def test_batch_aligner_x_drop_engine():
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, size=(16, 32), batch=2, seq_cap=128, x_drop=50)
    assert al.route == "engine"
    q, r = b"MKVLATGQHEWVKL", b"MKVLATGQHEWVKL"
    res = al.align_batch([(q, r)])
    o = oracle(q, r, BLOSUM62, gaps, (16, 32), x_drop=50)
    assert res[0].score == o.res().score
    assert (res[0].query_idx, res[0].reference_idx) == (
        o.res().query_idx, o.res().reference_idx)


def test_profile_aligner():
    prof = AAProfile.from_bytes(b"AAAA", 32, 1, -1, -1, 0, -1, -1)
    pa = ProfileAligner(size=(16, 32), batch=2, seq_cap=128, trace=True)
    res = pa.align_batch([(b"AARA", prof)])
    a = BlockOracle(trace=True)
    pq = PaddedBytes.from_bytes(b"AARA", 32, prof)
    a.align_profile(pq, prof, (16, 32), 0)
    assert res[0].score == a.res().score
    want = str(a.cigar(a.res().query_idx, a.res().reference_idx))
    got = str(pa.cigar(0, res[0].query_idx, res[0].reference_idx))
    assert got == want


def test_batch_aligner_x_drop_lane():
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, size=(32, 32), batch=8, seq_cap=200,
                      x_drop=50)
    # fixed-size x-drop: the CUDA kernel on a GPU, the engine here
    assert al.route == "engine"
    assert pick_route(32, 32, backend="gpu") == "cuda"
    rng = np.random.default_rng(41)
    pairs = []
    for _ in range(6):
        n = int(rng.integers(20, 150))
        q = bytes(rng.choice(list(b"ACDEFGHIKLMNPQRSTVWY"), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 5):
            r[int(rng.integers(0, len(r)))] = int(
                rng.choice(list(b"ACDEFGHIKLMNPQRSTVWY")))
        pairs.append((q, bytes(r)))
    res = al.align_batch(pairs)
    o = BlockOracle(x_drop=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 32, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 32, BLOSUM62)
        o.align(pq, pr, BLOSUM62, gaps, (32, 32), 50)
        assert (res[k].score, res[k].query_idx, res[k].reference_idx) == (
            o.res().score, o.res().query_idx, o.res().reference_idx), k


def test_staged_execution_matches_align_batch():
    gaps = Gaps(open=-11, extend=-1)
    pairs = [(b"CAGGATTAGCGGATCACG", b"CTGGAGTCTTTTAGCGGATCACGC"),
             (b"MKVLAT", b"MKVIATQ")]
    # fixed block
    al = BatchAligner(BLOSUM62, gaps, size=(32, 32), batch=4, seq_cap=128)
    st = al.stage(pairs)
    a = al.align_staged(st)
    b = al.align_batch(pairs)
    assert [(r.score, r.query_idx, r.reference_idx) for r in a] == [
        (r.score, r.query_idx, r.reference_idx) for r in b]
    # adaptive
    al2 = BatchAligner(BLOSUM62, gaps, size=(16, 32), batch=4, seq_cap=128)
    st2 = al2.stage(pairs)
    a2 = al2.align_staged(st2)
    b2 = al2.align_batch(pairs)
    assert [(r.score, r.query_idx, r.reference_idx) for r in a2] == [
        (r.score, r.query_idx, r.reference_idx) for r in b2]
    # fixed-block x-drop
    al3 = BatchAligner(BLOSUM62, gaps, size=(32, 32), batch=4, seq_cap=128,
                       x_drop=50)
    st3 = al3.stage(pairs)
    a3 = al3.align_staged(st3)
    b3 = al3.align_batch(pairs)
    assert [(r.score, r.query_idx, r.reference_idx) for r in a3] == [
        (r.score, r.query_idx, r.reference_idx) for r in b3]


def test_profile_aligner_lane_path():
    """ProfileAligner fixed-block score-only PSSM batches: results match
    the oracle."""
    from block_aligner_jax import AAProfile, ProfileAligner

    rng = np.random.default_rng(47)
    AA = b"ACDEFGHIKLMNPQRSTVWY"

    def rand_profile(n):
        p = AAProfile(n, 32, -1)
        for i in range(1, n + 1):
            for c in AA:
                p.set(i, c, int(rng.integers(-8, 12)))
        for i in range(n + 1):
            p.set_gap_open_C(i, int(rng.integers(-14, -2)))
            p.set_gap_close_C(i, int(rng.integers(-3, 1)))
            p.set_gap_open_R(i, int(rng.integers(-14, -2)))
        return p

    pairs = []
    for _ in range(12):
        n = int(rng.integers(10, 90))
        q = bytes(rng.choice(list(AA), size=int(rng.integers(10, 90))).tolist())
        pairs.append((q, rand_profile(n)))

    pa = ProfileAligner(size=(32, 32), batch=16, seq_cap=160)
    assert pa.route == "engine"
    got = pa.align_batch(pairs)
    orc = BlockOracle()
    for k, (q, prof) in enumerate(pairs):
        orc.align_profile(PaddedBytes.from_bytes(q, 32, prof), prof,
                          (32, 32), 0)
        assert got[k] == orc.res(), (k, got[k], orc.res())


def test_profile_aligner_lane_trace_and_xdrop():
    """ProfileAligner fixed-block trace and x-drop profile modes match the
    oracle (scores, end positions, CIGARs)."""
    from block_aligner_jax import AAProfile, ProfileAligner

    rng = np.random.default_rng(53)
    AA = b"ACDEFGHIKLMNPQRSTVWY"

    def rand_profile(n):
        p = AAProfile(n, 32, -1)
        for i in range(1, n + 1):
            for c in AA:
                p.set(i, c, int(rng.integers(-8, 12)))
        for i in range(n + 1):
            p.set_gap_open_C(i, int(rng.integers(-14, -2)))
            p.set_gap_close_C(i, int(rng.integers(-3, 1)))
            p.set_gap_open_R(i, int(rng.integers(-14, -2)))
        return p

    pairs = []
    for _ in range(8):
        n = int(rng.integers(10, 80))
        q = bytes(rng.choice(list(AA), size=int(rng.integers(10, 80))).tolist())
        pairs.append((q, rand_profile(n)))

    # x-drop
    pa = ProfileAligner(size=(32, 32), batch=8, seq_cap=160, x_drop=50)
    got = pa.align_batch(pairs)
    orc = BlockOracle(x_drop=True)
    for k, (q, prof) in enumerate(pairs):
        orc.align_profile(PaddedBytes.from_bytes(q, 32, prof), prof,
                          (32, 32), 50)
        assert got[k] == orc.res(), (k, got[k], orc.res())

    # trace (scores + CIGARs)
    pa = ProfileAligner(size=(32, 32), batch=8, seq_cap=160, trace=True)
    got = pa.align_batch(pairs)
    orc = BlockOracle(trace=True)
    for k, (q, prof) in enumerate(pairs):
        orc.align_profile(PaddedBytes.from_bytes(q, 32, prof), prof,
                          (32, 32), 0)
        w = orc.res()
        assert got[k].score == w.score, k
        gc = str(pa.cigar(k, got[k].query_idx, got[k].reference_idx))
        wc = str(orc.cigar(w.query_idx, w.reference_idx))
        assert gc == wc, (k, gc, wc)


def test_profile_aligner_staged_and_align_all():
    """ProfileAligner stage/align_staged and sorted align_all agree with
    align_batch; align_profile_exp_all matches the oracle's
    align_profile_exp min sizes (reference: src/scan_block.rs:907-925)."""
    import numpy as np

    from block_aligner_jax import (AAProfile, BlockOracle, PaddedBytes,
                                   ProfileAligner, align_profile_exp_all)

    rng = np.random.default_rng(4)
    AA = b"ACDEFGHIKLMNPQRSTVWY"

    def rand_profile(n):
        prof = AAProfile(n, 2048, -1)
        base = rng.integers(-4, 3, size=(n, 26))
        cons = bytes(rng.choice(list(AA), size=n).tolist())
        base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = (
            rng.integers(4, 12, size=n)
        )
        prof.pos_scores[1 : n + 1, :26] = base
        prof.gap_open_C[: n + 1] = -11
        prof.gap_close_C[: n + 1] = 0
        prof.gap_open_R[: n + 1] = -11
        return prof, cons

    pairs = []
    for _ in range(8):
        n = int(rng.integers(30, 100))
        prof, cons = rand_profile(n)
        q = bytearray(cons)
        for _ in range(n // 4):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), prof))

    pa = ProfileAligner((16, 16), batch=8, seq_cap=200)
    r1 = pa.align_batch(pairs)
    r2 = pa.align_staged(pa.stage(pairs))
    r3 = pa.align_all(pairs)
    assert [x.score for x in r1] == [x.score for x in r2] \
        == [x.score for x in r3]

    orc = BlockOracle()
    tg = []
    for q, prof in pairs:
        pq = PaddedBytes.from_bytes(q, 64, prof)
        orc.align_profile(pq, prof, (64, 64), 0)
        tg.append(orc.res().score)
    res, ms = align_profile_exp_all(pairs, tg, (16, 64), batch=8,
                                    seq_cap=200)
    for k, (q, prof) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 64, prof)
        want_ms = orc.align_profile_exp(pq, prof, (16, 64), 0, tg[k])
        assert ms[k] == want_ms, (k, ms[k], want_ms)


def test_engine_trapdoor_audit():
    """The engine serves every configuration by design, so no BatchAligner
    warns about falling onto it; on the GPU exactly the fixed-block global
    and x-drop score modes take the CUDA kernel (pick_route)."""
    import itertools
    import warnings

    from block_aligner_jax.ops.fixed_block import BLOCKS

    for (min_s, max_s), trace, xd, fqe in itertools.product(
            [(16, 16), (32, 32), (512, 512), (16, 64), (32, 512),
             (128, 1024), (1024, 1024)],
            (False, True), (None, 50), (False, True)):
        if xd is not None and fqe:
            continue  # excluded flag combination
        assert pick_route(min_s, max_s, backend="cpu", trace=trace,
                          free_query_end_gaps=fqe) == "engine"
        want = ("cuda" if min_s == max_s and min_s in BLOCKS
                and not trace and not fqe else "engine")
        assert pick_route(min_s, max_s, backend="gpu", trace=trace,
                          free_query_end_gaps=fqe) == want
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for size in [(16, 16), (16, 64), (128, 1024)]:
            BatchAligner(BLOSUM62, Gaps(-11, -1), size, batch=4, seq_cap=64)


def test_profile_aligner_big_blocks_route():
    """Profiles at every block size and mode run on the engine (the
    reference's align_profile rides the same Block<TRACE, X_DROP, ...>
    const generics, src/scan_block.rs:89,942-995), past 8192 included."""
    for kw in ({}, {"trace": True}, {"x_drop": 50}, {"local_start": True},
               {"free_query_start_gaps": True}):
        pa = ProfileAligner((32, 1024), batch=4, seq_cap=256, **kw)
        assert pa.route == "engine", kw
    assert ProfileAligner((512, 16384), batch=4,
                          seq_cap=256).route == "engine"
    with pytest.raises(ValueError, match="unknown backend"):
        pick_route(32, 32, backend="metal")


def test_profile_aligner_adaptive_staged():
    """ProfileAligner.stage()/align_staged on an adaptive band: staged
    results match align_batch."""
    AA = b"ACDEFGHIKLMNPQRSTVWY"
    rng = np.random.default_rng(41)

    def rand_profile(n):
        prof = AAProfile(n, 2048, -1)
        base = rng.integers(-4, 3, size=(n, 26))
        cons = bytes(rng.choice(list(AA), size=n).tolist())
        base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = (
            rng.integers(4, 12, size=n)
        )
        prof.pos_scores[1 : n + 1, :26] = base
        prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
        prof.gap_close_C[: n + 1] = 0
        prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
        return prof, cons

    pairs = []
    for _ in range(6):
        n = int(rng.integers(30, 90))
        prof, cons = rand_profile(n)
        q = bytearray(cons)
        for _ in range(n // 4):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), prof))

    pa = ProfileAligner((16, 64), batch=8, seq_cap=200)
    assert pa.route == "engine"
    r1 = pa.align_batch(pairs)
    r2 = pa.align_staged(pa.stage(pairs))
    assert [x.score for x in r1] == [x.score for x in r2]
