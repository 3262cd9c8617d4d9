"""The reference's hand-checked golden cases through the batched aligner
at fixed-block, adaptive (grow/shrink) and large-band ranges, not just the
scalar oracle.

``tests/test_oracle_golden.py`` pins the oracle to the reference's unit
tests (reference: src/scan_block.rs:1902-2231); this file pins the
batched aligner to the same cases: at the reference's exact block range
the golden value is asserted directly, and at each other range the
aligner is asserted against the oracle run at that range (the oracle
chain carries the golden trust to configurations the reference test
didn't pin a literal value for)."""

import numpy as np
import pytest

from block_aligner_jax import (
    BLOSUM62,
    BYTES1,
    NW1,
    AAProfile,
    BatchAligner,
    BlockOracle,
    Gaps,
    NucMatrix,
    PaddedBytes,
    ProfileAligner,
)

GAPS_AA = Gaps(open=-11, extend=-1)
GAPS_NUC = Gaps(open=-2, extend=-1)

# (query, reference, golden score) -- reference: src/scan_block.rs
# test_no_x_drop (1908-1992)
AA_CASES = [
    (b"", b"", 0),
    (b"", b"AAAA", -14),
    (b"AAAA", b"", -14),
    (b"AARA", b"AAAA", 11),
    (b"AARAAAA", b"AAAAAAAA", 12),
    (b"AAAA", b"AAAA", 16),
    (b"RRRR", b"AAAA", -4),
    (b"AAA", b"AAAA", 1),
]
NUC_CASES = [
    (b"ATAA", b"AAAN", 0),
    (b"A" * 32, b"A" * 32, 32),
    (b"T" * 32, b"A" * 32, -32),
    (b"TA" * 16, b"A" * 32, 0),
    (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT", 7),
    (b"C", b"AAAA", -5),
    (b"AAAA", b"C", -5),
]
# reference test_bytes (2105-2120)
BYTE_CASES = [
    (b"AAAAAA", b"AAAaaA", 2),
    (b"abdefg", b"abcdefg", 4),
]


def oracle_scores(cases, matrix, gaps, size):
    orc = BlockOracle()
    out = []
    for q, r, _ in cases:
        pq = PaddedBytes.from_bytes(q, size[1], matrix)
        pr = PaddedBytes.from_bytes(r, size[1], matrix)
        orc.align(pq, pr, matrix, gaps, size, 0)
        out.append(orc.res().score)
    return out


def run_paths(cases, matrix, gaps, ref_block=16):
    """Each golden case at the reference's exact fixed range (golden
    value), an adaptive range and a large band."""
    pairs = [(q, r) for q, r, _ in cases]
    golden = [s for _, _, s in cases]

    lane = BatchAligner(matrix, gaps, (ref_block, ref_block), batch=16,
                        seq_cap=256)
    assert lane.route == "engine"
    got = lane.align_batch(pairs)
    assert [g.score for g in got] == golden

    ada = BatchAligner(matrix, gaps, (16, 32), batch=16, seq_cap=256)
    assert ada.route == "engine"
    got = ada.align_batch(pairs)
    assert [g.score for g in got] == oracle_scores(
        cases, matrix, gaps, (16, 32))

    big = BatchAligner(matrix, gaps, (32, 512), batch=16, seq_cap=1024)
    assert big.route == "engine"
    got = big.align_batch(pairs)
    assert [g.score for g in got] == oracle_scores(
        cases, matrix, gaps, (32, 512))


def test_golden_aa_all_paths():
    run_paths(AA_CASES, BLOSUM62, GAPS_AA)


def test_golden_nuc_all_paths():
    run_paths(NUC_CASES, NW1, GAPS_NUC)


def test_golden_bytes_all_paths():
    run_paths(BYTE_CASES, BYTES1, GAPS_NUC)


def test_golden_x_drop_paths():
    """reference test_x_drop (src/scan_block.rs:1994-2050): scores AND end
    positions at fixed and adaptive ranges."""
    cases = [
        (b"", b"", (0, 0, 0)),
        (b"", b"AAAA", (0, 0, 0)),
        (b"AAAA", b"", (0, 0, 0)),
        (b"AAAAAA", b"AAARRA", (14, 6, 6)),
        (b"A" * 44, b"A" * 15 + b"R" * 16 + b"A" * 13, (60, 15, 15)),
    ]
    pairs = [(q, r) for q, r, _ in cases]

    lane = BatchAligner(BLOSUM62, GAPS_AA, (16, 16), batch=16,
                        seq_cap=256, x_drop=1)
    assert lane.route == "engine"
    got = lane.align_batch(pairs)
    for k, (_, _, want) in enumerate(cases):
        assert (got[k].score, got[k].query_idx, got[k].reference_idx) \
            == want, (k, got[k], want)

    orc = BlockOracle(x_drop=True)
    ada = BatchAligner(BLOSUM62, GAPS_AA, (16, 32), batch=16,
                       seq_cap=256, x_drop=1)
    assert ada.route == "engine"
    got = ada.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 32, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 32, BLOSUM62)
        orc.align(pq, pr, BLOSUM62, GAPS_AA, (16, 32), 1)
        w = orc.res()
        assert (got[k].score, got[k].query_idx, got[k].reference_idx) \
            == (w.score, w.query_idx, w.reference_idx), (k, got[k], w)


def test_golden_trace_paths():
    """reference test_trace (src/scan_block.rs:2052-2103): exact golden
    CIGARs at the fixed range; oracle-exact CIGARs at an adaptive range
    and a large band."""
    # (query, reference, matrix, gaps, block, result, cigar, eq)
    cases = [
        (b"AAAAAA", b"AAARRA", BLOSUM62, GAPS_AA, 16,
         (14, 6, 6), "3=2X1=", True),
        (b"AAA", b"AAAA", BLOSUM62, GAPS_AA, 16, (1, 3, 4), "3M1D", False),
        (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT", NW1,
         GAPS_NUC, 16, (7, 24, 21), "2M6I16M3D", False),
        (b"AAAAAAAAATTGCGCT", b"AAAAAAAAAGCGC", NW1, GAPS_NUC, 32,
         (8, 16, 13), "9=2I4=1I", True),
        (b"AAAAAAAAATTGCGCT", b"AAAAAAAAAGCGC", NucMatrix.new_simple(2, -1),
         Gaps(open=-5, extend=-2), 32, (14, 16, 13), "9=2I4=1I", True),
    ]
    for q, r, matrix, gaps, blk, want, cig, eq in cases:
        lane = BatchAligner(matrix, gaps, (blk, blk), batch=16,
                            seq_cap=256, trace=True)
        assert lane.route == "engine"
        got = lane.align_batch([(q, r)])[0]
        assert (got.score, len(q), len(r)) == want, (got, want)
        if eq:
            gc = str(lane.cigar_eq(0, q, r, want[1], want[2]))
        else:
            gc = str(lane.cigar(0, want[1], want[2]))
        assert gc == cig, (gc, cig)

    orc = BlockOracle(trace=True)
    # group same-(matrix, gaps) cases into one batch per aligner
    groups = {}
    for q, r, matrix, gaps, _, _, _, eq in cases:
        groups.setdefault((id(matrix), id(gaps)), (matrix, gaps, []))[2] \
            .append((q, r))
    for size, seq_cap, which in (((16, 32), 256, "adaptive"),
                                 ((64, 1024), 512, "big")):
        for matrix, gaps, pairs in groups.values():
            al = BatchAligner(matrix, gaps, size, batch=16,
                              seq_cap=seq_cap, trace=True)
            assert al.route == "engine", which
            got = al.align_batch(pairs)
            for k, (q, r) in enumerate(pairs):
                pq = PaddedBytes.from_bytes(q, size[1], matrix)
                pr = PaddedBytes.from_bytes(r, size[1], matrix)
                orc.align(pq, pr, matrix, gaps, size, 0)
                w = orc.res()
                assert got[k].score == w.score, (which, q, got[k], w)
                gc = str(al.cigar(k, len(q), len(r)))
                wc = str(orc.cigar(w.query_idx, w.reference_idx))
                assert gc == wc, (which, q, gc, wc)


def test_golden_doc_example_all_paths():
    """The README/doc example (reference: src/lib.rs:8-35): score 7 and
    CIGAR 2=6I16=3D, block range 32..=32."""
    q = b"TTTTTTTTAAAAAAATTTTTTTTT"
    r = b"TTAAAAAAATTTTTTTTTTTT"
    lane = BatchAligner(NW1, GAPS_NUC, (32, 32), batch=16, seq_cap=256,
                        trace=True)
    got = lane.align_batch([(q, r)])[0]
    assert got.score == 7
    assert str(lane.cigar_eq(0, q, r, 24, 21)) == "2=6I16=3D"


def test_golden_profile_paths():
    """reference test_profile (src/scan_block.rs:2122-2168): PSSM golden
    scores + gap-close CIGAR at fixed and adaptive profile ranges."""
    def prof(s, block, gap_extend_R=0, close17=None):
        # AAProfile.from_bytes(s, block, match, mismatch, gap open C,
        # gap extend rows..) analogue: mirror test_oracle_golden's builder
        p = AAProfile.from_bytes(s, block, 1, -1, -1, gap_extend_R, -1, -1)
        if close17 is not None:
            p.set_gap_close_C(17, close17[0])
            p.set_gap_close_C(19, close17[1])
        return p

    cases = [
        (b"AAAA", prof(b"AAAA", 16), 4, None),
        (b"AAAA", prof(b"AATTAA", 16), 1, None),
        (b"AAAA", prof(b"AATTAA", 16, gap_extend_R=-1), 0, None),
        (b"TTTTTTTTAAAAAAATTTTTTTTT", prof(b"TTAAAAAAATTTTTTTTTTTT", 16),
         7, "2M6I16M3D"),
        (b"TTTTTTTTAAAAAAATTTTTTTTT",
         prof(b"TTAAAAAAATTTTTTTTTTTT", 16, gap_extend_R=-1),
         6, "2M6I16M3D"),
    ]
    lane = ProfileAligner((16, 16), batch=16, seq_cap=256, trace=True)
    assert lane.route == "engine"
    for q, p, score, cig in cases:
        got = lane.align_batch([(q, p)])[0]
        assert got.score == score, (q, got, score)
        if cig is not None:
            assert str(lane.cigar(0, len(q), p.str_len)) == cig

    # the position-specific gap-close case (2M6I14M3D2M)
    pc = AAProfile.from_bytes(b"TTAAAAAAATTTTTTTTTTTT", 16, 1, -1, -2,
                              -1, -1, -1)
    pc.set_gap_close_C(17, -1)
    pc.set_gap_close_C(19, 0)
    q = b"TTTTTTTTAAAAAAATTTTTTTTT"
    got = lane.align_batch([(q, pc)])[0]
    assert got.score == 6
    assert str(lane.cigar(0, 24, 21)) == "2M6I14M3D2M"

    # adaptive profile path vs the oracle at (16, 32)
    orc = BlockOracle(trace=True)
    ada = ProfileAligner((16, 32), batch=16, seq_cap=256, trace=True)
    assert ada.route == "engine"
    for q, p, _, cig in cases + [(q, pc, 6, "gapclose")]:
        got = ada.align_batch([(q, p)])[0]
        pq = PaddedBytes.from_bytes(q, 32, p)
        orc.align_profile(pq, p, (16, 32), 0)
        w = orc.res()
        assert got.score == w.score, (q, got, w)
        gc = str(ada.cigar(0, len(q), p.str_len))
        wc = str(orc.cigar(w.query_idx, w.reference_idx))
        assert gc == wc, (q, gc, wc)


def test_golden_local_and_free_query_gaps_paths():
    """reference test_local_and_free_query_gaps
    (src/scan_block.rs:2170-2230): LOCAL_START / FREE_QUERY_START_GAPS /
    FREE_QUERY_END_GAPS golden results + CIGARs at the fixed range, and
    the local/free-start flags at an adaptive range and a large band."""
    cases = [
        # (flags, q, r, x_drop, result, cigar)
        (dict(local_start=True), b"CCCCCCCCCCAAAAAA", b"TTTTAAAAAA",
         None, (6, 16, 10), "6="),
        (dict(local_start=True), b"CCCCCCCCCCAAAAAACCCCCCCCCCCC",
         b"TTTTAAAAAATTTTTTT", 100, (6, 16, 10), "6="),
        (dict(free_query_start_gaps=True), b"AAAAAA", b"CCCCCCCCCCAAAAAA",
         None, (6, 6, 16), "6="),
        (dict(free_query_start_gaps=True), b"AAAAAA", b"CCCCCCCCCCAAATAA",
         None, (4, 6, 16), "3=1X2="),
        (dict(free_query_end_gaps=True), b"AAAAAA", b"AAAAAACCCCCCCCCC",
         None, (6, 6, 6), "6="),
        (dict(free_query_end_gaps=True), b"AAAAAA", b"AAATAACCCCCCCCCC",
         None, (4, 6, 6), "3=1X2="),
    ]
    for flags, q, r, xd, want, cig in cases:
        lane = BatchAligner(NW1, GAPS_NUC, (32, 32), batch=16,
                            seq_cap=256, trace=True, x_drop=xd, **flags)
        assert lane.route == "engine"
        got = lane.align_batch([(q, r)])[0]
        assert (got.score, got.query_idx, got.reference_idx) == want, (
            flags, got, want)
        gc = str(lane.cigar_eq(0, q, r, want[1], want[2]))
        assert gc == cig, (flags, gc, cig)

    # local-start / free-start flags at adaptive and large-band ranges
    # (one aligner per flag set per range; same-flag cases share a batch)
    groups = {}
    for flags, q, r, xd, _, _ in cases:
        if xd is not None or flags.get("free_query_end_gaps"):
            continue  # covered at the fixed range above
        groups.setdefault(tuple(sorted(flags)), (flags, []))[1] \
            .append((q, r))
    for size, seq_cap, which in (((16, 32), 256, "adaptive"),
                                 ((64, 1024), 512, "big")):
        for flags, pairs in groups.values():
            al = BatchAligner(NW1, GAPS_NUC, size, batch=16,
                              seq_cap=seq_cap, trace=True, **flags)
            assert al.route == "engine", which
            got = al.align_batch(pairs)
            orc = BlockOracle(trace=True, **flags)
            for k, (q, r) in enumerate(pairs):
                pq = PaddedBytes.from_bytes(q, size[1], NW1)
                pr = PaddedBytes.from_bytes(r, size[1], NW1)
                orc.align(pq, pr, NW1, GAPS_NUC, size, 0)
                w = orc.res()
                assert got[k].score == w.score, (which, flags, got[k], w)
                gc = str(al.cigar_eq(k, q, r, len(q), len(r)))
                wc = str(orc.cigar_eq(pq, pr, w.query_idx,
                                      w.reference_idx))
                assert gc == wc, (which, flags, gc, wc)
