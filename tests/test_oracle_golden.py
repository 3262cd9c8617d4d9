"""Golden-case tests for the scalar oracle, transcribed from the reference
unit tests (reference: src/scan_block.rs:1902-2231 and the doc example at
src/lib.rs:8-35).  Expected scores/CIGARs are the reference's hand-checked
values."""

import pytest

from block_aligner_jax import (
    AAProfile,
    AlignResult,
    BlockOracle,
    BYTES1,
    BLOSUM62,
    Cigar,
    Gaps,
    NW1,
    NucMatrix,
    PaddedBytes,
)


def pb(matrix, s, block=16):
    return PaddedBytes.from_bytes(s, block, matrix)


def test_no_x_drop():
    gaps = Gaps(open=-11, extend=-1)
    a = BlockOracle()

    cases = [
        (b"", b"", 0),
        (b"", b"AAAA", -14),
        (b"AAAA", b"", -14),
        (b"AARA", b"AAAA", 11),
        (b"AARAAAA", b"AAAAAAAA", 12),
        (b"AAAA", b"AAAA", 16),
        (b"RRRR", b"AAAA", -4),
        (b"AAA", b"AAAA", 1),
    ]
    for q, r, score in cases:
        a.align(pb(BLOSUM62, q), pb(BLOSUM62, r), BLOSUM62, gaps, (16, 16), 0)
        assert a.res().score == score, (q, r, a.res())

    gaps2 = Gaps(open=-2, extend=-1)
    cases2 = [
        (b"ATAA", b"AAAN", 0),
        (b"A" * 32, b"A" * 32, 32),
        (b"T" * 32, b"A" * 32, -32),
        (b"TA" * 16, b"A" * 32, 0),
        (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT", 7),
        (b"C", b"AAAA", -5),
        (b"AAAA", b"C", -5),
    ]
    for q, r, score in cases2:
        a.align(pb(NW1, q), pb(NW1, r), NW1, gaps2, (16, 16), 0)
        assert a.res().score == score, (q, r, a.res())


def test_x_drop():
    gaps = Gaps(open=-11, extend=-1)
    a = BlockOracle(x_drop=True)

    a.align(pb(BLOSUM62, b""), pb(BLOSUM62, b""), BLOSUM62, gaps, (16, 16), 1)
    assert a.res() == AlignResult(0, 0, 0)

    a.align(pb(BLOSUM62, b""), pb(BLOSUM62, b"AAAA"), BLOSUM62, gaps, (16, 16), 1)
    assert a.res() == AlignResult(0, 0, 0)

    a.align(pb(BLOSUM62, b"AAAA"), pb(BLOSUM62, b""), BLOSUM62, gaps, (16, 16), 1)
    assert a.res() == AlignResult(0, 0, 0)

    a.align(pb(BLOSUM62, b"AAAAAA"), pb(BLOSUM62, b"AAARRA"), BLOSUM62, gaps, (16, 16), 1)
    assert a.res() == AlignResult(14, 6, 6)

    a.align(
        pb(BLOSUM62, b"A" * 44),
        pb(BLOSUM62, b"A" * 15 + b"R" * 16 + b"A" * 13),
        BLOSUM62,
        gaps,
        (16, 16),
        1,
    )
    assert a.res() == AlignResult(60, 15, 15)

    at = BlockOracle(trace=True, x_drop=True)
    long_str = b"A" * 2048
    at.align(
        pb(BLOSUM62, long_str, 2048),
        pb(BLOSUM62, long_str, 2048),
        BLOSUM62,
        gaps,
        (2048, 2048),
        100,
    )
    assert at.res() == AlignResult(8192, 2048, 2048)


def test_trace():
    gaps = Gaps(open=-11, extend=-1)
    a = BlockOracle(trace=True)

    q = pb(BLOSUM62, b"AAAAAA")
    r = pb(BLOSUM62, b"AAARRA")
    a.align(q, r, BLOSUM62, gaps, (16, 16), 0)
    res = a.res()
    assert res == AlignResult(14, 6, 6)
    assert str(a.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "3=2X1="

    q = pb(BLOSUM62, b"AAA")
    r = pb(BLOSUM62, b"AAAA")
    a.align(q, r, BLOSUM62, gaps, (16, 16), 0)
    res = a.res()
    assert res == AlignResult(1, 3, 4)
    assert str(a.cigar(res.query_idx, res.reference_idx)) == "3M1D"

    gaps2 = Gaps(open=-2, extend=-1)
    q = pb(NW1, b"TTTTTTTTAAAAAAATTTTTTTTT")
    r = pb(NW1, b"TTAAAAAAATTTTTTTTTTTT")
    a.align(q, r, NW1, gaps2, (16, 16), 0)
    res = a.res()
    assert res == AlignResult(7, 24, 21)
    assert str(a.cigar(res.query_idx, res.reference_idx)) == "2M6I16M3D"

    q = pb(NW1, b"AAAAAAAAATTGCGCT", 32)
    r = pb(NW1, b"AAAAAAAAAGCGC", 32)
    a.align(q, r, NW1, gaps2, (32, 32), 0)
    res = a.res()
    assert res == AlignResult(8, 16, 13)
    assert str(a.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "9=2I4=1I"

    matrix = NucMatrix.new_simple(2, -1)
    gaps3 = Gaps(open=-5, extend=-2)
    a.align(q, r, matrix, gaps3, (32, 32), 0)
    res = a.res()
    assert res == AlignResult(14, 16, 13)
    assert str(a.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "9=2I4=1I"


def test_doc_example():
    """README/doc example (reference: src/lib.rs:8-35)."""
    gaps = Gaps(open=-2, extend=-1)
    r = pb(NW1, b"TTAAAAAAATTTTTTTTTTTT", 256)
    q = pb(NW1, b"TTTTTTTTAAAAAAATTTTTTTTT", 256)
    a = BlockOracle(trace=True)
    a.align(q, r, NW1, gaps, (32, 256), 0)
    res = a.res()
    assert res == AlignResult(7, 24, 21)
    assert str(a.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "2=6I16=3D"


def test_bytes():
    gaps = Gaps(open=-2, extend=-1)
    a = BlockOracle()

    a.align(pb(BYTES1, b"AAAAAA"), pb(BYTES1, b"AAAaaA"), BYTES1, gaps, (16, 16), 0)
    assert a.res().score == 2

    a.align(pb(BYTES1, b"abdefg"), pb(BYTES1, b"abcdefg"), BYTES1, gaps, (16, 16), 0)
    assert a.res().score == 4


def test_profile():
    a = BlockOracle()
    from block_aligner_jax import AAMatrix

    r = AAProfile.from_bytes(b"AAAA", 16, 1, -1, -1, 0, -1, -1)
    q = pb(BLOSUM62, b"AAAA")
    a.align_profile(q, r, (16, 16), 0)
    assert a.res().score == 4

    r = AAProfile.from_bytes(b"AATTAA", 16, 1, -1, -1, 0, -1, -1)
    a.align_profile(q, r, (16, 16), 0)
    assert a.res().score == 1

    r = AAProfile.from_bytes(b"AATTAA", 16, 1, -1, -1, -1, -1, -1)
    a.align_profile(q, r, (16, 16), 0)
    assert a.res().score == 0

    at = BlockOracle(trace=True)
    r = AAProfile.from_bytes(b"TTAAAAAAATTTTTTTTTTTT", 16, 1, -1, -1, 0, -1, -1)
    q = pb(BLOSUM62, b"TTTTTTTTAAAAAAATTTTTTTTT")
    at.align_profile(q, r, (16, 16), 0)
    res = at.res()
    assert res == AlignResult(7, 24, 21)
    assert str(at.cigar(res.query_idx, res.reference_idx)) == "2M6I16M3D"

    r = AAProfile.from_bytes(b"TTAAAAAAATTTTTTTTTTTT", 16, 1, -1, -1, -1, -1, -1)
    at.align_profile(q, r, (16, 16), 0)
    res = at.res()
    assert res == AlignResult(6, 24, 21)
    assert str(at.cigar(res.query_idx, res.reference_idx)) == "2M6I16M3D"

    r = AAProfile.from_bytes(b"TTAAAAAAATTTTTTTTTTTT", 16, 1, -1, -2, -1, -1, -1)
    r.set_gap_close_C(17, -1)
    r.set_gap_close_C(19, 0)
    at.align_profile(q, r, (16, 16), 0)
    res = at.res()
    assert res == AlignResult(6, 24, 21)
    assert str(at.cigar(res.query_idx, res.reference_idx)) == "2M6I14M3D2M"


def test_local_and_free_query_gaps():
    gaps = Gaps(open=-2, extend=-1)

    local = BlockOracle(trace=True, local_start=True)
    r = pb(NW1, b"TTTTAAAAAA", 32)
    q = pb(NW1, b"CCCCCCCCCCAAAAAA", 32)
    local.align(q, r, NW1, gaps, (32, 32), 0)
    res = local.res()
    assert res == AlignResult(6, 16, 10)
    assert str(local.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "6="

    local = BlockOracle(trace=True, x_drop=True, local_start=True)
    r = pb(NW1, b"TTTTAAAAAATTTTTTT", 32)
    q = pb(NW1, b"CCCCCCCCCCAAAAAACCCCCCCCCCCC", 32)
    local.align(q, r, NW1, gaps, (32, 32), 100)
    res = local.res()
    assert res == AlignResult(6, 16, 10)
    assert str(local.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "6="

    q_start = BlockOracle(trace=True, free_query_start_gaps=True)
    r = pb(NW1, b"CCCCCCCCCCAAAAAA", 32)
    q = pb(NW1, b"AAAAAA", 32)
    q_start.align(q, r, NW1, gaps, (32, 32), 0)
    res = q_start.res()
    assert res == AlignResult(6, 6, 16)
    assert str(q_start.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "6="

    r = pb(NW1, b"CCCCCCCCCCAAATAA", 32)
    q_start.align(q, r, NW1, gaps, (32, 32), 0)
    res = q_start.res()
    assert res == AlignResult(4, 6, 16)
    assert str(q_start.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "3=1X2="

    q_end = BlockOracle(trace=True, free_query_end_gaps=True)
    r = pb(NW1, b"AAAAAACCCCCCCCCC", 32)
    q = pb(NW1, b"AAAAAA", 32)
    q_end.align(q, r, NW1, gaps, (32, 32), 0)
    res = q_end.res()
    assert res == AlignResult(6, 6, 6)
    assert str(q_end.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "6="

    r = pb(NW1, b"AAATAACCCCCCCCCC", 32)
    q_end.align(q, r, NW1, gaps, (32, 32), 0)
    res = q_end.res()
    assert res == AlignResult(4, 6, 6)
    assert str(q_end.cigar_eq(q, r, res.query_idx, res.reference_idx)) == "3=1X2="
