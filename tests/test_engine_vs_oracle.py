"""Bit-exactness tests: the batched JAX engine must reproduce the scalar
oracle's results (scores and end positions) exactly, including the adaptive
grow/shrink heuristics and x-drop semantics."""

import numpy as np
import pytest

from block_aligner_jax import BLOSUM62, BlockOracle, BYTES1, Gaps, NW1, PaddedBytes
from block_aligner_jax.ops.engine import EngineConfig, build_engine, pack_pairs

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"


def rand_seq(rng, alpha, length):
    return bytes(rng.choice(list(alpha), size=length).tolist())


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


def oracle_align(pairs, matrix, gaps, min_size, max_size, x_drop=0, xd=False):
    out = []
    a = BlockOracle(x_drop=xd)
    for q, r in pairs:
        pq = PaddedBytes.from_bytes(q, max_size, matrix)
        pr = PaddedBytes.from_bytes(r, max_size, matrix)
        a.align(pq, pr, matrix, gaps, (min_size, max_size), x_drop)
        res = a.res()
        out.append((res.score, res.query_idx, res.reference_idx))
    return out


def engine_align(pairs, matrix, gaps, min_size, max_size, x_drop=0, xd=False):
    maxlen = max(max(len(q), len(r)) for q, r in pairs)
    seq_cap = 1 + maxlen + max_size + 16
    seq_cap = -(-seq_cap // 128) * 128
    from block_aligner_jax.core.scores import ByteMatrix

    is_byte = isinstance(matrix, ByteMatrix)
    cfg = EngineConfig(
        batch=len(pairs),
        min_size=min_size,
        max_size=max_size,
        seq_cap=seq_cap,
        n_rows=getattr(matrix, "ROWS", 1),
        is_byte=is_byte,
        x_drop=xd,
    )
    fn = build_engine(cfg)
    Sprof, CRow, qlen, rlen = pack_pairs(pairs, matrix, cfg)
    kw = {}
    if is_byte:
        kw = dict(byte_match=matrix.match_score, byte_mismatch=matrix.mismatch_score)
    score, qi, rj, iters = fn(Sprof, CRow, qlen, rlen, gaps.open, gaps.extend, x_drop, **kw)
    assert int(iters) < cfg.iter_cap, "engine hit iteration cap"
    return list(zip(np.asarray(score).tolist(), np.asarray(qi).tolist(), np.asarray(rj).tolist()))


def check(pairs, matrix, gaps, min_size, max_size, x_drop=0, xd=False):
    want = oracle_align(pairs, matrix, gaps, min_size, max_size, x_drop, xd)
    got = engine_align(pairs, matrix, gaps, min_size, max_size, x_drop, xd)
    for k, (w, g) in enumerate(zip(want, got)):
        assert w == g, f"pair {k}: oracle {w} != engine {g}\nq={pairs[k][0]}\nr={pairs[k][1]}"


def test_engine_golden_small():
    gaps = Gaps(open=-11, extend=-1)
    pairs = [
        (b"AAAA", b"AAAA"),
        (b"AARA", b"AAAA"),
        (b"AARAAAA", b"AAAAAAAA"),
        (b"RRRR", b"AAAA"),
        (b"AAA", b"AAAA"),
        (b"A" * 40, b"A" * 40),
    ]
    check(pairs, BLOSUM62, gaps, 16, 16)


def test_engine_nuc_mixed_lengths():
    gaps = Gaps(open=-2, extend=-1)
    pairs = [
        (b"TTTTTTTTAAAAAAATTTTTTTTT", b"TTAAAAAAATTTTTTTTTTTT"),
        (b"C", b"AAAA"),
        (b"AAAA", b"C"),
        (b"TA" * 16, b"A" * 32),
    ]
    check(pairs, NW1, gaps, 16, 16)


def test_engine_adaptive_grow_shrink():
    rng = np.random.default_rng(99)
    gaps = Gaps(open=-2, extend=-1)
    pairs = []
    for _ in range(8):
        q = rand_seq(rng, DNA, int(rng.integers(50, 300)))
        r = mutate(rng, q, int(rng.integers(5, 60)), DNA)
        pairs.append((q, r))
    check(pairs, NW1, gaps, 32, 256)


def test_engine_protein_adaptive():
    rng = np.random.default_rng(3)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(8):
        q = rand_seq(rng, AA, int(rng.integers(30, 200)))
        r = mutate(rng, q, int(rng.integers(3, 40)), AA)
        pairs.append((q, r))
    check(pairs, BLOSUM62, gaps, 32, 256)


def test_engine_bytes():
    gaps = Gaps(open=-2, extend=-1)
    pairs = [(b"AAAAAA", b"AAAaaA"), (b"abdefg", b"abcdefg")]
    check(pairs, BYTES1, gaps, 16, 16)


def test_engine_x_drop():
    rng = np.random.default_rng(5)
    gaps = Gaps(open=-11, extend=-1)
    pairs = [
        (b"AAAAAA", b"AAARRA"),
        (b"A" * 44, b"A" * 15 + b"R" * 16 + b"A" * 13),
    ]
    for _ in range(6):
        q = rand_seq(rng, AA, int(rng.integers(30, 120)))
        r = mutate(rng, q, int(rng.integers(3, 30)), AA)
        pairs.append((q, r))
    check(pairs, BLOSUM62, gaps, 16, 64, x_drop=50, xd=True)


def test_engine_offset_saturation_long():
    # the reference's 2048-long saturation case (src/scan_block.rs:2030-2049):
    # the final score (8192) far exceeds the i16 per-block range, so this
    # exercises the 32-bit offset rebasing chain end to end
    from block_aligner_jax.ops.engine import EngineConfig, build_engine, pack_pairs

    long_str = b"A" * 2048
    gaps = Gaps(open=-11, extend=-1)
    cfg = EngineConfig(batch=2, min_size=32, max_size=64, seq_cap=2176,
                       n_rows=27)
    fn = build_engine(cfg)
    args = pack_pairs([(long_str, long_str)] * 2, BLOSUM62, cfg)
    score, qi, rj, _ = fn(*args, gaps.open, gaps.extend, 0)
    assert int(np.asarray(score)[0]) == 8192

    cfg_x = EngineConfig(batch=2, min_size=32, max_size=64, seq_cap=2176,
                         n_rows=27, x_drop=True)
    fn_x = build_engine(cfg_x)
    score, qi, rj, _ = fn_x(*args, gaps.open, gaps.extend, 100)
    assert (int(np.asarray(score)[0]), int(np.asarray(qi)[0]),
            int(np.asarray(rj)[0])) == (8192, 2048, 2048)
