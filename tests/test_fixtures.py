"""Real-format fixture loading: miniature files in the exact reference
dataset formats (data/README.md), parsed by the examples loaders the
same way the reference example programs parse the real downloads, then
aligned end-to-end with oracle cross-checks."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from block_aligner_jax import (
    BLOSUM62, BlockOracle, Gaps, NucMatrix, PaddedBytes,
)
from block_aligner_jax.api import BatchAligner, ProfileAligner


def test_uc_m8_fixture():
    """mmseqs convertalis m8 (14 cols, qseq/tseq last; reference parser
    examples/uc_accuracy.rs:21-25): load + global BLOSUM62 -11/-1."""
    from examples.common import load_uc_pairs

    pairs = load_uc_pairs(name="uc30.mini")
    assert len(pairs) == 20
    for q, t, ident in pairs:
        assert set(q) <= set(b"ACDEFGHIKLMNPQRSTVWY")
        assert 0.0 <= ident <= 1.0
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, (32, 64), batch=128, seq_cap=256)
    got = al.align_batch([(q, t) for q, t, _ in pairs])
    orc = BlockOracle()
    for k, (q, t, _) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 64, BLOSUM62)
        pt = PaddedBytes.from_bytes(t, 64, BLOSUM62)
        orc.align(pq, pt, BLOSUM62, gaps, (32, 64), 0)
        assert got[k].score == orc.res().score, k


def test_nanopore_pairs_fixture():
    """BiWFA-style alternating-line pair file (r line first, q second;
    reference parser examples/nanopore_accuracy.rs:31-33)."""
    from examples.common import load_nanopore_pairs

    pairs = load_nanopore_pairs(name="seq_pairs.mini", n_pairs=10)
    assert len(pairs) == 10
    for q, r in pairs:
        assert set(q) <= set(b"ACGT") and set(r) <= set(b"ACGT")
    nuc = NucMatrix.new_simple(2, -4)
    gaps = Gaps(open=-6, extend=-2)
    al = BatchAligner(nuc, gaps, (32, 128), batch=128, seq_cap=512)
    got = al.align_batch(pairs)
    orc = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 128, nuc)
        pr = PaddedBytes.from_bytes(r, 128, nuc)
        orc.align(pq, pr, nuc, gaps, (32, 128), 0)
        assert got[k].score == orc.res().score, k


def test_scop_pssm_fixture():
    """scop pairs.pssm records ('#seq' / '#cns' / header / 'pos aa s*20'
    rows in ACDEFGHIKLMNPQRSTVWY order, gap open -10 close 0 per position;
    reference parser examples/pssm_accuracy.rs:38-69)."""
    from examples.common import load_scop_profiles

    recs = load_scop_profiles(name="pairs.mini.pssm")
    assert len(recs) == 6
    pa = ProfileAligner((16, 64), batch=8, seq_cap=200)
    assert pa.route == "engine"
    got = pa.align_batch(recs)
    orc = BlockOracle()
    for k, (q, prof) in enumerate(recs):
        pq = PaddedBytes.from_bytes(q, 64, prof)
        orc.align_profile(pq, prof, (16, 64), 0)
        assert got[k].score == orc.res().score, k
