"""Batched exponential min-size search vs the oracle align_exp."""

import numpy as np

from block_aligner_jax import BLOSUM62, BlockOracle, Gaps, PaddedBytes
from block_aligner_jax.api import align_exp_all
from block_aligner_jax.core.full_dp import global_align_score

AA = b"ACDEFGHIKLMNPQRSTVWY"


def test_align_exp_matches_oracle():
    rng = np.random.default_rng(77)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    targets = []
    for _ in range(10):
        n = int(rng.integers(30, 150))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 3):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(list(AA)))
        r = bytes(r)
        pairs.append((q, r))
        targets.append(global_align_score(q, r, BLOSUM62, gaps))

    res, mins = align_exp_all(
        BLOSUM62, gaps, pairs, targets, (16, 128), batch=16, seq_cap=256
    )
    a = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 128, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 128, BLOSUM62)
        want = a.align_exp(pq, pr, BLOSUM62, gaps, (16, 128), 0, targets[k])
        assert mins[k] == want, (k, mins[k], want)
        if want is not None:
            assert res[k].score >= targets[k]
