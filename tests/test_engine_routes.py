"""Engine-route cases through BatchAligner / ProfileAligner vs the oracle.

Every configuration the CUDA kernel does not serve runs on the engine,
on the GPU as here on the CPU; this grid covers the reference's bands
(fixed 32, uc30's (16, 256), (32, 512), nanopore's (128, 1024)) in each
mode: global, x-drop, trace CIGARs, profile, local-start, free query
gaps, and byte matrices.  ``pick_route`` is checked per backend.
"""

import numpy as np
import pytest

from block_aligner_jax import (BLOSUM62, BYTES1, AAProfile, BatchAligner,
                               BlockOracle, Gaps, PaddedBytes, ProfileAligner)
from block_aligner_jax.api import backend_of, pick_route

AA = b"ACDEFGHIKLMNPQRSTVWY"
GAPS = Gaps(open=-11, extend=-1)
BANDS = [(32, 32), (16, 256), (32, 512), (128, 1024)]
MODES = ["global", "x_drop", "trace", "profile", "local_start",
         "free_start", "free_end", "byte"]


def rand_seq(rng, n, alpha=AA):
    return bytes(rng.choice(list(alpha), size=n).tolist())


def related(rng, n, alpha=AA):
    q = rand_seq(rng, n, alpha)
    r = bytearray(q)
    for _ in range(n // 6 + 1):
        pos = int(rng.integers(0, len(r)))
        if rng.integers(0, 3):
            r[pos] = int(rng.choice(list(alpha)))
        else:
            r[pos:pos] = rand_seq(rng, int(rng.integers(1, 12)), alpha)
    return q, bytes(r)


def profile_pair(rng, n):
    cons = rand_seq(rng, n)
    prof = AAProfile(n, 2048, -1)
    base = rng.integers(-4, 3, size=(n, 26))
    base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = \
        rng.integers(4, 12, size=n)
    prof.pos_scores[1 : n + 1, :26] = base
    prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
    prof.gap_close_C[: n + 1] = rng.integers(-3, 1, size=n + 1)
    prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
    q = bytearray(cons)
    for _ in range(n // 5):
        q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
    return bytes(q), prof


@pytest.mark.parametrize("band", BANDS, ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_engine_route_vs_oracle(band, mode):
    rng = np.random.default_rng(band[0] + band[1] + len(mode))
    flags = {"local_start": dict(local_start=True),
             "free_start": dict(free_query_start_gaps=True),
             "free_end": dict(free_query_start_gaps=True,
                              free_query_end_gaps=True)}.get(mode, {})
    x_drop = 60 if mode in ("x_drop", "local_start") else None
    trace = mode == "trace"
    orc = BlockOracle(trace=trace, x_drop=x_drop is not None, **flags)
    if mode == "profile":
        pairs = [profile_pair(rng, int(rng.integers(20, 260)))
                 for _ in range(3)]
        al = ProfileAligner(band, batch=4, seq_cap=300)
        got = al.align_batch(pairs)
        for k, (q, prof) in enumerate(pairs):
            orc.align_profile(PaddedBytes.from_bytes(q, band[1], prof), prof,
                              band, 0)
            assert got[k] == orc.res(), (k, got[k], orc.res())
        assert al.route == "engine"
        return
    matrix = BYTES1 if mode == "byte" else BLOSUM62
    gaps = Gaps(-2, -1) if mode == "byte" else GAPS
    if mode == "free_end":
        # free trailing query gaps need query length < min block
        pairs = []
        for _ in range(3):
            r = rand_seq(rng, int(rng.integers(40, 260)))
            at = int(rng.integers(0, len(r) - 20))
            pairs.append((r[at : at + band[0] - 4], r))
    elif mode == "byte":
        pairs = [related(rng, int(rng.integers(20, 260)), b"ACGTacgt")
                 for _ in range(3)]
    else:
        pairs = [related(rng, int(rng.integers(20, 260))) for _ in range(3)]
    pairs.append((b"", pairs[0][1][:7]))
    al = BatchAligner(matrix, gaps, band, batch=4, seq_cap=300, trace=trace,
                      x_drop=x_drop, **flags)
    assert al.route == "engine"
    got = al.align_batch(pairs)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, band[1], matrix)
        pr = PaddedBytes.from_bytes(r, band[1], matrix)
        orc.align(pq, pr, matrix, gaps, band, x_drop or 0)
        w = orc.res()
        assert got[k] == w, (k, got[k], w)
        if trace:
            assert str(al.cigar(k, w.query_idx, w.reference_idx)) == \
                str(orc.cigar(w.query_idx, w.reference_idx)), k


@pytest.mark.parametrize("backend,size,flags,want", [
    ("cpu", (32, 32), {}, "engine"),
    ("gpu", (32, 32), {}, "cuda"),
    ("gpu", (16, 16), {}, "cuda"),
    ("gpu", (512, 512), {}, "cuda"),
    ("gpu", (8, 8), {}, "cuda"),  # sizes clamp to the 16 floor
    ("gpu", (1024, 1024), {}, "engine"),
    ("gpu", (32, 256), {}, "engine"),
    ("gpu", (32, 32), {"trace": True}, "engine"),
    ("gpu", (32, 32), {"profile": True}, "engine"),
    ("gpu", (32, 32), {"local_start": True}, "engine"),
    ("gpu", (32, 32), {"free_query_start_gaps": True}, "engine"),
    ("gpu", (32, 32), {"free_query_end_gaps": True}, "engine"),
])
def test_pick_route_by_backend(backend, size, flags, want):
    assert pick_route(*size, backend=backend, **flags) == want


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        pick_route(32, 32, backend="metal")
    assert backend_of() == "cpu"
