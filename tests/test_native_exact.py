"""Native exact-DP oracles vs the NumPy reference implementations."""

import numpy as np
import pytest

from block_aligner_jax import AAProfile, BLOSUM62, Gaps, NW1
from block_aligner_jax.core import full_dp
from block_aligner_jax.native import load_exact

AA = b"ACDEFGHIKLMNPQRSTVWY"
DNA = b"ACGT"


def _numpy_global(q, r, matrix, gaps):
    lib = full_dp._native_exact
    # temporarily disable native dispatch
    orig = full_dp._native_exact
    full_dp._native_exact = lambda: None
    try:
        return full_dp.global_align_score(q, r, matrix, gaps)
    finally:
        full_dp._native_exact = orig


def _numpy_xdrop(q, r, matrix, gaps, x):
    orig = full_dp._native_exact
    full_dp._native_exact = lambda: None
    try:
        return full_dp.x_drop_score(q, r, matrix, gaps, x)
    finally:
        full_dp._native_exact = orig


@pytest.mark.skipif(load_exact() is None, reason="native toolchain unavailable")
def test_native_global_matches_numpy():
    rng = np.random.default_rng(17)
    gaps = Gaps(open=-11, extend=-1)
    for _ in range(12):
        n = int(rng.integers(1, 120))
        m = int(rng.integers(1, 120))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytes(rng.choice(list(AA), size=m).tolist())
        assert full_dp.global_align_score(q, r, BLOSUM62, gaps) == _numpy_global(
            q, r, BLOSUM62, gaps
        )
    gaps = Gaps(open=-2, extend=-1)
    for _ in range(8):
        n = int(rng.integers(1, 150))
        q = bytes(rng.choice(list(DNA), size=n).tolist())
        r = bytes(rng.choice(list(DNA), size=n).tolist())
        assert full_dp.global_align_score(q, r, NW1, gaps) == _numpy_global(
            q, r, NW1, gaps
        )


@pytest.mark.skipif(load_exact() is None, reason="native toolchain unavailable")
def test_native_xdrop_matches_numpy():
    rng = np.random.default_rng(18)
    gaps = Gaps(open=-11, extend=-1)
    for _ in range(8):
        n = int(rng.integers(5, 80))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 5):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(list(AA)))
        r = bytes(r)
        assert full_dp.x_drop_score(q, r, BLOSUM62, gaps, 50) == _numpy_xdrop(
            q, r, BLOSUM62, gaps, 50
        )


@pytest.mark.skipif(load_exact() is None, reason="native toolchain unavailable")
def test_native_profile_matches_numpy():
    rng = np.random.default_rng(19)
    for _ in range(6):
        n = int(rng.integers(5, 60))
        prof = AAProfile(n, 32, -1)
        for i in range(1, n + 1):
            for c in range(ord("A"), ord("Z") + 1):
                prof.set(i, c, int(rng.integers(-8, 10)))
        for i in range(n + 1):
            prof.set_gap_open_C(i, int(rng.integers(-12, -2)))
            prof.set_gap_close_C(i, int(rng.integers(-3, 1)))
            prof.set_gap_open_R(i, int(rng.integers(-12, -2)))
        q = bytes(rng.choice(list(AA), size=int(rng.integers(5, 60))).tolist())
        native = full_dp.global_align_profile_score(q, prof)
        orig = full_dp._native_exact
        full_dp._native_exact = lambda: None
        try:
            ref = full_dp.global_align_profile_score(q, prof)
        finally:
            full_dp._native_exact = orig
        assert native == ref
