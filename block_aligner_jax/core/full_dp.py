"""Exact full-matrix affine-gap DP oracles (NumPy).

The analogue of the reference's external oracles (rust-bio / parasail in
examples/accuracy.rs, examples/uc_accuracy.rs) plus the scalar x-drop
full-DP oracle (reference: examples/x_drop_accuracy.rs:109-160).  Used by
accuracy tests and dataset harnesses; O(nm) and intentionally simple.

Gap convention matches ``Gaps``: a gap of length n costs open + extend*(n-1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -(10**9)

__all__ = ["global_align_score", "x_drop_score", "global_align_profile_score"]


def _score_matrix_rows(matrix, q_codes: np.ndarray, r_codes: np.ndarray) -> np.ndarray:
    """(len(q), len(r)) substitution scores for converted codes."""
    from .scores import ByteMatrix

    if isinstance(matrix, ByteMatrix):
        return np.where(
            q_codes[:, None] == r_codes[None, :], matrix.match_score, matrix.mismatch_score
        ).astype(np.int64)
    tab = matrix.dense()
    rows = matrix.row_index(r_codes).astype(np.int64)
    cols = matrix.col_index(q_codes).astype(np.int64)
    return tab[rows[None, :], cols[:, None]].astype(np.int64)


def _native_exact():
    from ..native import load_exact

    return load_exact()


def global_align_score(q, r, matrix, gaps) -> int:
    """Global (Needleman-Wunsch-Gotoh) alignment score.

    Dispatches to the native C++ oracle (native/exact.cpp) when available;
    the NumPy path below is the readable fallback."""
    from .scores import ByteMatrix

    lib = _native_exact()
    if lib is not None and not isinstance(matrix, ByteMatrix):
        import ctypes

        qc = np.ascontiguousarray(
            matrix.col_index(matrix.convert(q)), dtype=np.int32
        )
        rc = np.ascontiguousarray(
            matrix.row_index(matrix.convert(r)), dtype=np.int32
        )
        tab = np.ascontiguousarray(matrix.dense(), dtype=np.int32)
        return int(
            lib.ba_global_score(
                qc.ctypes.data_as(ctypes.c_void_p), len(qc),
                rc.ctypes.data_as(ctypes.c_void_p), len(rc),
                tab.ctypes.data_as(ctypes.c_void_p), tab.shape[1],
                gaps.open, gaps.extend,
            )
        )
    q_codes = matrix.convert(q)
    r_codes = matrix.convert(r)
    n, m = len(q_codes), len(r_codes)
    S = _score_matrix_rows(matrix, q_codes, r_codes)
    o, e = gaps.open, gaps.extend

    # Row-sweep Gotoh.  The horizontal gap table C is sequential along a row,
    # but because open < extend, gap chains collapse and C folds into a
    # running-max scan: D[j] = max(partial[j], (o-e) + e*j + cummax(partial - e*k)[j-1])
    # (the same closed form the batched engine uses for the vertical R table).
    ks = np.arange(m + 1, dtype=np.int64)
    D = np.full(m + 1, NEG, dtype=np.int64)
    D[0] = 0
    if m > 0:
        D[1:] = o + np.arange(m, dtype=np.int64) * e
    R_prev = np.full(m + 1, NEG, dtype=np.int64)
    for i in range(1, n + 1):
        D_up = D
        R = np.maximum(R_prev + e, D_up + o)
        partial = np.empty(m + 1, dtype=np.int64)
        partial[0] = R[0]
        if m > 0:
            partial[1:] = np.maximum(D_up[:m] + S[i - 1], R[1:])
        M = np.maximum.accumulate(partial - e * ks)
        D = partial.copy()
        if m > 0:
            D[1:] = np.maximum(partial[1:], (o - e) + e * ks[1:] + M[:m])
        R_prev = R
    return int(D[m])


def global_align_profile_score(q, profile) -> int:
    """Global alignment of sequence q against an AAProfile with
    position-specific scores and gap open/close costs."""
    lib = _native_exact()
    if lib is not None:
        import ctypes

        qc = np.ascontiguousarray(profile.convert(q), dtype=np.int32)
        m = profile.len()
        ps = np.ascontiguousarray(profile.pos_scores[: m + 1], dtype=np.int32)
        goc = np.ascontiguousarray(profile.gap_open_C[: m + 1], dtype=np.int32)
        gcc = np.ascontiguousarray(profile.gap_close_C[: m + 1], dtype=np.int32)
        gor = np.ascontiguousarray(profile.gap_open_R[: m + 1], dtype=np.int32)
        return int(
            lib.ba_global_profile_score(
                qc.ctypes.data_as(ctypes.c_void_p), len(qc),
                ps.ctypes.data_as(ctypes.c_void_p), m,
                goc.ctypes.data_as(ctypes.c_void_p),
                gcc.ctypes.data_as(ctypes.c_void_p),
                gor.ctypes.data_as(ctypes.c_void_p),
                profile.get_gap_extend(),
            )
        )
    q_codes = profile.convert(q)
    n = len(q_codes)
    m = profile.len()
    e = profile.get_gap_extend()

    D = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    C = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    R = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    D[0, 0] = 0
    for j in range(1, m + 1):
        C[0, j] = max(C[0, j - 1] + e, D[0, j - 1] + int(profile.gap_open_C[j]) + e)
        D[0, j] = C[0, j] + int(profile.gap_close_C[j])
    for i in range(1, n + 1):
        R[i, 0] = max(R[i - 1, 0] + e, D[i - 1, 0] + int(profile.gap_open_R[0]) + e)
        D[i, 0] = R[i, 0]
        for j in range(1, m + 1):
            C[i, j] = max(C[i, j - 1] + e, D[i, j - 1] + int(profile.gap_open_C[j]) + e)
            R[i, j] = max(R[i - 1, j] + e, D[i - 1, j] + int(profile.gap_open_R[j]) + e)
            sub = D[i - 1, j - 1] + int(profile.pos_scores[j, q_codes[i - 1]])
            D[i, j] = max(sub, C[i, j] + int(profile.gap_close_C[j]), R[i, j])
    return int(D[n, m])


def x_drop_score(q, r, matrix, gaps, x: int) -> Tuple[int, int, int]:
    """Full-DP x-drop alignment: best score and its (query, reference) end
    position, with cells pruned once they fall more than ``x`` below the
    running best (reference: examples/x_drop_accuracy.rs:109-160).

    Ties on score prefer smaller query index then smaller reference index.
    """
    from .scores import ByteMatrix

    lib = _native_exact()
    if lib is not None and not isinstance(matrix, ByteMatrix):
        import ctypes

        qc = np.ascontiguousarray(
            matrix.col_index(matrix.convert(q)), dtype=np.int32
        )
        rc = np.ascontiguousarray(
            matrix.row_index(matrix.convert(r)), dtype=np.int32
        )
        tab = np.ascontiguousarray(matrix.dense(), dtype=np.int32)
        s = ctypes.c_int64()
        bi = ctypes.c_int64()
        bj = ctypes.c_int64()
        lib.ba_xdrop_score(
            qc.ctypes.data_as(ctypes.c_void_p), len(qc),
            rc.ctypes.data_as(ctypes.c_void_p), len(rc),
            tab.ctypes.data_as(ctypes.c_void_p), tab.shape[1],
            gaps.open, gaps.extend, x,
            ctypes.byref(s), ctypes.byref(bi), ctypes.byref(bj),
        )
        return int(s.value), int(bi.value), int(bj.value)
    q_codes = matrix.convert(q)
    r_codes = matrix.convert(r)
    n, m = len(q_codes), len(r_codes)
    S = _score_matrix_rows(matrix, q_codes, r_codes)
    o, e = gaps.open, gaps.extend

    D = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    C = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    R = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    D[0, 0] = 0
    best = 0
    best_i = best_j = 0
    for i in range(0, n + 1):
        for j in range(0, m + 1):
            if i == 0 and j == 0:
                continue
            if j > 0:
                C[i, j] = max(C[i, j - 1] + e, D[i, j - 1] + o)
            if i > 0:
                R[i, j] = max(R[i - 1, j] + e, D[i - 1, j] + o)
            sub = D[i - 1, j - 1] + S[i - 1, j - 1] if (i > 0 and j > 0) else NEG
            d = max(sub, C[i, j], R[i, j])
            if d < best - x:
                d = NEG
            D[i, j] = d
            if d > best:
                best, best_i, best_j = d, i, j
    return int(best), best_i, best_j
