"""Exact scalar transcription of the block aligner state machine.

This is the semantic oracle for the batched routes: a NumPy, per-pair,
branch-y re-derivation of the adaptive block algorithm with AVX2 (L=16)
lane semantics, transcribed from the reference driver
(reference: src/scan_block.rs:94-595 ``align_core_gen!``) and compute rect
(reference: src/scan_block.rs:1063-1228 ``place_block``,
src/scan_block.rs:612-783 ``place_block_profile_gen!``).

Everything the engine and the CUDA kernel must bit-match is defined here:
  * i16 saturating arithmetic relative to ``ZERO = 2^14`` with ``MIN = 0``
    border initialization and i32 running offsets,
  * the exact 3-level log prefix scan with per-8-lane zero shift-in and
    cross-half/cross-chunk carries (reference: src/avx2.rs:295-338),
  * shift/grow/shrink/checkpoint heuristics and tie-breaking
    (``down_max > right_max``; x-drop argmax lowest-lane ties),
  * packed 2+2-bit trace semantics and the OP_LUT traceback
    (reference: src/scan_block.rs:1342-1692).

It is intentionally slow (clarity first); tests use it both directly on
golden cases and as the bit-exactness oracle for the batched engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .cigar import Cigar
from .scores import AAProfile, ByteMatrix, Gaps
from .seqs import PaddedBytes

__all__ = [
    "AlignResult",
    "Rectangle",
    "BlockOracle",
    "L",
    "STEP",
    "ZERO",
    "MIN_VAL",
]

# Canonical lane parameters: AVX2 backend semantics (reference: src/avx2.rs:11-16)
L = 16
STEP = 8
ZERO = 1 << 14
MIN_VAL = 0
X_DROP_ITER = 2  # reference: src/scan_block.rs:788
SHRINK = True
SHRINK_SUFFIX_LEN = STEP // 4

I16_MIN = -(1 << 15)
I16_MAX = (1 << 15) - 1


def sat(x):
    """Saturating i16 add result (operands assumed already in-range)."""
    return np.clip(x, I16_MIN, I16_MAX)


def clamp16(x: int) -> int:
    """i32 -> i16 clamp (reference: src/scan_block.rs:1703-1706)."""
    return int(min(max(x, I16_MIN), I16_MAX))


@dataclass(frozen=True)
class AlignResult:
    """Score and end position (reference: src/scan_block.rs:1887-1893)."""

    score: int
    query_idx: int
    reference_idx: int


@dataclass(frozen=True)
class Rectangle:
    """A computed DP rectangle (reference: src/scan_block.rs:1694-1701)."""

    row: int
    col: int
    width: int
    height: int


class _Rect:
    """Trace storage for one computed rectangle (append-only, stack-popped on
    checkpoint restore; reference: src/scan_block.rs:1342-1462).

    ``row``/``col`` are the DP origin; ``dp_width``/``dp_height`` are DP-axis
    extents (cols/rows), matching the reference's ``add_block`` convention.
    Trace arrays are stored in *place* orientation: ``t[place_col, lane]``
    where for right rects lanes run along DP rows, for down rects along DP
    cols."""

    __slots__ = ("row", "col", "dp_width", "dp_height", "right", "t", "t2", "zero")

    def __init__(self, row, col, dp_width, dp_height, right):
        self.row = row
        self.col = col
        self.dp_width = dp_width
        self.dp_height = dp_height
        self.right = right
        place_cols = dp_width if right else dp_height
        lanes = dp_height if right else dp_width
        self.t = np.zeros((place_cols, lanes), dtype=np.uint8)
        self.t2 = np.zeros((place_cols, lanes), dtype=np.uint8)
        self.zero = np.zeros((place_cols, lanes), dtype=np.uint8)


def _prefix_scan_chunk(v: np.ndarray, e: int) -> np.ndarray:
    """16-lane prefix max-plus scan, exactly as the AVX2 kernel computes it
    (reference: src/avx2.rs:312-338): 3 log-steps of *per-8-lane-half*
    shift-in-zeros + saturating add, then a cross-half correction using
    ``(k+1)*e`` lane constants."""
    assert v.shape == (L,)

    def sllz_half(x, n):
        out = np.zeros_like(x)
        out[n:8] = x[0 : 8 - n]
        out[8 + n : 16] = x[8 : 16 - n]
        return out

    s = np.maximum(v, sat(sllz_half(v, 1) + e))
    s = np.maximum(s, sat(sllz_half(s, 2) + 2 * e))
    s = np.maximum(s, sat(sllz_half(s, 4) + 4 * e))
    # cross-half correction: candidate = s[7] + (k+1)*e for upper-half lane k
    lane_consts = sat(np.arange(1, 9) * e)
    corr = sat(s[7] + lane_consts)
    s[8:16] = np.maximum(s[8:16], corr)
    return s


def _gap_extend_all(e: int) -> np.ndarray:
    """Cross-chunk carry constants ``(k+1)*e`` for k in 0..15
    (reference: src/avx2.rs:297-310)."""
    return sat(np.arange(1, L + 1) * e)


class _MaxTracker:
    """Per-lane (row % L residue) running max with chunk-granular argmax,
    replicating the SIMD D_max/D_argmax bookkeeping
    (reference: src/scan_block.rs:1192-1201)."""

    __slots__ = ("vmax", "arg_i", "arg_j")

    def __init__(self):
        self.vmax = np.full(L, MIN_VAL, dtype=np.int64)
        self.arg_i = np.zeros(L, dtype=np.int64)
        self.arg_j = np.zeros(L, dtype=np.int64)

    def update(self, chunk: np.ndarray, i0: int, j: int, track_arg: bool):
        self.vmax = np.maximum(self.vmax, chunk)
        if track_arg:
            eq = self.vmax == chunk
            self.arg_i = np.where(eq, i0, self.arg_i)
            self.arg_j = np.where(eq, j, self.arg_j)

    def hmax(self) -> int:
        return int(self.vmax.max())

    def hargmax(self) -> int:
        """Lowest lane index achieving the max (reference: src/avx2.rs:269-274)."""
        m = self.hmax()
        return int(np.nonzero(self.vmax == m)[0][0])

    def lane(self, k: int) -> Tuple[int, int, int]:
        return int(self.vmax[k]), int(self.arg_i[k]), int(self.arg_j[k])


class BlockOracle:
    """Scalar block aligner with the reference's exact semantics.

    Mode flags mirror the reference const generics
    ``Block<TRACE, X_DROP, LOCAL_START, FREE_QUERY_START_GAPS,
    FREE_QUERY_END_GAPS>`` (reference: src/scan_block.rs:89).
    """

    def __init__(
        self,
        trace: bool = False,
        x_drop: bool = False,
        local_start: bool = False,
        free_query_start_gaps: bool = False,
        free_query_end_gaps: bool = False,
    ):
        self.TRACE = trace
        self.X_DROP = x_drop
        self.LOCAL_START = local_start
        self.FREE_QUERY_START_GAPS = free_query_start_gaps
        self.FREE_QUERY_END_GAPS = free_query_end_gaps
        self._res: Optional[AlignResult] = None
        self._rects: List[_Rect] = []
        self._ckpt_rects = 0
        self._q: Optional[PaddedBytes] = None
        self._r_seq: Optional[PaddedBytes] = None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def align(self, query: PaddedBytes, reference, matrix, gaps: Gaps, size, x_drop: int = 0):
        """Sequence-sequence alignment (reference: src/scan_block.rs:847-878)."""
        assert gaps.open < 0 and gaps.extend < 0, "Gap costs must be negative!"
        assert gaps.open < gaps.extend, "Gap open must cost more than gap extend!"
        min_size, max_size = self._check_sizes(size)
        if self.X_DROP:
            assert x_drop >= 0
        assert not (self.LOCAL_START and self.FREE_QUERY_START_GAPS)
        assert not (self.X_DROP and self.FREE_QUERY_END_GAPS)
        if self.FREE_QUERY_END_GAPS:
            assert min_size > query.len()

        self._q, self._r_seq = query, reference
        fetch = _SeqSeqFetch(query, reference, matrix, gaps)
        self._align_core(fetch, query.len(), reference.len(), min_size, max_size, x_drop)

    def align_profile(self, query: PaddedBytes, profile: AAProfile, size, x_drop: int = 0):
        """Sequence-profile alignment (reference: src/scan_block.rs:942-968)."""
        assert profile.get_gap_extend() < 0
        min_size, max_size = self._check_sizes(size)
        if self.X_DROP:
            assert x_drop >= 0
        assert not (self.LOCAL_START and self.FREE_QUERY_START_GAPS)
        assert not (self.X_DROP and self.FREE_QUERY_END_GAPS)
        if self.FREE_QUERY_END_GAPS:
            assert min_size > query.len()

        self._q, self._r_seq = query, None
        fetch = _SeqProfileFetch(query, profile)
        self._align_core(fetch, query.len(), profile.len(), min_size, max_size, x_drop)

    def align_exp(self, query, reference, matrix, gaps, size, x_drop, target_score):
        """Exponential search on min block size (reference: src/scan_block.rs:884-902)."""
        min_size, max_size = self._check_sizes(size)
        while min_size <= max_size:
            self.align(query, reference, matrix, gaps, (min_size, max_size), x_drop)
            if self.res().score >= target_score:
                return min_size
            min_size *= 2
        return None

    def align_profile_exp(self, query, profile, size, x_drop, target_score):
        min_size, max_size = self._check_sizes(size)
        while min_size <= max_size:
            self.align_profile(query, profile, (min_size, max_size), x_drop)
            if self.res().score >= target_score:
                return min_size
            min_size *= 2
        return None

    def res(self) -> AlignResult:
        assert self._res is not None
        return self._res

    def trace_blocks(self) -> List[Rectangle]:
        return [Rectangle(r.row, r.col, r.dp_width, r.dp_height) for r in self._rects]

    def cigar(self, i: int, j: int, cigar: Optional[Cigar] = None) -> Cigar:
        return self._cigar_core(i, j, eq=False, cigar=cigar)

    def cigar_eq(self, query, reference, i: int, j: int, cigar: Optional[Cigar] = None) -> Cigar:
        return self._cigar_core(i, j, eq=True, cigar=cigar, q=query, r=reference)

    # ------------------------------------------------------------------
    @staticmethod
    def _check_sizes(size) -> Tuple[int, int]:
        if isinstance(size, (tuple, list)):
            lo, hi = size
        elif isinstance(size, range):
            lo, hi = size.start, size.stop - 1
        else:
            lo = hi = int(size)
        min_size = L if lo < L else lo
        max_size = L if hi < L else hi
        assert min_size < (1 << 16) - 1 and max_size < (1 << 16) - 1
        assert min_size & (min_size - 1) == 0 and max_size & (max_size - 1) == 0
        return min_size, max_size

    # ------------------------------------------------------------------
    # driver (reference: src/scan_block.rs:101-593)
    # ------------------------------------------------------------------
    def _align_core(self, fetch, qlen, rlen, min_size, max_size, x_drop):
        self._rects = []
        self._ckpt_rects = 0

        best_max = 0
        best_argmax_i = 0
        best_argmax_j = 0

        RIGHT, DOWN, GROW = 0, 1, 2
        prev_dir = GROW
        direction = GROW
        prev_size = 0
        block_size = min_size

        off = 0
        off_max = 0
        y_drop_iter = 0
        x_drop_iter = 0

        s_i, s_j = 0, 0
        i_ckpt, j_ckpt, off_ckpt = 0, 0, 0

        # borders (length max_size, i16 values held in int64)
        D_col = np.full(max_size, MIN_VAL, dtype=np.int64)
        C_col = np.full(max_size, MIN_VAL, dtype=np.int64)
        D_row = np.full(max_size, MIN_VAL, dtype=np.int64)
        R_row = np.full(max_size, MIN_VAL, dtype=np.int64)
        D_col_ck = D_col.copy()
        C_col_ck = C_col.copy()
        D_row_ck = D_row.copy()
        R_row_ck = R_row.copy()
        temp1 = np.full(L, MIN_VAL, dtype=np.int64)
        temp2 = np.full(L, MIN_VAL, dtype=np.int64)

        D_corner_scalar = MIN_VAL  # broadcast value entering lane 0 of the first column

        while True:
            prev_off = off
            grow_tracker = None

            if direction == RIGHT:
                off = off_max
                off_add = clamp16(prev_off - off)
                if self.TRACE:
                    self._add_rect(s_i, s_j + block_size - STEP, STEP, block_size, True)
                D_col[:block_size] = sat(D_col[:block_size] + off_add)
                C_col[:block_size] = sat(C_col[:block_size] + off_add)
                corner = (
                    sat(np.int64(D_corner_scalar) + off_add) if prev_dir == DOWN else MIN_VAL
                )
                tracker, right_only_exit = self._place_block(
                    fetch,
                    right=True,
                    start_i=s_i,
                    start_j=s_j + block_size - STEP,
                    width=STEP,
                    height=block_size,
                    D_col=D_col,
                    C_col=C_col,
                    D_row=temp1,
                    R_row=temp2,
                    d_corner=corner,
                    relative_zero=clamp16(-off + ZERO),
                    qlen=qlen,
                    rlen=rlen,
                )
                right_max = int(D_col[:STEP].max())
                D_corner_scalar = int(sat(D_row[STEP - 1] + off_add))
                D_row[: block_size - STEP] = sat(D_row[STEP:block_size] + off_add)
                R_row[: block_size - STEP] = sat(R_row[STEP:block_size] + off_add)
                D_row[block_size - STEP : block_size] = temp1[:STEP]
                R_row[block_size - STEP : block_size] = temp2[:STEP]
                down_max = int(D_row[:STEP].max())

            elif direction == DOWN:
                off = off_max
                off_add = clamp16(prev_off - off)
                if self.TRACE:
                    self._add_rect(s_i + block_size - STEP, s_j, block_size, STEP, False)
                D_row[:block_size] = sat(D_row[:block_size] + off_add)
                R_row[:block_size] = sat(R_row[:block_size] + off_add)
                corner = (
                    sat(np.int64(D_corner_scalar) + off_add) if prev_dir == RIGHT else MIN_VAL
                )
                tracker, right_only_exit = self._place_block(
                    fetch,
                    right=False,
                    start_i=s_j,
                    start_j=s_i + block_size - STEP,
                    width=STEP,
                    height=block_size,
                    D_col=D_row,
                    C_col=R_row,
                    D_row=temp1,
                    R_row=temp2,
                    d_corner=corner,
                    relative_zero=clamp16(-off + ZERO),
                    qlen=qlen,
                    rlen=rlen,
                )
                down_max = int(D_row[:STEP].max())
                D_corner_scalar = int(sat(D_col[STEP - 1] + off_add))
                D_col[: block_size - STEP] = sat(D_col[STEP:block_size] + off_add)
                C_col[: block_size - STEP] = sat(C_col[STEP:block_size] + off_add)
                D_col[block_size - STEP : block_size] = temp1[:STEP]
                C_col[block_size - STEP : block_size] = temp2[:STEP]
                right_max = int(D_col[:STEP].max())

            else:  # GROW
                D_corner_scalar = MIN_VAL
                grow_step = block_size - prev_size
                if self.TRACE:
                    self._add_rect(s_i + prev_size, s_j, prev_size, grow_step, False)
                grow_tracker, _ = self._place_block(
                    fetch,
                    right=False,
                    start_i=s_j,
                    start_j=s_i + prev_size,
                    width=grow_step,
                    height=prev_size,
                    D_col=D_row,
                    C_col=R_row,
                    D_row=D_col[prev_size:],
                    R_row=C_col[prev_size:],
                    d_corner=MIN_VAL,
                    relative_zero=clamp16(-off + ZERO),
                    qlen=qlen,
                    rlen=rlen,
                )
                if self.TRACE:
                    self._add_rect(s_i, s_j + prev_size, grow_step, block_size, True)
                tracker, right_only_exit = self._place_block(
                    fetch,
                    right=True,
                    start_i=s_i,
                    start_j=s_j + prev_size,
                    width=grow_step,
                    height=block_size,
                    D_col=D_col,
                    C_col=C_col,
                    D_row=D_row[prev_size:],
                    R_row=R_row[prev_size:],
                    d_corner=MIN_VAL,
                    relative_zero=clamp16(-off + ZERO),
                    qlen=qlen,
                    rlen=rlen,
                )
                right_max = int(D_col[:STEP].max())
                down_max = int(D_row[:STEP].max())
                D_col_ck[:block_size] = D_col[:block_size]
                C_col_ck[:block_size] = C_col[:block_size]
                D_row_ck[:block_size] = D_row[:block_size]
                R_row_ck[:block_size] = R_row[:block_size]
                if self.TRACE:
                    self._ckpt_rects = len(self._rects)

            prev_dir = direction

            if self.FREE_QUERY_END_GAPS:
                D_max_max = int(tracker.vmax[qlen % L])
            else:
                D_max_max = tracker.hmax()
            grow_max = grow_tracker.hmax() if grow_tracker is not None else MIN_VAL
            cur_max = max(D_max_max, grow_max)
            off_max = off + cur_max - ZERO

            y_drop_iter += 1
            grow_no_max = direction == GROW

            if off_max > best_max:
                if self.FREE_QUERY_END_GAPS:
                    idx_j = int(tracker.arg_j[qlen % L])
                    best_argmax_i = qlen
                    if direction == RIGHT:
                        best_argmax_j = s_j + (block_size - STEP) + idx_j
                    elif direction == GROW:
                        best_argmax_j = s_j + prev_size + idx_j
                    else:
                        raise AssertionError

                if self.X_DROP:
                    lane_idx = tracker.hargmax()
                    _, idx_i, idx_j = tracker.lane(lane_idx)
                    r_pos = idx_i + lane_idx
                    c_pos = (block_size - STEP) + idx_j
                    if direction == RIGHT:
                        best_argmax_i = s_i + r_pos
                        best_argmax_j = s_j + c_pos
                    elif direction == DOWN:
                        best_argmax_i = s_i + c_pos
                        best_argmax_j = s_j + r_pos
                    else:  # GROW
                        if D_max_max >= grow_max:
                            best_argmax_i = s_i + idx_i + lane_idx
                            best_argmax_j = s_j + prev_size + idx_j
                        else:
                            lane_idx = grow_tracker.hargmax()
                            _, idx_i, idx_j = grow_tracker.lane(lane_idx)
                            best_argmax_i = s_i + prev_size + idx_j
                            best_argmax_j = s_j + idx_i + lane_idx

                if block_size < max_size:
                    i_ckpt, j_ckpt, off_ckpt = s_i, s_j, off
                    D_col_ck[:block_size] = D_col[:block_size]
                    C_col_ck[:block_size] = C_col[:block_size]
                    D_row_ck[:block_size] = D_row[:block_size]
                    R_row_ck[:block_size] = R_row[:block_size]
                    if self.TRACE:
                        self._ckpt_rects = len(self._rects)
                    grow_no_max = False

                best_max = off_max
                y_drop_iter = 0

            if self.X_DROP:
                if off_max < best_max - x_drop:
                    if x_drop_iter < X_DROP_ITER - 1:
                        x_drop_iter += 1
                    else:
                        break
                else:
                    x_drop_iter = 0

            if s_i + block_size > qlen and s_j + block_size > rlen:
                break

            if s_j + block_size > rlen:
                s_i += STEP
                direction = DOWN
                continue
            if s_i + block_size > qlen:
                s_j += STEP
                direction = RIGHT
                continue

            # grow heuristic
            next_size = block_size * 2
            if next_size <= max_size and (y_drop_iter > (block_size // STEP) - 1 or grow_no_max):
                prev_size = block_size
                block_size = next_size
                direction = GROW
                s_i, s_j, off = i_ckpt, j_ckpt, off_ckpt
                D_col[:prev_size] = D_col_ck[:prev_size]
                C_col[:prev_size] = C_col_ck[:prev_size]
                D_row[:prev_size] = D_row_ck[:prev_size]
                R_row[:prev_size] = R_row_ck[:prev_size]
                if self.TRACE:
                    del self._rects[self._ckpt_rects :]
                y_drop_iter = 0
                continue

            # shrink heuristic
            if SHRINK and block_size > min_size and y_drop_iter == 0:
                shrink_max = max(
                    int(D_row[block_size - SHRINK_SUFFIX_LEN : block_size].max()),
                    int(D_col[block_size - SHRINK_SUFFIX_LEN : block_size].max()),
                )
                if shrink_max >= cur_max:
                    prev_dir = GROW  # kill D_corner usage in the next step
                    block_size //= 2
                    D_col[:block_size] = D_col[block_size : 2 * block_size]
                    C_col[:block_size] = C_col[block_size : 2 * block_size]
                    D_row[:block_size] = D_row[block_size : 2 * block_size]
                    R_row[:block_size] = R_row[block_size : 2 * block_size]
                    s_i += block_size
                    s_j += block_size
                    i_ckpt, j_ckpt, off_ckpt = s_i, s_j, off
                    D_col_ck[:block_size] = D_col[:block_size]
                    C_col_ck[:block_size] = C_col[:block_size]
                    D_row_ck[:block_size] = D_row[:block_size]
                    R_row_ck[:block_size] = R_row[:block_size]
                    right_max = int(D_col[:STEP].max())
                    down_max = int(D_row[:STEP].max())
                    if self.TRACE:
                        self._ckpt_rects = len(self._rects)
                    y_drop_iter = 0

            if down_max > right_max:
                s_i += STEP
                direction = DOWN
            else:
                s_j += STEP
                direction = RIGHT

        # final result (reference: src/scan_block.rs:567-592)
        if self.X_DROP or self.FREE_QUERY_END_GAPS:
            self._res = AlignResult(best_max, best_argmax_i, best_argmax_j)
        else:
            if direction in (RIGHT, GROW):
                idx = qlen - s_i
                score = off + int(D_col[idx]) - ZERO
            else:
                idx = rlen - s_j
                score = off + int(D_row[idx]) - ZERO
            self._res = AlignResult(score, qlen, rlen)

    # ------------------------------------------------------------------
    # compute rect (reference: src/scan_block.rs:1083-1228 / 619-781)
    # ------------------------------------------------------------------
    def _place_block(
        self,
        fetch,
        right: bool,
        start_i: int,
        start_j: int,
        width: int,
        height: int,
        D_col: np.ndarray,
        C_col: np.ndarray,
        D_row: np.ndarray,
        R_row: np.ndarray,
        d_corner: int,
        relative_zero: int,
        qlen: int,
        rlen: int,
    ):
        tracker = _MaxTracker()
        if width == 0 or height == 0:
            return tracker, False

        e = fetch.gap_extend
        gea = _gap_extend_all(e)
        rect = self._rects[-1] if self.TRACE else None

        # orientation-dependent sequence lengths for the early-exit check:
        # inside the rect, "query" is the lanes axis
        lane_len = qlen if right else rlen
        col_len = rlen if right else qlen

        corner_vec_last = d_corner  # lane L-1 of the D_corner vector
        for j in range(width):
            R01_last = MIN_VAL  # last lane of previous chunk's R
            prev_trace_R = np.zeros(L, dtype=np.uint8)  # full chunk; lane L-1 carries
            col_params = fetch.column(right, start_i, start_j + j, height)
            scores, gap_open_C, gap_close_C, gap_open_R, gap_close_R = col_params

            D11_full = np.empty(height, dtype=np.int64)
            C11_full = np.empty(height, dtype=np.int64)
            R11_full = np.empty(height, dtype=np.int64)

            for i0 in range(0, height, L):
                D10 = D_col[i0 : i0 + L].astype(np.int64)
                C10 = C_col[i0 : i0 + L].astype(np.int64)
                D00 = np.empty(L, dtype=np.int64)
                D00[0] = corner_vec_last
                D00[1:] = D10[:-1]
                corner_vec_last = D10[L - 1]

                sc = scores[i0 : i0 + L]
                D11 = sat(D00 + sc)
                gi = start_i + i0
                gj = start_j + j
                if (not self.LOCAL_START and gi == 0 and gj == 0) or (
                    self.FREE_QUERY_START_GAPS and right and gi == 0
                ):
                    D11[0] = relative_zero
                if self.LOCAL_START:
                    D11 = np.maximum(D11, relative_zero)

                goc = gap_open_C[i0 : i0 + L]
                C11_open = sat(D10 + goc)
                C11 = np.maximum(sat(C10 + e), C11_open)
                if right and gap_close_C is not None:
                    C11_end = sat(C11 + gap_close_C[i0 : i0 + L])
                else:
                    C11_end = C11
                D11 = np.maximum(D11, C11_end)

                gor = gap_open_R[i0 : i0 + L]
                D11_open = sat(D11 + gor)
                R11 = _prefix_scan_chunk(D11_open, e)
                R11 = np.maximum(R11, sat(R01_last + gea))
                if (not right) and gap_close_R is not None:
                    R11_end = sat(R11 + gap_close_R[i0 : i0 + L])
                else:
                    R11_end = R11
                D11 = np.maximum(D11, R11_end)
                R01_last = R11[L - 1]

                if self.TRACE:
                    trace_D_C = (D11 == C11_end).astype(np.uint8)
                    trace_D_R = (D11 == R11_end).astype(np.uint8)
                    t = trace_D_C | (trace_D_R << 1)
                    temp_trace_R = (R11 == D11_open).astype(np.uint8)
                    trace_R = np.empty(L, dtype=np.uint8)
                    trace_R[0] = prev_trace_R[L - 1]
                    trace_R[1:] = temp_trace_R[:-1]
                    t2 = (C11 == C11_open).astype(np.uint8) | (trace_R << 1)
                    prev_trace_R = temp_trace_R
                    rect.t[j, i0 : i0 + L] = t
                    rect.t2[j, i0 : i0 + L] = t2
                    if self.LOCAL_START:
                        rect.zero[j, i0 : i0 + L] = (D11 == relative_zero).astype(np.uint8)

                track_arg = self.X_DROP or (
                    self.FREE_QUERY_END_GAPS and start_i + i0 + L > qlen
                )
                tracker.update(D11, i0, j, track_arg)

                D_col[i0 : i0 + L] = D11
                C_col[i0 : i0 + L] = C11
                D11_full[i0 : i0 + L] = D11
                R11_full[i0 : i0 + L] = R11

            corner_vec_last = MIN_VAL
            D_row[j] = D11_full[height - 1]
            R_row[j] = R11_full[height - 1]

            if (
                not self.X_DROP
                and not self.FREE_QUERY_END_GAPS
                and start_i + height > lane_len
                and start_j + j >= col_len
            ):
                return tracker, True

        return tracker, False

    # ------------------------------------------------------------------
    # trace bookkeeping
    # ------------------------------------------------------------------
    def _add_rect(self, row, col, dp_width, dp_height, right):
        """Same argument order as the reference ``Trace::add_block(i, j,
        width, height, right)`` (reference: src/scan_block.rs:1428-1443)."""
        self._rects.append(_Rect(row, col, dp_width, dp_height, right))

    # ------------------------------------------------------------------
    # traceback (reference: src/scan_block.rs:1469-1672)
    # ------------------------------------------------------------------
    def _cigar_core(self, i, j, eq, cigar=None, q=None, r=None):
        assert self.TRACE
        from .traceback import cigar_walk

        return cigar_walk(
            self._rects, i, j,
            local_start=self.LOCAL_START,
            free_query_start_gaps=self.FREE_QUERY_START_GAPS,
            eq=eq, q=q, r=r, cigar=cigar,
        )


class _SeqSeqFetch:
    """Column score/gap fetch for sequence-sequence rects."""

    def __init__(self, query: PaddedBytes, reference: PaddedBytes, matrix, gaps: Gaps):
        self.q = query.codes
        self.r = reference.codes
        self.matrix = matrix
        self.gaps = gaps
        self.gap_extend = gaps.extend
        self._is_byte = isinstance(matrix, ByteMatrix)
        if not self._is_byte:
            self._tab = matrix.dense()

    def column(self, right, start_i, col, height):
        lanes_codes = (self.q if right else self.r)[start_i : start_i + height].astype(np.int64)
        c = int((self.r if right else self.q)[col])
        if self._is_byte:
            scores = np.where(
                lanes_codes == c, self.matrix.match_score, self.matrix.mismatch_score
            ).astype(np.int64)
        else:
            m = self.matrix
            row = self._tab[int(m.row_index(np.uint8(c)))]
            scores = row[m.col_index(lanes_codes.astype(np.uint8)).astype(np.int64)].astype(
                np.int64
            )
        gap_open = np.full(height, self.gaps.open, dtype=np.int64)
        # seq-seq: D11_open uses (open - extend) since the scan adds one extend
        gap_open_R = np.full(height, self.gaps.open - self.gaps.extend, dtype=np.int64)
        return scores, gap_open, None, gap_open_R, None


class _SeqProfileFetch:
    """Column score/gap fetch for sequence-profile rects (asymmetric:
    right rects read per-position score rows; down rects read per-amino-acid
    score columns with per-lane gap costs; reference: src/scan_block.rs:651-705)."""

    def __init__(self, query: PaddedBytes, profile: AAProfile):
        self.q = query.codes
        self.p = profile
        self.gap_extend = profile.get_gap_extend()

    def column(self, right, start_i, col, height):
        p = self.p
        e = self.gap_extend
        if right:
            lanes_codes = self.q[start_i : start_i + height].astype(np.int64)
            scores = p.pos_scores[col][lanes_codes].astype(np.int64)
            gap_open_C = np.full(height, int(p.gap_open_C[col]) + e, dtype=np.int64)
            gap_close_C = np.full(height, int(p.gap_close_C[col]), dtype=np.int64)
            gap_open_R = np.full(height, int(p.gap_open_R[col]), dtype=np.int64)
            return scores, gap_open_C, gap_close_C, gap_open_R, None
        else:
            c = int(self.q[col])
            pos = np.arange(start_i, start_i + height)
            scores = p.pos_scores[pos, c].astype(np.int64)
            # rect-C here = DP row gaps -> per-lane profile gap_open_R;
            # rect-R = DP column gaps -> per-lane gap_open_C with close costs
            gap_open_C = p.gap_open_R[pos].astype(np.int64) + e
            gap_open_R = p.gap_open_C[pos].astype(np.int64)
            gap_close_R = p.gap_close_C[pos].astype(np.int64)
            return scores, gap_open_C, None, gap_open_R, gap_close_R
