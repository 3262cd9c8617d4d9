"""Traceback: shared CIGAR walker and the batched-engine trace decoder.

The walker implements the reference's backwards block walk with the
2x64-entry OP_LUT (reference: src/scan_block.rs:1469-1672).  It operates on
an ordered list of rect records -- either the scalar oracle's rects or rects
reconstructed from the batched engine's per-iteration trace stream.

Engine trace stream format (see ops/engine.py): per while-loop iteration the
engine appends, for every pair,

* ``trace[it, b, lane]`` (int8): packed per-cell bits
  ``t | t2 << 2 | zero << 4`` for the DP column computed this iteration
  (t/t2 as in reference: src/scan_block.rs:1166-1190), and
* ``meta[it, b, 0..1]`` (int32): packed column descriptor --
  meta1 = starti | right<<25 | valid<<26 | save<<27 | restore<<28 |
  rectstart<<29;  meta2 = colpos | height<<17.

``save``/``restore`` reproduce the reference's stack-like trace checkpoint
(reference: src/scan_block.rs:1451-1462): ``save`` marks the current rect
count; ``restore`` (on block grow) pops rects back to the mark.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .cigar import Cigar, Operation

STEP_ = 8  # reference STEP (src/scan_block.rs:785)

__all__ = ["cigar_walk", "op_lut", "TraceRect", "EngineTrace"]

_OP_LUT_CACHE = None


def op_lut():
    """The 2x64-entry traceback LUT keyed by (trace<<4 | trace2<<2 | table)
    (reference: src/scan_block.rs:1506-1572)."""
    global _OP_LUT_CACHE
    if _OP_LUT_CACHE is not None:
        return _OP_LUT_CACHE
    D, C, R = 0, 1, 2
    OpD, OpI, OpM = Operation.D, Operation.I, Operation.M
    lut = [[(OpD, 0, 1, D)] * 64, [(OpD, 0, 1, D)] * 64]
    for right in (0, 1):
        for t in range(4):
            for t2 in range(4):
                for table in (D, C, R):
                    if right == 1:
                        if table == C:
                            res = (OpD, 0, 1, C) if t2 in (0b00, 0b10) else (OpD, 0, 1, D)
                        elif table == R:
                            res = (OpI, 1, 0, R) if t2 in (0b00, 0b01) else (OpI, 1, 0, D)
                        else:  # D
                            if t == 0b00:
                                res = (OpM, 1, 1, D)
                            elif t in (0b01, 0b11):
                                res = (
                                    (OpD, 0, 1, C) if t2 in (0b00, 0b10) else (OpD, 0, 1, D)
                                )
                            else:  # t == 0b10
                                res = (
                                    (OpI, 1, 0, R) if t2 in (0b00, 0b01) else (OpI, 1, 0, D)
                                )
                    else:
                        if table == R:
                            res = (OpI, 1, 0, R) if t2 in (0b00, 0b10) else (OpI, 1, 0, D)
                        elif table == C:
                            res = (OpD, 0, 1, C) if t2 in (0b00, 0b01) else (OpD, 0, 1, D)
                        else:
                            if t == 0b00:
                                res = (OpM, 1, 1, D)
                            elif t in (0b01, 0b11):
                                res = (
                                    (OpI, 1, 0, R) if t2 in (0b00, 0b10) else (OpI, 1, 0, D)
                                )
                            else:
                                res = (
                                    (OpD, 0, 1, C) if t2 in (0b00, 0b01) else (OpD, 0, 1, D)
                                )
                    lut[right][(t << 4) | (t2 << 2) | table] = res
    _OP_LUT_CACHE = lut
    return lut


def cigar_walk(
    rects,
    i: int,
    j: int,
    *,
    local_start: bool = False,
    free_query_start_gaps: bool = False,
    eq: bool = False,
    q=None,
    r=None,
    cigar: Optional[Cigar] = None,
) -> Cigar:
    """Walk backwards from DP cell (i, j) over an ordered rect list.

    Rect records need fields ``row``, ``col``, ``right`` and indexable
    ``t``, ``t2`` (and ``zero`` when ``local_start``) of shape
    [place_col, lane] (reference walk: src/scan_block.rs:1576-1632).
    """
    if cigar is None:
        cigar = Cigar()
    cigar.clear()
    if eq:
        assert q is not None and r is not None

    lut = op_lut()
    TABLE_D = 0
    table = TABLE_D
    rect_idx = len(rects)

    outer_done = False
    while (i > 0 or j > 0) and not outer_done:
        # scan rects backward for the one containing (i, j); the reference
        # checks only lower bounds (reference: src/scan_block.rs:1578-1590)
        while True:
            rect_idx -= 1
            rect = rects[rect_idx]
            if i >= rect.row and j >= rect.col:
                break

        bi, bj = rect.row, rect.col
        while i >= bi and j >= bj and (i > 0 or j > 0):
            if rect.right:
                if free_query_start_gaps and i == 0:
                    # the i == 0 row can only be inside right rects
                    outer_done = True
                    break
                pc, lane = j - bj, i - bi  # place col = DP col offset
            else:
                pc, lane = i - bi, j - bj  # place col = DP row offset
            t = int(rect.t[pc, lane])
            t2 = int(rect.t2[pc, lane])
            if local_start and table == TABLE_D and rect.zero[pc, lane]:
                outer_done = True
                break
            op, di, dj, table = lut[1 if rect.right else 0][(t << 4) | (t2 << 2) | table]
            if eq and op == Operation.M:
                op = Operation.Eq if q.get(i) == r.get(j) else Operation.X
            i -= di
            j -= dj
            cigar.add(op)

    return cigar


class TraceRect:
    """A rect reconstructed from the engine trace stream.

    ``rows`` are the global iteration indices holding this rect's columns, in
    place-column order.  Bit planes are materialized lazily from the packed
    int8 buffer.
    """

    __slots__ = ("row", "col", "right", "rows", "_data", "_b", "_t", "_t2", "_zero")

    def __init__(self, row: int, col: int, right: bool, data, b: int):
        self.row = row
        self.col = col
        self.right = right
        self.rows: List[int] = []
        self._data = data
        self._b = b
        self._t = None
        self._t2 = None
        self._zero = None

    def _mat(self):
        if self._t is None:
            d = self._data[np.asarray(self.rows, dtype=np.int64), self._b, :]
            self._t = d & 3
            self._t2 = (d >> 2) & 3
            self._zero = (d >> 4) & 1
        return self

    @property
    def t(self):
        return self._mat()._t

    @property
    def t2(self):
        return self._mat()._t2

    @property
    def zero(self):
        return self._mat()._zero


class _BytesCodes:
    """1-based byte view for =/X resolution from raw sequences (byte
    equality == code equality for every matrix's char conversion)."""

    __slots__ = ("codes",)

    def __init__(self, s):
        self.codes = np.frombuffer(b"\0" + bytes(s), dtype=np.uint8)

    def get(self, i: int) -> int:
        return int(self.codes[i])


class EngineTrace:
    """Decoder for the batched engine's trace outputs.

    One instance wraps the whole batch; ``rects_for(b)`` replays pair ``b``'s
    column/save/restore event stream into the final rect list (the engine's
    analogue of ``Trace::blocks()``, reference: src/scan_block.rs:1676-1691).
    """

    def __init__(self, trace, meta, iters: int, *, local_start=False,
                 free_query_start_gaps=False, native=True):
        self.trace = np.ascontiguousarray(np.asarray(trace))
        self.meta = np.ascontiguousarray(np.asarray(meta))
        self.iters = int(iters)
        assert self.iters <= self.trace.shape[0], (
            "engine trace buffer overflow: raise EngineConfig.trace_cols"
        )
        self.local_start = local_start
        self.free_query_start_gaps = free_query_start_gaps
        self._rect_cache = {}
        self._native = None
        self._meta_t = None
        self._trace_t = None
        self._ptrs = None
        if native:
            from ..native import load

            self._native = load()

    def _native_cigar(self, b, i, j, eq=False, q=None, r=None,
                      cigar: Optional[Cigar] = None) -> Optional[Cigar]:
        lib = self._native
        if lib is None:
            return None
        import ctypes

        T, B, H = self.trace.shape
        if self._ptrs is None:
            # pair-major copies of the USED prefix so the C replay and walk
            # read local memory (the (T, B, .) device layout makes per-pair
            # access miss-bound); one bulk transpose amortized over the
            # batch's cigar calls
            T = self.iters
            self._meta_t = np.ascontiguousarray(
                self.meta[: self.iters].transpose(1, 0, 2)
            )
            self._trace_t = np.ascontiguousarray(
                self.trace[: self.iters].transpose(1, 0, 2)
            )
            self._ptrs = (
                self._trace_t.ctypes.data_as(ctypes.c_void_p),
                self._meta_t.ctypes.data_as(ctypes.c_void_p),
            )
        else:
            T = self.iters
        tp, mp = self._ptrs
        # fresh output buffer per call: ctypes releases the GIL, so a shared
        # buffer would race under concurrent cigar calls
        out = np.empty(2 * (int(i) + int(j) + 4), dtype=np.int32)
        op = out.ctypes.data_as(ctypes.c_void_p)
        cap = out.shape[0]
        if eq:
            qc = np.ascontiguousarray(q.codes, dtype=np.uint8)
            rc = np.ascontiguousarray(r.codes, dtype=np.uint8)
            qp = qc.ctypes.data_as(ctypes.c_void_p)
            rp = rc.ctypes.data_as(ctypes.c_void_p)
        else:
            qp = rp = None
        n = lib.ba_trace_cigar(
            tp, mp,
            T, B, H, self.iters, b, int(i), int(j),
            1 if self.local_start else 0,
            1 if self.free_query_start_gaps else 0,
            1 if eq else 0,
            qp, rp,
            op, cap,
        )
        if n < 0:
            return None  # fall back to the python walker
        if cigar is None:
            cigar = Cigar()
        cigar.clear()
        for k in range(int(n) - 1, -1, -1):  # Cigar stores reversed
            cigar.add(Operation(int(out[2 * k])), int(out[2 * k + 1]))
        return cigar

    def rects_for(self, b: int) -> List[TraceRect]:
        if b in self._rect_cache:
            return self._rect_cache[b]
        m1 = self.meta[: self.iters, b, 0]
        m2 = self.meta[: self.iters, b, 1]
        valid = (m1 >> 26) & 1
        save = (m1 >> 27) & 1
        restore = (m1 >> 28) & 1
        rectstart = (m1 >> 29) & 1
        events = np.nonzero((valid & rectstart) | save | restore)[0]

        rects: List[TraceRect] = []
        saved_len = 0
        prev = None  # current open rect
        for row in events.tolist():
            w1 = int(m1[row])
            # close the previous rect's column span
            if prev is not None:
                prev_rows, lo = prev
                sl = valid[lo:row]
                prev_rows.extend((np.nonzero(sl)[0] + lo).tolist())
                prev = None
            # order matters: save marks BEFORE restore pops (a grow step's own
            # trailing save and the next grow's restore can share a row)
            if (w1 >> 27) & 1:
                saved_len = len(rects)
            if (w1 >> 28) & 1:
                del rects[saved_len:]
            if ((w1 >> 26) & 1) and ((w1 >> 29) & 1):
                starti = w1 & ((1 << 25) - 1)
                right = bool((w1 >> 25) & 1)
                colpos = int(m2[row]) & ((1 << 17) - 1)
                if right:
                    rect = TraceRect(starti, colpos, True, self.trace, b)
                else:
                    rect = TraceRect(colpos, starti, False, self.trace, b)
                rect.rows.append(row)
                rects.append(rect)
                prev = (rect.rows, row + 1)
        if prev is not None:
            prev_rows, lo = prev
            sl = valid[lo : self.iters]
            prev_rows.extend((np.nonzero(sl)[0] + lo).tolist())
        self._rect_cache[b] = rects
        return rects

    def blocks(self, b: int):
        """Computed-rect telemetry for pair ``b`` (the engine analogue of
        ``Trace::blocks``, reference: src/scan_block.rs:1676-1691); used for
        the DP-fraction statistic (reference: examples/uc_accuracy.rs:88-89).
        """
        from .oracle import Rectangle

        out = []
        for r in self.rects_for(b):
            n = len(r.rows)
            if r.right:
                height = int(self.meta[r.rows[0], b, 1]) >> 17
                out.append(Rectangle(row=r.row, col=r.col, width=n, height=height))
            else:
                width = int(self.meta[r.rows[0], b, 1]) >> 17
                out.append(Rectangle(row=r.row, col=r.col, width=width, height=n))
        return out

    def cigar(self, b: int, i: int, j: int, cigar: Optional[Cigar] = None) -> Cigar:
        got = self._native_cigar(b, i, j, cigar=cigar)
        if got is not None:
            return got
        return cigar_walk(
            self.rects_for(b), i, j,
            local_start=self.local_start,
            free_query_start_gaps=self.free_query_start_gaps,
            cigar=cigar,
        )

    def cigar_eq(self, b: int, q, r, i: int, j: int,
                 cigar: Optional[Cigar] = None) -> Cigar:
        got = self._native_cigar(b, i, j, eq=True, q=q, r=r, cigar=cigar)
        if got is not None:
            return got
        return cigar_walk(
            self.rects_for(b), i, j,
            local_start=self.local_start,
            free_query_start_gaps=self.free_query_start_gaps,
            eq=True, q=q, r=r, cigar=cigar,
        )

    def cigars_all(self, endpoints, nthreads: int = 8, *,
                   eq: bool = False, seqs=None) -> List[Cigar]:
        """CIGARs for pairs 0..len(endpoints)-1 (native per-pair walks; the
        engine stream replays save/restore events per pair, so there is no
        single flat batch walk).

        ``seqs`` (eq mode): ``(PaddedBytes, PaddedBytes)`` or raw
        ``(bytes, bytes)`` pairs."""
        if not eq:
            return [self.cigar(b, i, j) for b, (i, j) in enumerate(endpoints)]
        assert seqs is not None and len(seqs) == len(endpoints)
        out = []
        for b, ((i, j), (q, r)) in enumerate(zip(endpoints, seqs)):
            if not hasattr(q, "get"):
                q = _BytesCodes(q)
            if not hasattr(r, "get"):
                r = _BytesCodes(r)
            out.append(self.cigar_eq(b, q, r, i, j))
        return out
