"""Scoring matrices, gap parameters, and position-specific profiles.

Batched redesign of the reference scoring layer (reference:
src/scores.rs:17-447).  Instead of pshufb-style byte-shuffle lookups, scores
are represented as dense small integer tables that the alignment engines turn
into per-pair *query score profiles* ``S[c, i] = matrix[c, q[i]]`` so the hot
DP loop fetches a whole column of scores with one contiguous (dynamic-sliced)
read -- the layout hinted at by the reference TODO (src/scores.rs:115).  The
CUDA fixed-block kernel instead looks scores up in a 32x32 code table held
in shared memory.

Conventions (kept identical to the reference so that scores are bit-exact):

* ``AAMatrix``: 27x32 table indexed by ``char - 'A'`` (A..Z plus NULL=26),
  default score for unset entries is -128 (reference: src/scores.rs:40-135).
* ``NucMatrix``: 8x16 table indexed by ``(c & 7, q & 15)`` over raw uppercased
  ASCII (reference: src/scores.rs:142-217).
* ``ByteMatrix``: match/mismatch by byte equality (reference:
  src/scores.rs:219-273).  No table; engines use a compare instead of a
  gather.
* ``Gaps``: ``open`` includes the first extension; a gap of length n costs
  ``open + extend * (n - 1)`` (reference: src/scores.rs:329-338).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import ClassVar, Optional

import numpy as np

_DATA_DIR = Path(__file__).resolve().parent.parent / "data"

__all__ = [
    "Gaps",
    "AAMatrix",
    "NucMatrix",
    "ByteMatrix",
    "AAProfile",
    "NW1",
    "BYTES1",
    "BLOSUM45",
    "BLOSUM50",
    "BLOSUM62",
    "BLOSUM80",
    "BLOSUM90",
    "PAM100",
    "PAM120",
    "PAM160",
    "PAM200",
    "PAM250",
    "percent_len",
]


@dataclasses.dataclass(frozen=True)
class Gaps:
    """Affine gap costs; both must be negative and ``open < extend``.

    ``open`` includes the first extension (reference: src/scores.rs:329-338).
    """

    open: int
    extend: int


def _as_bytes(s) -> bytes:
    if isinstance(s, str):
        return s.encode("ascii")
    if isinstance(s, (bytes, bytearray)):
        return bytes(s)
    return bytes(np.asarray(s, dtype=np.uint8).tobytes())


class AAMatrix:
    """Amino-acid scoring matrix over ``A..Z`` (reference: src/scores.rs:37-135)."""

    kind: ClassVar[str] = "aa"
    #: Padding byte: one past 'Z' (reference: src/scores.rs:83).
    NULL: ClassVar[int] = ord("A") + 26
    #: Number of table rows (26 letters + NULL).
    ROWS: ClassVar[int] = 27
    COLS: ClassVar[int] = 32

    def __init__(self, table: Optional[np.ndarray] = None):
        if table is None:
            table = np.full((27, 32), -128, dtype=np.int32)
        else:
            table = np.asarray(table, dtype=np.int32)
            assert table.shape == (27, 32)
        self.table = table

    @classmethod
    def new_simple(cls, match_score: int, mismatch_score: int) -> "AAMatrix":
        t = np.full((27, 32), -128, dtype=np.int32)
        t[:26, :26] = mismatch_score
        np.fill_diagonal(t[:26, :26], match_score)
        return cls(t)

    @classmethod
    def from_tsv(cls, tsv: str, aa_order: str) -> "AAMatrix":
        """Parse a whitespace-separated square table with rows/cols in ``aa_order``."""
        order = [ord(c) for c in aa_order.split()]
        m = cls()
        for line, a in zip(tsv.strip().split("\n"), order):
            for tok, b in zip(line.split(), order):
                m.set(a, b, int(tok))
        return m

    def set(self, a, b, score: int) -> None:
        a = _char_upper(a)
        b = _char_upper(b)
        self.table[a - 65, b - 65] = score
        self.table[b - 65, a - 65] = score

    def get(self, a, b) -> int:
        a = _char_upper(a)
        b = _char_upper(b)
        return int(self.table[a - 65, b - 65])

    def convert(self, seq) -> np.ndarray:
        """Raw bytes -> storage codes ``c - 'A'`` in 0..26 (reference: src/scores.rs:130-134)."""
        b = np.frombuffer(_as_bytes(seq), dtype=np.uint8).copy()
        lower = (b >= 97) & (b <= 122)
        b[lower] -= 32
        if b.size and (b.min() < 65 or b.max() > self.NULL):
            raise ValueError("AAMatrix sequences must be in A..Z")
        return b - 65

    # --- engine plumbing ------------------------------------------------
    def row_index(self, codes: np.ndarray) -> np.ndarray:
        """Table row for a stored code (the code itself for AA)."""
        return codes

    def col_index(self, codes: np.ndarray) -> np.ndarray:
        return codes

    def dense(self) -> np.ndarray:
        return self.table


class NucMatrix:
    """Nucleotide matrix over A/C/G/T/N raw ASCII (reference: src/scores.rs:137-217)."""

    kind: ClassVar[str] = "nuc"
    NULL: ClassVar[int] = ord("Z")
    ROWS: ClassVar[int] = 8
    COLS: ClassVar[int] = 16

    def __init__(self, table: Optional[np.ndarray] = None):
        if table is None:
            table = np.full((8, 16), -128, dtype=np.int32)
        else:
            table = np.asarray(table, dtype=np.int32)
            assert table.shape == (8, 16)
        self.table = table

    @classmethod
    def new_simple(cls, match_score: int, mismatch_score: int) -> "NucMatrix":
        t = np.full((8, 16), -128, dtype=np.int32)
        alpha = [ord(c) for c in "ATCGN"]
        for i, a in enumerate(alpha):
            for j, b in enumerate(alpha):
                t[a & 0b111, b & 0b1111] = match_score if i == j else mismatch_score
        return cls(t)

    def set(self, a, b, score: int) -> None:
        a = _char_upper(a)
        b = _char_upper(b)
        self.table[a & 0b111, b & 0b1111] = score
        self.table[b & 0b111, a & 0b1111] = score

    def get(self, a, b) -> int:
        a = _char_upper(a)
        b = _char_upper(b)
        return int(self.table[a & 0b111, b & 0b1111])

    def convert(self, seq) -> np.ndarray:
        """Raw bytes -> uppercased ASCII, unchanged (reference: src/scores.rs:211-216)."""
        b = np.frombuffer(_as_bytes(seq), dtype=np.uint8).copy()
        lower = (b >= 97) & (b <= 122)
        b[lower] -= 32
        if b.size and (b.min() < 65 or b.max() > 90):
            raise ValueError("NucMatrix sequences must be in A..Z")
        return b

    def row_index(self, codes: np.ndarray) -> np.ndarray:
        return codes & 0b111

    def col_index(self, codes: np.ndarray) -> np.ndarray:
        return codes & 0b1111

    def dense(self) -> np.ndarray:
        return self.table


class ByteMatrix:
    """Arbitrary-byte match/mismatch matrix (reference: src/scores.rs:219-273).

    Engines score byte pairs with an equality compare instead of a table
    gather (``NULL`` is byte 0; x-drop with ByteMatrix is not supported, same
    as the reference).
    """

    kind: ClassVar[str] = "byte"
    NULL: ClassVar[int] = 0

    def __init__(self, match_score: int, mismatch_score: int):
        self.match_score = int(match_score)
        self.mismatch_score = int(mismatch_score)

    @classmethod
    def new_simple(cls, match_score: int, mismatch_score: int) -> "ByteMatrix":
        return cls(match_score, mismatch_score)

    def get(self, a, b) -> int:
        a = a if isinstance(a, int) else ord(a)
        b = b if isinstance(b, int) else ord(b)
        return self.match_score if a == b else self.mismatch_score

    def convert(self, seq) -> np.ndarray:
        return np.frombuffer(_as_bytes(seq), dtype=np.uint8).copy()

    def row_index(self, codes: np.ndarray) -> np.ndarray:
        return codes

    def col_index(self, codes: np.ndarray) -> np.ndarray:
        return codes

    def dense(self) -> Optional[np.ndarray]:
        return None


def _char_upper(c) -> int:
    c = c if isinstance(c, int) else ord(c)
    if 97 <= c <= 122:
        c -= 32
    return c


class AAProfile:
    """Position-specific scoring matrix with per-position gap open/close costs.

    Mirrors the reference ``AAProfile`` semantics (reference:
    src/scores.rs:341-715): the profile is one longer than its string so that
    column 0 (the DP boundary column) carries gap-open costs; position 0
    scores stay at the -128 padding value.

    Storage is a single ``(curr_len, 32) int32`` position-major table (the
    reference keeps a second transposed i16 copy purely as a CPU-SIMD load
    trick; here one layout serves both shift directions).
    """

    kind: ClassVar[str] = "profile"
    NULL: ClassVar[int] = ord("A") + 26

    def __init__(self, str_len: int, block_size: int, gap_extend: int):
        self.max_len = str_len + block_size + 1
        self.curr_len = self.max_len
        self.str_len = str_len
        self.gap_extend = int(gap_extend)
        self.pos_scores = np.full((self.max_len, 32), -128, dtype=np.int32)
        self.gap_open_C = np.full(self.max_len, -128, dtype=np.int32)
        self.gap_close_C = np.full(self.max_len, -128, dtype=np.int32)
        self.gap_open_R = np.full(self.max_len, -128, dtype=np.int32)

    # constructors -------------------------------------------------------
    @classmethod
    def from_bytes(
        cls,
        b,
        block_size: int,
        match_score: int,
        mismatch_score: int,
        gap_open_C: int,
        gap_close_C: int,
        gap_open_R: int,
        gap_extend: int,
    ) -> "AAProfile":
        b = _as_bytes(b)
        p = cls(len(b), block_size, gap_extend)
        for i, ch in enumerate(b):
            for c in range(ord("A"), ord("Z") + 1):
                p.set(i + 1, c, match_score if c == ch else mismatch_score)
        for i in range(len(b) + 1):
            p.set_gap_open_C(i, gap_open_C)
            p.set_gap_close_C(i, gap_close_C)
            p.set_gap_open_R(i, gap_open_R)
        return p

    def __len__(self) -> int:
        return self.str_len

    def len(self) -> int:
        return self.str_len

    def clear(self, str_len: int, block_size: int) -> None:
        curr_len = str_len + block_size + 1
        assert curr_len <= self.max_len
        self.pos_scores[:curr_len] = -128
        self.gap_open_C[:curr_len] = -128
        self.gap_close_C[:curr_len] = -128
        self.gap_open_R[:curr_len] = -128
        self.str_len = str_len
        self.curr_len = curr_len

    # setters ------------------------------------------------------------
    def set(self, i: int, b, score: int) -> None:
        b = _char_upper(b)
        assert 65 <= b <= 65 + 26
        self.pos_scores[i, b - 65] = score

    def set_all(self, order, scores, left_shift: int = 0, right_shift: int = 0) -> None:
        self._set_all_core(order, scores, left_shift, right_shift, rev=False)

    def set_all_rev(self, order, scores, left_shift: int = 0, right_shift: int = 0) -> None:
        self._set_all_core(order, scores, left_shift, right_shift, rev=True)

    def _set_all_core(self, order, scores, left_shift, right_shift, rev: bool) -> None:
        order_b = [_char_upper(c) - 65 for c in _as_bytes(order)]
        scores = np.asarray(scores, dtype=np.int64).reshape(self.str_len, len(order_b))
        # i8 shift-scaling semantics of the reference (src/scores.rs:698)
        scaled = ((scores.astype(np.int8) << left_shift) >> right_shift).astype(np.int32)
        rows = range(self.str_len, 0, -1) if rev else range(1, self.str_len + 1)
        for r, i in enumerate(rows):
            self.pos_scores[i, order_b] = scaled[r]

    def set_gap_open_C(self, i: int, gap: int) -> None:
        assert gap < 0, "Gap open cost must be negative!"
        self.gap_open_C[i] = gap

    def set_gap_close_C(self, i: int, gap: int) -> None:
        self.gap_close_C[i] = gap

    def set_gap_open_R(self, i: int, gap: int) -> None:
        assert gap < 0, "Gap open cost must be negative!"
        self.gap_open_R[i] = gap

    def set_all_gap_open_C(self, gap: int) -> None:
        assert gap < 0
        self.gap_open_C[: self.str_len + 1] = gap

    def set_all_gap_close_C(self, gap: int) -> None:
        self.gap_close_C[: self.str_len + 1] = gap

    def set_all_gap_open_R(self, gap: int) -> None:
        assert gap < 0
        self.gap_open_R[: self.str_len + 1] = gap

    # getters ------------------------------------------------------------
    def get(self, i: int, b) -> int:
        b = _char_upper(b)
        return int(self.pos_scores[i, b - 65])

    def get_gap_extend(self) -> int:
        return self.gap_extend

    def convert(self, seq) -> np.ndarray:
        b = np.frombuffer(_as_bytes(seq), dtype=np.uint8).copy()
        lower = (b >= 97) & (b <= 122)
        b[lower] -= 32
        return b - 65


def _load_static_matrices() -> dict:
    data = np.load(_DATA_DIR / "matrices.npz")
    return {name: AAMatrix(data[name].astype(np.int32)) for name in data.files}


_STATICS = _load_static_matrices()

BLOSUM45: AAMatrix = _STATICS["BLOSUM45"]
BLOSUM50: AAMatrix = _STATICS["BLOSUM50"]
BLOSUM62: AAMatrix = _STATICS["BLOSUM62"]
BLOSUM80: AAMatrix = _STATICS["BLOSUM80"]
BLOSUM90: AAMatrix = _STATICS["BLOSUM90"]
PAM100: AAMatrix = _STATICS["PAM100"]
PAM120: AAMatrix = _STATICS["PAM120"]
PAM160: AAMatrix = _STATICS["PAM160"]
PAM200: AAMatrix = _STATICS["PAM200"]
PAM250: AAMatrix = _STATICS["PAM250"]

#: Match = 1, mismatch = -1 (reference: src/scores.rs:277).
NW1: NucMatrix = NucMatrix.new_simple(1, -1)
#: Match = 1, mismatch = -1 over arbitrary bytes (reference: src/scores.rs:311).
BYTES1: ByteMatrix = ByteMatrix.new_simple(1, -1)


def percent_len(length: int, p: float) -> int:
    """Percentage of a length rounded to the next power of two, clamped to
    [32, 2^14] (reference: src/lib.rs:105-111)."""
    v = int(np.round(p * float(length)))
    v = max(v, 32)
    v = 1 << (v - 1).bit_length()
    return min(v, 1 << 14)
