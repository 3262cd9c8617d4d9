"""Host side of the CUDA fixed-block kernel (native/fixed_block.cu).

The kernel aligns each pair with one lane group (a warp; half a warp at
block 16) that keeps the block's DP column in registers.  This module packs
a batch pair-major -- every sequence's codes, DP-indexed and NULL-padded,
back to back in one byte buffer, with per-pair ``(q_off, r_off, qlen,
rlen)`` rows -- builds the 32x32 code table, calls the kernel through
``jax.ffi``, and decodes its ``(score, query_idx, reference_idx)`` rows.

The same walk, compiled by g++ with an emulated lane group
(``run_host``), is what the CPU tests check against the scalar oracle.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import List, Optional

import numpy as np

from ..core.oracle import AlignResult
from ..core.scores import ByteMatrix

__all__ = ["BLOCKS", "FixedBlockConfig", "code_table", "pack_fixed",
           "decode", "run_host", "build_fixed_block"]

#: block sizes the kernel is instantiated for
BLOCKS = (16, 32, 64, 128, 256, 512)
TABLE_SIDE = 32
FFI_TARGET = "ba_fixed_block"

_LOCK = threading.Lock()
_HOST_LIB: Optional[ctypes.CDLL] = None
_CUDA_REGISTERED = False


@dataclasses.dataclass(frozen=True)
class FixedBlockConfig:
    """One kernel specialisation: block size, mode, and scoring scalars."""

    block: int
    gap_open: int
    gap_extend: int
    x_drop: Optional[int] = None
    byte_match: int = 0
    byte_mismatch: int = 0
    byte_mode: bool = False

    def __post_init__(self):
        assert self.block in BLOCKS, f"fixed block must be one of {BLOCKS}"
        assert not (self.byte_mode and self.x_drop is not None)

    @classmethod
    def for_matrix(cls, matrix, gaps, block: int, x_drop: Optional[int]):
        if isinstance(matrix, ByteMatrix):
            return cls(block, gaps.open, gaps.extend, x_drop,
                       matrix.match_score, matrix.mismatch_score, True)
        return cls(block, gaps.open, gaps.extend, x_drop)

    def attrs(self) -> dict:
        i32 = np.int32
        return dict(
            block=i32(self.block), x_drop_mode=i32(self.x_drop is not None),
            gap_open=i32(self.gap_open), gap_extend=i32(self.gap_extend),
            x_drop=i32(self.x_drop or 0), byte_mode=i32(self.byte_mode),
            match=i32(self.byte_match), mismatch=i32(self.byte_mismatch),
        )


def code_table(matrix) -> np.ndarray:
    """(32, 32) int8 table over packed codes: ``T[a, b]`` scores column
    code ``a`` against lane code ``b``.  Codes are ``col_index`` of the
    converted characters; for both table matrices ``row_index`` factors
    through it (AA: identity, Nuc: ``c & 7`` of ``c & 15``)."""
    tab = np.full((TABLE_SIDE, TABLE_SIDE), -128, np.int8)
    dense = matrix.dense()
    if dense is None:  # ByteMatrix scores by equality in the kernel
        return tab
    rows = matrix.row_index(np.arange(TABLE_SIDE, dtype=np.uint8)).astype(np.int64)
    ok = rows < dense.shape[0]
    tab[ok, : dense.shape[1]] = dense[rows[ok]].astype(np.int8)
    return tab


def _as_bytes(s) -> bytes:
    return s.encode("ascii") if isinstance(s, str) else bytes(s)


def pack_fixed(pairs, matrix, block: int, batch: int, n_shards: int = 1):
    """Pack ``pairs`` (padded to ``batch`` with empty pairs) pair-major.

    Returns ``(codes, meta)``: ``codes`` (n_shards, L) uint8 holds each
    shard's sequences back to back, each as ``[NULL] + codes + NULL pad``
    (DP-indexed like ``PaddedBytes``, padded far enough for every read the
    walk makes); ``meta`` (batch, 4) int32 rows are ``(q_off, r_off, qlen,
    rlen)`` with offsets into the pair's shard row.  ``L`` is rounded up to
    a power of two so batches share compiled shapes."""
    assert len(pairs) <= batch and batch % n_shards == 0
    qs = [_as_bytes(q) for q, _ in pairs] + [b""] * (batch - len(pairs))
    rs = [_as_bytes(r) for _, r in pairs] + [b""] * (batch - len(pairs))
    lq = np.fromiter((len(x) for x in qs), np.int64, batch)
    lr = np.fromiter((len(x) for x in rs), np.int64, batch)

    def region(n):  # NULL + codes + pad; reads reach index max(n + 7, S - 1)
        return -(-(np.maximum(n + 8, block) + 1) // 16) * 16

    rq, rr = region(lq), region(lr)
    sizes = np.stack([rq, rr], 1).reshape(n_shards, -1)
    starts = np.cumsum(sizes, axis=1) - sizes
    width = max(int(sizes.sum(axis=1).max()), 4096)
    width = 1 << (width - 1).bit_length()
    # one bytes join of NULL-framed raw sequences, then one conversion pass
    null = bytes([matrix.NULL])
    per = batch // n_shards
    pieces = []
    for b in range(batch):
        pieces.append(null + qs[b] + null * int(rq[b] - 1 - lq[b]))
        pieces.append(null + rs[b] + null * int(rr[b] - 1 - lr[b]))
        if (b + 1) % per == 0:  # end of a shard's row
            pieces.append(null * (width - int(sizes[b // per].sum())))
    codes = matrix.col_index(matrix.convert(b"".join(pieces)))
    codes = codes.astype(np.uint8, copy=False).reshape(n_shards, width)
    meta = np.empty((batch, 4), np.int32)
    meta[:, 0] = starts.reshape(batch, 2)[:, 0]
    meta[:, 1] = starts.reshape(batch, 2)[:, 1]
    meta[:, 2] = lq
    meta[:, 3] = lr
    return codes, meta


def decode(out, n: int) -> List[AlignResult]:
    """First ``n`` rows of the kernel's (batch, 3) output."""
    out = np.asarray(out)
    return [AlignResult(int(s), int(i), int(j)) for s, i, j in out[:n].tolist()]


def _host_lib() -> ctypes.CDLL:
    global _HOST_LIB
    with _LOCK:
        if _HOST_LIB is None:
            from ..native import build_fixed_host

            lib = ctypes.CDLL(str(build_fixed_host()))
            p, i32 = ctypes.c_void_p, ctypes.c_int32
            lib.ba_fixed_block_host.restype = ctypes.c_int
            lib.ba_fixed_block_host.argtypes = [p, p, p, p] + [i32] * 9
            _HOST_LIB = lib
        return _HOST_LIB


def run_host(codes, meta, table, cfg: FixedBlockConfig) -> np.ndarray:
    """The kernel's walk compiled for the host (one pair after another, the
    lane group emulated); returns the same (batch, 3) rows.  Single shard."""
    assert codes.shape[0] == 1, "the host walk reads one shard"
    codes = np.ascontiguousarray(codes, np.uint8)
    meta = np.ascontiguousarray(meta, np.int32)
    table = np.ascontiguousarray(table, np.int8)
    out = np.zeros((meta.shape[0], 3), np.int32)
    a = cfg.attrs()
    rc = _host_lib().ba_fixed_block_host(
        codes.ctypes.data, meta.ctypes.data, table.ctypes.data,
        out.ctypes.data, meta.shape[0], a["block"], a["x_drop_mode"],
        a["gap_open"], a["gap_extend"], a["x_drop"], a["byte_mode"],
        a["match"], a["mismatch"])
    if rc != 0:
        raise ValueError(f"unsupported fixed block {cfg.block}")
    return out


def _register_cuda() -> None:
    """Build (first use) and register the kernel as an XLA FFI target.  A
    failed build or load raises: the GPU route has no fallback."""
    global _CUDA_REGISTERED
    with _LOCK:
        if _CUDA_REGISTERED:
            return
        import jax

        from ..native import build_fixed_cuda

        lib = ctypes.CDLL(str(build_fixed_cuda()))
        jax.ffi.register_ffi_target(
            FFI_TARGET, jax.ffi.pycapsule(lib.BaFixedBlock), platform="CUDA")
        _CUDA_REGISTERED = True


def build_fixed_block(cfg: FixedBlockConfig, mesh=None, axis: str = "data"):
    """Jitted ``fn(codes, meta, table) -> (batch, 3) int32`` running the
    CUDA kernel; with a mesh, each device runs it on its shard of pairs
    (``codes`` row and ``meta`` rows sharded on ``axis``, table
    replicated)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    _register_cuda()
    attrs = cfg.attrs()

    def call(codes, meta, table):
        out = jax.ShapeDtypeStruct((meta.shape[0], 3), jnp.int32)
        return jax.ffi.ffi_call(FFI_TARGET, out)(codes, meta, table, **attrs)

    if mesh is None:
        return jax.jit(call)
    return jax.jit(jax.shard_map(
        call, mesh=mesh, in_specs=(P(axis, None), P(axis, None), P()),
        out_specs=P(axis, None), check_vma=False))
