"""High-level batched alignment APIs.

``BatchAligner`` packs pairs, runs them on one route, and returns
``AlignResult``s (plus CIGARs in trace mode).  A device mesh shards the
batch over devices: data parallelism over pairs, the batched analogue of
the reference's serial harness loop (reference: examples/uc_bench.rs:89-104).

``pick_route`` is the one routing decision, made from the JAX backend:

* ``"cuda"`` -- the CUDA fixed-block kernel (native/fixed_block.cu, driven
  by ops/fixed_block.py), on the ``gpu`` backend only: min == max block
  size in ``ops.fixed_block.BLOCKS``, global or x-drop scores, AA / Nuc /
  Byte matrices;
* ``"engine"`` -- the batched lockstep state machine (ops/engine.py)
  compiled by XLA: every configuration -- adaptive grow/shrink/checkpoint,
  trace, local-start and free-gap flags, profiles -- on ``gpu`` and ``cpu``.

Any other backend raises.  A GPU run whose CUDA library fails to build or
load raises too; nothing falls back to another route or device.

``ProfileAligner`` is the sequence-to-PSSM counterpart (reference:
Block::align_profile, src/scan_block.rs:942-995).  ``LongBatchAligner`` and
``LongAdaptiveAligner`` serve long reads: they size the sequence capacity to
each batch, keeping whole sequences in device memory.  For single pairs and
CPU-exact work use ``BlockOracle``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .core.cigar import Cigar
from .core.oracle import AlignResult
from .core.scores import ByteMatrix, Gaps
from .core.traceback import EngineTrace
from .ops.engine import EngineConfig, build_engine, pack_pairs, pack_profiles

#: JAX backends with a route
BACKENDS = ("cpu", "gpu")

__all__ = ["BatchAligner", "ProfileAligner",
           "LongBatchAligner", "LongAdaptiveAligner",
           "align_exp_all", "align_profile_exp_all",
           "backend_of", "pick_route", "round_up", "BACKENDS"]


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def backend_of(mesh=None) -> str:
    """The backend the aligner runs on: the mesh's devices' platform, else
    JAX's default backend.  Raises for a backend with no route."""
    import jax

    plat = (mesh.devices.flat[0].platform if mesh is not None
            else jax.default_backend())
    if plat not in BACKENDS:
        raise RuntimeError(
            f"no alignment route for JAX backend {plat!r} "
            f"(supported: {', '.join(BACKENDS)})")
    return plat


def pick_route(min_size: int, max_size: int, *, backend: str,
               trace: bool = False, local_start: bool = False,
               free_query_start_gaps: bool = False,
               free_query_end_gaps: bool = False,
               profile: bool = False) -> str:
    """The routing decision: ``"cuda"`` or ``"engine"`` (module docstring).

    The CUDA kernel serves fixed blocks in global and x-drop score modes;
    trace, profile and the flag modes run on the engine (ROADMAP R1)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    from .ops.fixed_block import BLOCKS

    min_size = max(min_size, 16)
    max_size = max(max_size, min_size)
    flags = (trace or profile or local_start or free_query_start_gaps
             or free_query_end_gaps)
    if (backend == "gpu" and min_size == max_size and min_size in BLOCKS
            and not flags):
        return "cuda"
    return "engine"


class BatchAligner:
    """Batched block aligner over a fixed configuration.

    One instance owns one compiled specialization (batch size, block-size
    range, sequence capacity, and mode flags) and can be reused for many
    batches, like the reference's reusable ``Block`` allocation
    (reference: src/scan_block.rs:798-805).

    Mode flags mirror the reference const generics ``Block<TRACE, X_DROP,
    LOCAL_START, FREE_QUERY_START_GAPS, FREE_QUERY_END_GAPS>``
    (reference: src/scan_block.rs:89).  ``use_lane_kernel=False`` forces
    the engine route (the kernel-vs-XLA comparison); otherwise
    ``pick_route`` decides.
    """

    def __init__(
        self,
        matrix,
        gaps: Gaps,
        size: Tuple[int, int] = (32, 256),
        *,
        batch: int = 256,
        seq_cap: int = 1024,
        trace: bool = False,
        x_drop: Optional[int] = None,
        local_start: bool = False,
        free_query_start_gaps: bool = False,
        free_query_end_gaps: bool = False,
        mesh=None,
        data_axis: str = "data",
        use_lane_kernel: bool = True,
    ):
        assert gaps.open < 0 and gaps.extend < 0, "Gap costs must be negative!"
        assert gaps.open < gaps.extend, "Gap open must cost more than gap extend!"
        assert not (local_start and free_query_start_gaps)
        assert not (x_drop is not None and free_query_end_gaps)
        # reference surface: X-drop is not implemented for ByteMatrix
        # (core/scores.py; reference exposes no byte x-drop FFI/tests)
        assert not (isinstance(matrix, ByteMatrix) and x_drop is not None), (
            "x-drop with ByteMatrix is not supported (same as the reference)"
        )
        self.matrix = matrix
        self.gaps = gaps
        min_size, max_size = size
        min_size = max(min_size, 16)
        max_size = max(max_size, min_size)
        self.x_drop = x_drop
        self.min_size = min_size
        self.seq_cap = seq_cap
        self.free_query_end_gaps = free_query_end_gaps
        self.mesh = mesh
        self.data_axis = data_axis
        self._trace_mode = trace
        self._last_trace: Optional[EngineTrace] = None
        batch = round_up(batch, _mesh_size(mesh))
        backend = backend_of(mesh)
        self.route = "engine"
        if use_lane_kernel:
            self.route = pick_route(
                min_size, max_size, backend=backend, trace=trace,
                local_start=local_start,
                free_query_start_gaps=free_query_start_gaps,
                free_query_end_gaps=free_query_end_gaps)
        if self.route == "cuda":
            from .ops.fixed_block import (FixedBlockConfig, build_fixed_block,
                                          code_table)

            self.cfg = None
            self._batch = batch
            self._kcfg = FixedBlockConfig.for_matrix(matrix, gaps, min_size,
                                                     x_drop)
            self._table = code_table(matrix)
            self._fn = build_fixed_block(self._kcfg, mesh, data_axis)
            return
        self.cfg = EngineConfig(
            batch=batch,
            min_size=min_size,
            max_size=max_size,
            seq_cap=round_up(1 + seq_cap + max_size + 16, 128),
            n_rows=getattr(matrix, "ROWS", 1),
            is_byte=isinstance(matrix, ByteMatrix),
            trace=trace,
            x_drop=x_drop is not None,
            local_start=local_start,
            free_query_start_gaps=free_query_start_gaps,
            free_query_end_gaps=free_query_end_gaps,
        )
        # on a mesh, ``stage`` shards the inputs and XLA partitions the
        # engine over the batch
        self._fn = build_engine(self.cfg)

    @property
    def batch_size(self) -> int:
        return self._batch if self.cfg is None else self.cfg.batch

    @property
    def seq_capacity(self) -> int:
        if self.cfg is None:
            return self.seq_cap
        return self.cfg.seq_cap - self.cfg.max_size - 17

    def _check(self, pairs) -> None:
        assert len(pairs) <= self.batch_size
        for q, r in pairs:
            assert max(len(q), len(r)) <= self.seq_capacity, (
                "sequence too long for this BatchAligner's seq_cap"
            )
            if self.free_query_end_gaps:
                # reference: FREE_QUERY_END_GAPS requires min block size >
                # query length (src/scan_block.rs align asserts)
                assert len(q) < self.min_size, (
                    "free_query_end_gaps requires min block size > query len"
                )

    def align_batch(self, pairs: Sequence[Tuple[bytes, bytes]]) -> List[AlignResult]:
        """Align up to ``batch_size`` pairs; shorter lists pad internally."""
        return self.align_staged(self.stage(pairs))

    # --- staged execution: pack/transfer once, run many ------------------
    def stage(self, pairs):
        """Pack a batch and place it on device (the analogue of the
        reference benchmarks' up-front ``PaddedBytes`` preparation,
        reference: examples/uc_bench.rs:84-101).  Use with ``align_staged``
        to measure or re-run device work without host packing/transfer."""
        import jax

        self._check(pairs)
        if self.cfg is None:
            from .ops.fixed_block import pack_fixed

            codes, meta = pack_fixed(pairs, self.matrix, self._kcfg.block,
                                     self._batch, _mesh_size(self.mesh))
            return (len(pairs), _put_sharded(self.mesh, self.data_axis,
                                             (codes, meta)))
        padded = list(pairs) + [(b"", b"")] * (self.cfg.batch - len(pairs))
        args = pack_pairs(padded, self.matrix, self.cfg)
        return (len(pairs), _put_sharded(self.mesh, self.data_axis, args))

    def align_staged(self, staged) -> List[AlignResult]:
        """Run a batch previously prepared with ``stage``."""
        return self._decode_staged(staged, self._dispatch_staged(staged))

    def _dispatch_staged(self, staged):
        """Enqueue the device work for a staged batch WITHOUT fetching the
        results (JAX dispatch is async) -- pair with ``_decode_staged``, so
        ``align_all`` overlaps the next batch's host pack with this one's
        device compute."""
        args = staged[1]
        if self.cfg is None:
            return self._fn(*args, self._table)
        kw = {}
        if self.cfg.is_byte:
            kw = dict(byte_match=self.matrix.match_score,
                      byte_mismatch=self.matrix.mismatch_score)
        return self._fn(*args, self.gaps.open, self.gaps.extend,
                        self.x_drop or 0, **kw)

    def _decode_staged(self, staged, out) -> List[AlignResult]:
        """Fetch + decode a batch dispatched by ``_dispatch_staged`` (trace
        mode keeps the batch's trace for ``cigar``)."""
        n = staged[0]
        if self.cfg is None:
            from .ops.fixed_block import decode

            return decode(out, n)
        return _engine_results(self, out, n)

    def align_all(self, pairs: Sequence[Tuple[bytes, bytes]],
                  sort: bool = True) -> List[AlignResult]:
        """Align any number of pairs in batches (trace mode keeps only the
        last batch's trace; use ``align_all_trace`` for CIGARs).

        ``sort=True`` (the default outside trace mode) aligns in
        length-sorted order and unsorts the results, so each batch (and on
        the GPU each thread block) holds pairs of similar length."""
        sort = sort and not self._trace_mode and len(pairs) > 1
        order = None
        work = pairs
        if sort:
            order = sorted(range(len(pairs)),
                           key=lambda k: len(pairs[k][0]) + len(pairs[k][1]))
            work = [pairs[k] for k in order]
        got: List[AlignResult] = []
        for _, res in self._pipeline(work):
            got.extend(res)
        return _unsort(got, order)

    def _pipeline(self, work):
        """Yield ``(chunk, results)`` per batch: batch k+1 is packed and
        dispatched before batch k is fetched and decoded."""
        pending = None
        for k in range(0, len(work), self.batch_size):
            chunk = work[k : k + self.batch_size]
            staged = self.stage(chunk)
            disp = self._dispatch_staged(staged)
            if pending is not None:
                yield pending[0], self._decode_staged(*pending[1:])
            pending = (chunk, staged, disp)
        if pending is not None:
            yield pending[0], self._decode_staged(*pending[1:])

    def align_all_trace(self, pairs: Sequence[Tuple[bytes, bytes]],
                        eq: bool = False, nthreads: int = 8):
        """Traced batch pipeline: returns ``(results, cigars)`` for any
        number of pairs.  While batch k+1 computes on the device, batch k's
        CIGARs are walked on the host (native walker; =/X resolution when
        ``eq``), the analogue of the reference harness's align-then-cigar
        loop (reference: examples/uc_bench.rs:89-104) at batch
        granularity."""
        assert self._trace_mode, "align_all_trace requires trace=True"
        results: List[AlignResult] = []
        cigars: List[Cigar] = []
        for chunk, got in self._pipeline(pairs):
            results.extend(got)
            eps = [(g.query_idx, g.reference_idx) for g in got]
            cigars.extend(self._last_trace.cigars_all(
                eps, nthreads=nthreads, eq=eq,
                seqs=list(chunk) if eq else None))
        return results, cigars

    # --- trace accessors (reference: Block::trace, src/scan_block.rs:1241) --
    def trace(self) -> EngineTrace:
        assert self._trace_mode and self._last_trace is not None
        return self._last_trace

    def cigar(self, k: int, i: int, j: int, cigar: Optional[Cigar] = None) -> Cigar:
        """CIGAR for pair ``k`` of the last batch, from end position (i, j)."""
        return self.trace().cigar(k, i, j, cigar)

    def cigar_eq(self, k: int, q, r, i: int, j: int,
                 cigar: Optional[Cigar] = None) -> Cigar:
        from .core.seqs import PaddedBytes

        blk = self.cfg.max_size
        pq = q if isinstance(q, PaddedBytes) else PaddedBytes.from_bytes(q, blk, self.matrix)
        pr = r if isinstance(r, PaddedBytes) else PaddedBytes.from_bytes(r, blk, self.matrix)
        return self.trace().cigar_eq(k, pq, pr, i, j, cigar)


def _put_sharded(mesh, axis: str, args):
    """Place batch-leading host arrays on the device(s): sharded on ``axis``
    over a mesh."""
    import jax

    if mesh is None:
        return jax.device_put(args)
    from .parallel.mesh import shard_batch

    return shard_batch(mesh, args, axis)


def _engine_results(al, out, n: int) -> List[AlignResult]:
    """Decode an engine launch; in trace mode keep its trace on ``al``."""
    if al.cfg.trace:
        score, qi, rj, iters, tr, meta = out
        al._last_trace = EngineTrace(
            np.asarray(tr), np.asarray(meta), int(iters),
            local_start=al.cfg.local_start,
            free_query_start_gaps=al.cfg.free_query_start_gaps,
        )
    else:
        score, qi, rj, _ = out
    score, qi, rj = np.asarray(score), np.asarray(qi), np.asarray(rj)
    return [AlignResult(int(score[k]), int(qi[k]), int(rj[k]))
            for k in range(n)]


def _unsort(got, order):
    if order is None:
        return got
    out: List[Optional[AlignResult]] = [None] * len(got)
    for pos, k in enumerate(order):
        out[k] = got[pos]
    return out


class ProfileAligner:
    """Batched sequence-to-PSSM aligner (reference: align_profile,
    src/scan_block.rs:942-995).  Pairs are ``(query_bytes, AAProfile)``;
    every mode runs on the engine route."""

    def __init__(
        self,
        size: Tuple[int, int] = (32, 256),
        *,
        batch: int = 64,
        seq_cap: int = 1024,
        trace: bool = False,
        x_drop: Optional[int] = None,
        local_start: bool = False,
        free_query_start_gaps: bool = False,
        free_query_end_gaps: bool = False,
        mesh=None,
        data_axis: str = "data",
    ):
        # same flag-exclusion surface as the reference
        # (src/scan_block.rs:952-954, shared by align_profile)
        assert not (local_start and free_query_start_gaps)
        assert not (x_drop is not None and free_query_end_gaps)
        min_size, max_size = size
        min_size = max(min_size, 16)
        max_size = max(max_size, min_size)
        self.x_drop = x_drop
        self.min_size = min_size
        self.free_query_end_gaps = free_query_end_gaps
        self.mesh = mesh
        self.data_axis = data_axis
        self._trace_mode = trace
        self._last_trace: Optional[EngineTrace] = None
        self.route = pick_route(min_size, max_size, backend=backend_of(mesh),
                                profile=True)
        self.cfg = EngineConfig(
            batch=round_up(batch, _mesh_size(mesh)),
            min_size=min_size,
            max_size=max_size,
            seq_cap=round_up(1 + seq_cap + max_size + 16, 128),
            n_rows=27,
            profile=True,
            trace=trace,
            x_drop=x_drop is not None,
            local_start=local_start,
            free_query_start_gaps=free_query_start_gaps,
            free_query_end_gaps=free_query_end_gaps,
        )
        self._fn = build_engine(self.cfg)

    @property
    def batch_size(self) -> int:
        return self.cfg.batch

    def stage(self, pairs):
        """Pack a (query, profile) batch and place it on device; run with
        ``align_staged``."""
        assert len(pairs) <= self.cfg.batch
        if self.free_query_end_gaps:
            for q, _ in pairs:
                # reference: min block size > query length
                # (src/scan_block.rs:954)
                assert len(q) < self.min_size, (
                    "free_query_end_gaps requires min block size > query len"
                )
        padded = list(pairs) + [(b"", None)] * (self.cfg.batch - len(pairs))
        Sprof, CRow, qlen, rlen, GOC, GCC, GOR, ge = pack_profiles(padded, self.cfg)
        args = _put_sharded(self.mesh, self.data_axis,
                            (Sprof, CRow, qlen, rlen, GOC, GCC, GOR))
        return (len(pairs), args, ge)

    def align_staged(self, staged) -> List[AlignResult]:
        n, (Sprof, CRow, qlen, rlen, GOC, GCC, GOR), ge = staged
        out = self._fn(Sprof, CRow, qlen, rlen, 0, ge, self.x_drop or 0,
                       GOC=GOC, GCC=GCC, GOR=GOR)
        return _engine_results(self, out, n)

    def align_batch(self, pairs) -> List[AlignResult]:
        return self.align_staged(self.stage(pairs))

    def align_all(self, pairs, sort: bool = True) -> List[AlignResult]:
        """Align any number of (query, profile) pairs in batches (outside
        trace mode, length-sorted like BatchAligner.align_all)."""
        sort = sort and not self._trace_mode and len(pairs) > 1
        order = None
        work = pairs
        if sort:
            order = sorted(
                range(len(pairs)),
                key=lambda k: len(pairs[k][0]) + (
                    pairs[k][1].str_len if pairs[k][1] else 0),
            )
            work = [pairs[k] for k in order]
        got: List[AlignResult] = []
        for k in range(0, len(work), self.batch_size):
            got.extend(self.align_batch(work[k : k + self.batch_size]))
        return _unsort(got, order)

    def trace(self) -> EngineTrace:
        assert self._trace_mode and self._last_trace is not None
        return self._last_trace

    def cigar(self, k: int, i: int, j: int, cigar: Optional[Cigar] = None) -> Cigar:
        return self.trace().cigar(k, i, j, cigar)


def align_exp_all(
    matrix,
    gaps: Gaps,
    pairs,
    target_scores,
    size: Tuple[int, int] = (32, 256),
    *,
    x_drop: Optional[int] = None,
    batch: int = 256,
    seq_cap: int = 1024,
):
    """Batched exponential search on the min block size (reference:
    Block::align_exp, src/scan_block.rs:884-902).

    For each pair, retries with doubled ``min_size`` until the score reaches
    its target (or ``min_size`` exceeds ``max_size``).  Returns
    ``(results, min_sizes)`` where ``min_sizes[k]`` is the successful min
    block size or ``None``.

    Under-target pairs are re-batched together per retry level, so the
    device work per level shrinks with the number of stragglers.
    """
    min_size, max_size = size
    results: List[Optional[AlignResult]] = [None] * len(pairs)
    min_sizes: List[Optional[int]] = [None] * len(pairs)
    pending = list(range(len(pairs)))
    cur = max(min_size, 16)
    aligners = {}
    while pending and cur <= max_size:
        if cur not in aligners:
            aligners[cur] = BatchAligner(
                matrix, gaps, (cur, max_size), batch=batch, seq_cap=seq_cap,
                x_drop=x_drop,
            )
        al = aligners[cur]
        sub = [pairs[k] for k in pending]
        res = al.align_all(sub)
        still = []
        for k, got in zip(pending, res):
            results[k] = got
            if got.score >= target_scores[k]:
                min_sizes[k] = cur
            else:
                still.append(k)
        pending = still
        cur *= 2
    return results, min_sizes


def align_profile_exp_all(
    pairs,
    target_scores,
    size: Tuple[int, int] = (32, 256),
    *,
    x_drop: Optional[int] = None,
    batch: int = 256,
    seq_cap: int = 1024,
):
    """Batched exponential search on the min block size for (query, PSSM)
    pairs (reference: Block::align_profile_exp, src/scan_block.rs:907-925);
    same retry structure as ``align_exp_all``."""
    min_size, max_size = size
    results: List[Optional[AlignResult]] = [None] * len(pairs)
    min_sizes: List[Optional[int]] = [None] * len(pairs)
    pending = list(range(len(pairs)))
    cur = max(min_size, 16)
    aligners = {}
    while pending and cur <= max_size:
        if cur not in aligners:
            # the reference retries with the (doubled-min, max) range
            aligners[cur] = ProfileAligner(
                (cur, max_size), batch=batch, seq_cap=seq_cap, x_drop=x_drop,
            )
        al = aligners[cur]
        sub = [pairs[k] for k in pending]
        res = al.align_all(sub)
        still = []
        for k, got in zip(pending, res):
            results[k] = got
            if got.score >= target_scores[k]:
                min_sizes[k] = cur
            else:
                still.append(k)
        pending = still
        cur *= 2
    return results, min_sizes


class LongAdaptiveAligner:
    """Alignment of long sequences (the reference's nanopore bands, up to
    (512, 16384) blocks over <50 kbp reads, examples/nanopore_accuracy.rs:
    37-54, nanopore_bench_global.rs:144-227).

    Whole sequences stay in device memory.  The sequence capacity follows
    each batch's longest sequence, rounded up to a power of two, so one
    compiled aligner serves every batch in that bucket.  Every mode of
    ``BatchAligner`` composes; ``profile=True`` takes ``(query, AAProfile)``
    pairs.
    """

    def __init__(
        self,
        matrix,
        gaps: Gaps,
        size=(512, 4096),
        *,
        batch: int = 128,
        seq_cap: int = 65536,
        trace: bool = False,
        x_drop: Optional[int] = None,
        local_start: bool = False,
        free_query_start_gaps: bool = False,
        free_query_end_gaps: bool = False,
        profile: bool = False,
        mesh=None,
        data_axis: str = "data",
    ):
        self.matrix = matrix
        self.gaps = gaps
        self.size = size
        self.seq_cap = seq_cap
        self._profile = profile
        self._trace_mode = trace
        self._kw = dict(batch=batch, trace=trace, x_drop=x_drop,
                        local_start=local_start,
                        free_query_start_gaps=free_query_start_gaps,
                        free_query_end_gaps=free_query_end_gaps,
                        mesh=mesh, data_axis=data_axis)
        self._aligners = {}
        self._last = None

    @property
    def batch_size(self) -> int:
        return round_up(self._kw["batch"], _mesh_size(self._kw["mesh"]))

    def _aligner(self, cap: int):
        if cap not in self._aligners:
            if self._profile:
                self._aligners[cap] = ProfileAligner(self.size, seq_cap=cap,
                                                     **self._kw)
            else:
                self._aligners[cap] = BatchAligner(
                    self.matrix, self.gaps, self.size, seq_cap=cap, **self._kw)
        return self._aligners[cap]

    def align_batch(self, pairs) -> List[AlignResult]:
        def plen(p):
            return len(p) if not self._profile else (p.str_len if p else 0)

        longest = max([max(len(q), plen(r)) for q, r in pairs] + [1])
        assert longest <= self.seq_cap, (
            "sequence too long for this aligner's seq_cap")
        al = self._aligner(max(1024, 1 << (longest - 1).bit_length()))
        got = al.align_batch(pairs)
        self._last = al
        return got

    # --- trace accessors (reference: Block::trace, src/scan_block.rs:1241) --
    def trace(self) -> EngineTrace:
        assert self._trace_mode and self._last is not None
        return self._last.trace()

    def cigar(self, k: int, i: int, j: int,
              cigar: Optional[Cigar] = None) -> Cigar:
        """CIGAR for pair ``k`` of the last batch, from end position (i, j)."""
        return self.trace().cigar(k, i, j, cigar)

    def cigar_eq(self, k: int, q, r, i: int, j: int,
                 cigar: Optional[Cigar] = None) -> Cigar:
        return self._last.cigar_eq(k, q, r, i, j, cigar)


class LongBatchAligner(LongAdaptiveAligner):
    """Fixed-block alignment of long sequences (the reference's 1% bands:
    block 256 for 25 kbp reads, 512 for 50 kbp).  On the GPU the global and
    x-drop modes run the CUDA kernel, which has no capacity limit."""

    def __init__(self, matrix, gaps: Gaps, block: int = 128, *,
                 batch: int = 256, seq_cap: int = 1 << 20, **kw):
        super().__init__(matrix, gaps, (block, block), batch=batch,
                         seq_cap=seq_cap, **kw)
