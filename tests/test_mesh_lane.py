"""Aligners sharded over a virtual 8-device mesh (CPU)."""

import numpy as np

from block_aligner_jax import BLOSUM62, BlockOracle, Gaps, PaddedBytes
from block_aligner_jax.api import BatchAligner
from block_aligner_jax.parallel.mesh import make_mesh

AA = b"ACDEFGHIKLMNPQRSTVWY"


def test_lane_kernel_on_mesh():
    """Fixed-block global batch sharded over the 8-device mesh."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(55)
    S = 16
    pairs = []
    for _ in range(24):
        n = int(rng.integers(10, 80))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytes(rng.choice(list(AA), size=int(rng.integers(10, 80))).tolist())
        pairs.append((q, r))
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, (S, S), batch=8 * 4, seq_cap=96,
                      mesh=mesh)
    assert al.route == "engine"
    got = al.align_batch(pairs)

    a = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (S, S), 0)
        assert got[k].score == a.res().score, k


def test_lane_kernel_trace_on_mesh():
    """Trace mode sharded over the mesh: the trace streams stay
    batch-sharded; CIGARs must match the oracle bit-for-bit."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(7)
    S = 16
    pairs = []
    for _ in range(16):
        n = int(rng.integers(10, 70))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 5):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(list(AA)))
        pairs.append((q, bytes(r)))
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, (S, S), batch=8 * 2, seq_cap=96,
                      trace=True, mesh=mesh)
    got = al.align_batch(pairs)
    a = BlockOracle(trace=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (S, S), 0)
        w = a.res()
        assert got[k].score == w.score, k
        assert str(al.cigar(k, w.query_idx, w.reference_idx)) == \
            str(a.cigar(w.query_idx, w.reference_idx)), k


def test_lane_kernel_xdrop_on_mesh():
    mesh = make_mesh(8)
    rng = np.random.default_rng(13)
    S = 16
    pairs = []
    for _ in range(12):
        n = int(rng.integers(20, 80))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 6):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(list(AA)))
        pairs.append((q, bytes(r)))
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, (S, S), batch=8 * 2, seq_cap=96,
                      x_drop=50, mesh=mesh)
    got = al.align_batch(pairs)
    a = BlockOracle(x_drop=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (S, S), 50)
        assert got[k] == a.res(), k


def test_adaptive_kernel_on_mesh():
    """Reference-exact adaptive sizing via BatchAligner(mesh=...)."""
    from block_aligner_jax.api import BatchAligner

    mesh = make_mesh(8)
    rng = np.random.default_rng(21)
    pairs = []
    for _ in range(20):
        n = int(rng.integers(20, 100))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 4):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(list(AA)))
        pairs.append((q, bytes(r)))
    gaps = Gaps(open=-11, extend=-1)
    al = BatchAligner(BLOSUM62, gaps, (16, 32), batch=8 * 4, seq_cap=160,
                      mesh=mesh)
    assert al.route == "engine"
    got = al.align_batch(pairs)
    a = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 32, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 32, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (16, 32), 0)
        assert got[k].score == a.res().score, k


def test_multihost_dryrun_subprocess():
    """N-host topology end to end: 2 processes x 4 virtual CPU devices,
    jax.distributed + per-host feeding (scripts/multihost_dryrun.py)."""
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "scripts" / \
        "multihost_dryrun.py"
    env = dict(__import__("os").environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=560, env=env)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "multihost dryrun: OK" in p.stdout


def test_adaptive_trace_on_mesh():
    """Adaptive trace (ckpt event stream) sharded over the mesh: CIGARs
    must stay bit-exact per shard."""
    from block_aligner_jax.api import BatchAligner

    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    gaps = Gaps(open=-11, extend=-1)
    pairs = []
    for _ in range(8):
        n = int(rng.integers(20, 60))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytearray(q)
        for _ in range(n // 4):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(list(AA)))
        pairs.append((q, bytes(r)))
    al = BatchAligner(BLOSUM62, gaps, (16, 32), batch=8 * 2, seq_cap=160,
                      trace=True, mesh=mesh)
    assert al.route == "engine" and al.cfg.trace
    got = al.align_batch(pairs)
    orc = BlockOracle(trace=True)
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 32, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, 32, BLOSUM62)
        orc.align(pq, pr, BLOSUM62, gaps, (16, 32), 0)
        w = orc.res()
        assert got[k].score == w.score, k
        assert str(al.cigar(k, w.query_idx, w.reference_idx)) == \
            str(orc.cigar(w.query_idx, w.reference_idx)), k


def test_adaptive_profile_on_mesh():
    """Profile-adaptive sizing sharded via ProfileAligner(mesh=...):
    adaptive PSSM configs mesh-shard like every other path (the per-pair
    gap-cost vectors shard with the batch)."""
    from block_aligner_jax import AAProfile, ProfileAligner

    mesh = make_mesh(8)
    rng = np.random.default_rng(67)

    def rand_profile(n):
        prof = AAProfile(n, 2048, -1)
        base = rng.integers(-4, 3, size=(n, 26))
        cons = bytes(rng.choice(list(AA), size=n).tolist())
        base[np.arange(n), np.frombuffer(cons, np.uint8) - 65] = (
            rng.integers(4, 12, size=n)
        )
        prof.pos_scores[1 : n + 1, :26] = base
        prof.gap_open_C[: n + 1] = rng.integers(-13, -8, size=n + 1)
        prof.gap_close_C[: n + 1] = 0
        prof.gap_open_R[: n + 1] = rng.integers(-13, -8, size=n + 1)
        return prof, cons

    pairs = []
    for _ in range(5):
        n = int(rng.integers(30, 80))
        prof, cons = rand_profile(n)
        q = bytearray(cons)
        for _ in range(n // 4):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(list(AA)))
        pairs.append((bytes(q), prof))
    for _ in range(3):  # inserted block: forces grow/restore on-mesh
        n = int(rng.integers(40, 80))
        prof, cons = rand_profile(n)
        q = bytes(cons)
        pos = int(rng.integers(0, max(len(q) - 12, 1)))
        q = q[:pos] + bytes(rng.choice(list(AA), size=14).tolist()) + q[pos:]
        pairs.append((q, prof))

    pa = ProfileAligner((16, 64), batch=8 * 2, seq_cap=200, mesh=mesh)
    assert pa.route == "engine"
    got = pa.align_batch(pairs)
    orc = BlockOracle()
    for k, (q, prof) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, 64, prof)
        orc.align_profile(pq, prof, (16, 64), 0)
        assert got[k].score == orc.res().score, (k, got[k], orc.res())
