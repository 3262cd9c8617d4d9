"""Multi-host (multi-process) dry run on CPU: 2 processes x 4 virtual
devices each, one global 8-device mesh, per-host batch feeding.

Validates the N-host topology end to end on one machine (SURVEY.md section
2.4; the aligners need no cross-host communication besides the engine's
scalar loop predicate):

* each process `jax.distributed.initialize`s into a shared coordinator,
* packs ITS OWN slice of the batch (per-host data loading),
* assembles global arrays with `make_array_from_process_local_data`,
* runs the batch-sharded engine over the global mesh, and
* oracle-checks its local output shard.

Run: python scripts/multihost_dryrun.py        (parent; spawns workers)
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_PROC = 2
DEV_PER_PROC = 4
PORT = 47713


def worker(pid: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={DEV_PER_PROC}"
    ).strip()
    sys.path.insert(0, str(ROOT))

    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")

    from block_aligner_jax import BLOSUM62, BlockOracle, Gaps, PaddedBytes
    from block_aligner_jax.ops.engine import EngineConfig, pack_pairs
    from block_aligner_jax.parallel import distributed as dist
    from block_aligner_jax.parallel.mesh import data_parallel_engine

    dist.init(f"localhost:{PORT}", N_PROC, pid)
    assert jax.process_count() == N_PROC
    ndev = N_PROC * DEV_PER_PROC
    assert len(jax.devices()) == ndev, (pid, len(jax.devices()))
    mesh = dist.global_mesh()

    # per-host data: each process packs its own (distinct) pairs
    rng = np.random.default_rng(100 + pid)
    AA = b"ACDEFGHIKLMNPQRSTVWY"
    gaps = Gaps(open=-11, extend=-1)
    S = 16
    pairs = []
    for _ in range(10):
        n = int(rng.integers(10, 60))
        q = bytes(rng.choice(list(AA), size=n).tolist())
        r = bytes(rng.choice(list(AA), size=int(rng.integers(10, 60))).tolist())
        pairs.append((q, r))

    # local cfg covers this host's slice; the global cfg drives the mesh
    local_b = DEV_PER_PROC * 4
    lcfg = EngineConfig(batch=local_b, min_size=S, max_size=S, seq_cap=128,
                        n_rows=BLOSUM62.ROWS)
    gcfg = EngineConfig(batch=N_PROC * local_b, min_size=S, max_size=S,
                        seq_cap=128, n_rows=BLOSUM62.ROWS)
    padded = pairs + [(b"", b"")] * (local_b - len(pairs))
    gargs = dist.host_sharded(mesh, tuple(pack_pairs(padded, BLOSUM62, lcfg)))
    out = data_parallel_engine(gcfg, mesh)(*gargs, gaps.open, gaps.extend, 0)
    scores = dist.local_shard(out[0])

    a = BlockOracle()
    for k, (q, r) in enumerate(pairs):
        pq = PaddedBytes.from_bytes(q, S, BLOSUM62)
        pr = PaddedBytes.from_bytes(r, S, BLOSUM62)
        a.align(pq, pr, BLOSUM62, gaps, (S, S), 0)
        assert int(scores[k]) == a.res().score, (pid, k, int(scores[k]),
                                                 a.res().score)
    print(f"process {pid}: {len(pairs)} local pairs oracle-exact over "
          f"{ndev}-device global mesh", flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]))
        return 0
    procs = []
    for pid in range(N_PROC):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid)],
            env=dict(os.environ),
        ))
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=600)
    print("multihost dryrun:", "OK" if rc == 0 else f"FAILED rc={rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
