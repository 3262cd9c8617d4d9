"""Multi-device data parallelism for batched alignment.

The reference library is single-threaded (SURVEY.md section 2.4); this
framework scales by batch data parallelism over pairs: score profiles and
per-pair state shard over the ``data`` mesh axis, the scoring tables are
replicated, and per-pair outputs stay sharded until gathered.  On the
engine route the while-loop's global continue-predicate is the only
cross-device reduction (one scalar ``any`` per column); the CUDA
fixed-block route (ops/fixed_block.py) runs its kernel per shard under
``jax.shard_map`` with no communication at all.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "data_parallel_engine"]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """Place a pytree of batch-leading arrays with the batch dim sharded."""

    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def data_parallel_engine(cfg, mesh: Mesh, axis: str = "data"):
    """Build the engine wrapped for mesh execution: inputs sharded on batch,
    outputs sharded on batch.  The engine body is purely batch-elementwise,
    so XLA partitions it with zero per-iteration communication besides the
    scalar loop predicate."""
    from ..ops.engine import build_engine

    fn = build_engine(cfg)

    def run(Sprof, CRow, qlen, rlen, go, ge, xd, **kw):
        Sprof, CRow, qlen, rlen = shard_batch(mesh, (Sprof, CRow, qlen, rlen), axis)
        return fn(Sprof, CRow, qlen, rlen, go, ge, xd, **kw)

    return run

