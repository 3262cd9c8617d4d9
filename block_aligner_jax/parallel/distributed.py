"""Multi-host data parallelism scaffolding.

The framework scales beyond one host by pure batch data parallelism over
alignment pairs (SURVEY.md section 2.4): every host packs and feeds its own
slice of the global batch, each device aligns its shard independently, and
per-pair outputs stay host-local -- the network between hosts never sits on
the hot path, so alignments/s scales with hosts by construction.

Usage on N hosts (one process each)::

    from block_aligner_jax.parallel import distributed as dist

    dist.init("host0:1234", N, rank)   # jax.distributed.initialize(...)
    mesh = dist.global_mesh()          # all devices of all hosts, "data"
    args = pack_pairs(local_pairs, matrix, cfg)  # this host's slice
    gargs = dist.host_sharded(mesh, args)
    out = data_parallel_engine(cfg, mesh)(*gargs, go, ge, xd)
    local_scores = dist.local_shard(out[0])  # this host's pairs only

``scripts/multihost_dryrun.py`` exercises the full path as a
multi-process CPU run (2 processes x 4 virtual devices).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init", "global_mesh", "host_sharded", "local_shard"]


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (one call per host process).

    With no arguments, JAX looks for a cluster environment (e.g. SLURM);
    a plain multi-GPU host has none, so pass the coordinator address
    (``localhost:<port>`` on one host), process count and this process's
    id.  Safe to call once per process before any backend use.
    """
    kw = {}
    if coordinator_address is not None:
        kw = dict(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kw)


def global_mesh(axis: str = "data") -> Mesh:
    """A 1-D mesh over every device of every host."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_sharded(mesh: Mesh, tree, axis: str = "data",
                 replicated: Sequence[int] = ()):
    """Assemble global arrays from per-host locals.

    Each host passes ITS slice of the batch (leading dim = global / n_hosts
    for the sharded leaves); leaves at indices in ``replicated`` (scoring
    tables, gap params -- identical on every host) become fully replicated
    global arrays.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for idx, x in enumerate(leaves):
        x = np.asarray(x)
        if idx in replicated:
            sh = NamedSharding(mesh, P())
            out.append(jax.make_array_from_process_local_data(sh, x, x.shape))
        else:
            spec = P(axis, *([None] * (x.ndim - 1)))
            sh = NamedSharding(mesh, spec)
            gshape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
            out.append(jax.make_array_from_process_local_data(sh, x, gshape))
    return jax.tree_util.tree_unflatten(treedef, out)


def local_shard(x) -> np.ndarray:
    """This host's rows of a batch-sharded global output, concatenated in
    device order (the inverse of ``host_sharded`` for the local slice)."""
    shards = sorted(
        (s for s in x.addressable_shards), key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
