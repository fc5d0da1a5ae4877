"""Multi-host launch helper.

The sharded index and query paths (mesh.py, smem_sharded.py) are written
against a `jax.sharding.Mesh` and work unchanged across hosts once
`jax.distributed` is initialized — reads stream data-parallel per host over
the `dp` axis, occ shards sit over `idx`, and the per-extend psum is the
only cross-chip traffic (BASELINE.json north star).  This module is the thin
entry point; on a single machine it is a no-op.
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). No-op if
    neither is provided."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    from .. import _jax_setup

    _jax_setup()
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_processes if num_processes is not None else os.environ.get("JAX_NUM_PROCESSES", 1)),
        process_id=int(process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID", 0)),
    )


def global_mesh(dp: int | None = None, idx: int = 1):
    """Build a (dp, idx) mesh over all global devices (all hosts)."""
    from .. import _jax_setup

    _jax_setup()
    import jax

    from .mesh import make_mesh

    n = len(jax.devices())
    if dp is None:
        dp = n // idx
    return make_mesh(dp, idx)


def to_host(x):
    """Materialize a (possibly multi-process) jax array as a full numpy array
    on EVERY process: plain np.asarray single-process; an allgather of the
    addressable shards under jax.distributed (np.asarray raises on
    non-addressable global arrays)."""
    import numpy as np

    import jax

    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def process_index() -> int:
    """jax.process_index() without forcing a jax import pre-init."""
    import sys

    if "jax" not in sys.modules:
        return 0
    import jax

    try:
        return jax.process_index()
    except Exception:
        return 0
