"""Sharded BWT merge-rank: LF lanes over `dp`, rank psum over `idx`.

The merge rank phase (Algorithm 2 phase 1, fm-index.c:139-200) walks one
LF-loop per B2 sequence; each step needs one rank1a against B1.  On a
(dp, idx) mesh the m2 lanes split across `dp` while B1's occ rows live
sharded across `idx` — the same layout the sharded SMEM path uses, so a
merge can run against an index bigger than one chip's HBM.  The (kb, ka)
trajectory windows come back to the host for the fancy-assignment into
`ins` (cf. construct/merge.py)."""

from __future__ import annotations

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import ShardedIndex, rank1a_local


def merge_rank_sharded_fn(sidx: ShardedIndex, W: int):
    """Jitted (ka, kb, alive) -> (ka, kb, alive, kbuf, abuf) window step."""
    mesh = sidx.mesh
    nb_local = sidx.nb_local
    dt = sidx.acc.dtype

    def inner(tables, acc, seq_d, lf2_d, ka, kb, alive):
        m2l = ka.shape[0]

        def step(t, st):
            ka, kb, alive, kbuf, abuf = st
            kbuf = jax.lax.dynamic_update_index_in_dim(kbuf, kb, t, 0)
            abuf = jax.lax.dynamic_update_index_in_dim(abuf, ka, t, 0)
            c = jnp.take(seq_d, kb)
            oa = rank1a_local(tables, nb_local, ka, dt)
            oa = jax.lax.psum(oa, "idx")
            sel = (jax.lax.broadcasted_iota(jnp.int32, (m2l, 6), 1) == c[:, None]).astype(dt)
            oc = jnp.sum(oa * sel, axis=1, dtype=dt)
            alive2 = alive & (c != 0)
            ka = jnp.where(alive2, jnp.take(acc, c) + oc, ka)
            kb = jnp.where(alive2, jnp.take(lf2_d, kb), kb)
            return ka, kb, alive2, kbuf, abuf

        # fresh zeros are unvarying over the mesh; mark them dp-varying so the
        # loop carry types match (shard_map VMA tracking)
        kbuf = jax.lax.pcast(jnp.zeros((W, m2l), kb.dtype), ("dp",), to="varying")
        abuf = jax.lax.pcast(jnp.zeros((W, m2l), dt), ("dp",), to="varying")
        return jax.lax.fori_loop(0, W, step, (ka, kb, alive, kbuf, abuf))

    smapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(sidx.table_specs, P(), P(), P(), P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp"), P(None, "dp"), P(None, "dp")),
    )

    @jax.jit
    def stepw(ka, kb, alive, seq_d, lf2_d):
        return smapped(sidx.tables, sidx.acc, seq_d, lf2_d, ka, kb, alive)

    return stepw


def merge_rank_sharded(fa, seq: np.ndarray, mesh, window: int | None = None):
    """Sharded twin of construct.merge.merge_rank_device; bit-identical ins.

    fa: DenseFMIndex (tables are sharded from it) or a prebuilt ShardedIndex.
    Returns (acc2, ins)."""
    from ..construct.merge import lf2_table

    sidx = fa if isinstance(fa, ShardedIndex) else ShardedIndex.from_dense(fa, mesh)
    mesh = sidx.mesh
    dp = mesh.shape["dp"]
    acc2, lf2 = lf2_table(seq)
    n2 = len(seq)
    m2 = int(acc2[1])
    dt = sidx.acc.dtype
    m2p = (m2 + dp - 1) // dp * dp  # pad lanes to the dp axis
    kdt = np.int32 if dt == jnp.int32 else np.int64
    W = int(window) if window else int(max(64, min(16384, (8 << 20) // max(1, m2p))))
    stepw = merge_rank_sharded_fn(sidx, W)

    shard1 = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())
    ka = jax.device_put(np.full(m2p, int(np.asarray(sidx.acc)[1]), kdt), shard1)
    kb0 = np.zeros(m2p, kdt)
    kb0[:m2] = np.arange(m2, dtype=kdt)
    kb = jax.device_put(kb0, shard1)
    alive0 = np.zeros(m2p, bool)
    alive0[:m2] = True
    alive = jax.device_put(alive0, shard1)
    seq_d = jax.device_put(seq.astype(np.int32), repl)
    lf2_d = jax.device_put(lf2.astype(kdt), repl)
    ins = np.zeros(n2, dtype=np.int64)
    while True:
        ka, kb, alive, kbuf, abuf = stepw(ka, kb, alive, seq_d, lf2_d)
        from .launch import to_host

        kb_h = to_host(kbuf)[:, :m2].ravel()
        ins[kb_h] = to_host(abuf)[:, :m2].ravel()
        if not bool(to_host(jnp.any(alive))):
            break
    return acc2, ins
