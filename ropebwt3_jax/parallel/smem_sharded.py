"""SMEM search over a sharded index — queries data-parallel over `dp`,
occ tables sharded over `idx`, rank reconstituted by psum per extend step."""

from __future__ import annotations

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.smem_fsm import smem_fsm
from .mesh import ShardedIndex, extend_sharded, extend_sharded_c

ASIZE = 6


def _set_intv_tables(acc, c):
    """rb3_fmd_set_intv with tiny-table lookups as one-hot arithmetic and the
    nt6 complement as arithmetic (cf. ops/rank.set_intv)."""
    c = c.astype(jnp.int32)
    oh = (jax.lax.broadcasted_iota(jnp.int32, c.shape + (ASIZE,), c.ndim) == c[..., None]).astype(acc.dtype)
    cc = jnp.where(c % 5 == 0, c, 5 - c)
    ohc = (jax.lax.broadcasted_iota(jnp.int32, c.shape + (ASIZE,), c.ndim) == cc[..., None]).astype(acc.dtype)
    acc_c = jnp.sum(acc[:ASIZE] * oh, axis=-1, dtype=acc.dtype)
    acc_c1 = jnp.sum(acc[1 : ASIZE + 1] * oh, axis=-1, dtype=acc.dtype)
    acc_comp = jnp.sum(acc[:ASIZE] * ohc, axis=-1, dtype=acc.dtype)
    return jnp.stack([acc_c, acc_comp, acc_c1 - acc_c], axis=-1)


def smem_sharded_fn(sidx: ShardedIndex, *, min_occ: int, min_len: int, max_mems: int, max_iters: int, packed: bool = False, unroll: int = 1, uniform: bool = False):
    """Build a jitted sharded SMEM step: (q (Q,L) u8 sharded over dp, qlen) ->
    (mems, n_mem, iters-per-dp-row).  With packed=True the step instead takes
    (q, seg_off, seg_len, n_seg) — the multi-read lane-packing layout of the
    single-chip kernel (ops/smem_fsm.py `segments`), all sharded over dp.
    With uniform=True (implies packed) it takes (q, stride, rlen, n_seg) —
    the uniform-stride variant (ops/smem_fsm.py `uniform_segments`, measured
    +25% single-chip): the per-iteration seg gather becomes arithmetic."""
    mesh = sidx.mesh
    nb_local = sidx.nb_local
    rb = sidx.rb  # (S, nb) when the occ rows are runblock-compressed
    if uniform:
        packed = True

    def inner(tables, acc, comp, q, qlen, *segs):
        mems, n_mem, it = smem_fsm(
            lambda ik, back: extend_sharded(tables, acc, nb_local, ik, back, rb=rb),
            lambda c: _set_intv_tables(acc, c),
            comp,
            q.astype(jnp.int32),
            qlen,
            acc.dtype,
            min_occ=min_occ,
            min_len=min_len,
            max_mems=max_mems,
            max_iters=max_iters,
            unroll=unroll,
            segments=segs if packed and not uniform else None,
            uniform_segments=segs if uniform else None,
            extend_one=lambda ik, c, back: extend_sharded_c(tables, acc, nb_local, ik, c, back, rb=rb),
        )
        return mems, n_mem, it[None]

    if uniform:
        seg_specs = (P("dp"), P("dp"), P("dp"))
    elif packed:
        seg_specs = (P("dp", None), P("dp", None), P("dp"))
    else:
        seg_specs = ()
    smapped = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(sidx.table_specs, P(), P(), P("dp", None), P("dp")) + seg_specs,
        out_specs=(P("dp", None, None), P("dp"), P("dp")),
        check_vma=False,
    )

    if packed:

        @jax.jit
        def step(q, a, b, n_seg):  # (seg_off, seg_len) or (stride, rlen)
            Q = q.shape[0]
            return smapped(sidx.tables, sidx.acc, sidx.comp, q, jnp.zeros(Q, jnp.int32), a, b, n_seg)

    else:

        @jax.jit
        def step(q, qlen):
            return smapped(sidx.tables, sidx.acc, sidx.comp, q, qlen)

    return step
