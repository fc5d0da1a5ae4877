"""Multi-chip sharding of the FM-index and query batches.

Sharding story (SURVEY.md §2.6): the analog of tensor parallelism is
*occ-table sharding* — the BWT position axis is split across the `idx` mesh
axis so indexes larger than one device's memory fit across several; queries are data-parallel
across the `dp` axis.  A rank request at position k touches only the shard
owning k: every device computes a masked local rank and a `psum` over `idx`
reconstitutes the full occ row (one small all-reduce per extend step over
the device interconnect).  Small indexes replicate instead (idx=1) and the
psum is free.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.dense import BLOCK, BLOCKS_PER_SUPER, DenseFMIndex

ASIZE = 6
_EXT_ORDER = (0, 4, 3, 2, 1, 5)


@dataclass
class ShardedIndex:
    """FM-index occ tables laid out for a (dp, idx) mesh.

    Dense mode: int32 indexes use the fused (nb_pad, 12) int32 `occf` row
    table (bit-plane columns 0:6, absolute counts 6:12 — cf.
    ops/rank.DeviceIndex): the local rank partial is ONE row gather per
    shard.  int64 indexes keep the three-table layout (occ_bits + uint16
    occ_block under replicated occ_super).

    Runblock mode (occ="rb", rb_S set): the run-aware compressed rows
    (ops/runblock.py, 160 B per S symbols + escape planes, ~0.02-0.34 B/sym)
    shard over `idx` with per-shard escape slabs — the beyond-HBM capacity
    format and the tensor-parallel story in one: the reference's whole-Tsym
    answer is its compressed rld0 blocks (rld0.c:107-204); ours is the same
    compression sharded over the mesh, so capacity scales with BOTH the
    compression ratio and the idx axis."""

    mesh: Mesh
    occ_bits: jax.Array | None  # (nb_pad, 6) uint32, sharded (legacy int64)
    occ_block: jax.Array | None  # (nb_pad, 6) uint16, sharded (legacy int64)
    occ_super: jax.Array | None  # legacy: (ns, 6) idx replicated; fused
    # int64: tiny (n_mega, 6) int64 megablock bases, replicated
    acc: jax.Array  # (7,) replicated
    comp: jax.Array  # (6,) replicated
    n: int
    nb_local: int  # blocks per idx shard
    occf: jax.Array | None = None  # (nb_pad, 12) int32, sharded (fused modes)
    rb_rows: jax.Array | None = None  # (nb_pad, 40) int32, sharded (rb mode)
    rb_esc: jax.Array | None = None  # (n_idx*esc_pad, 3S/32) int32, sharded
    rb_S: int | None = None  # rb block size (static); None = dense mode
    rb_nb: int = 0  # unpadded rb block count (static; ownership clamp)

    @classmethod
    def from_dense(cls, f: DenseFMIndex, mesh: Mesh, idx_dtype=None, occ: str = "dense", rb_S: int | None = None) -> "ShardedIndex":
        from ..ops import rank as rank_mod

        n_idx = mesh.shape["idx"]
        shard = NamedSharding(mesh, P("idx", None))
        repl = NamedSharding(mesh, P())
        comp = jax.device_put(np.array([0, 4, 3, 2, 1, 5], dtype=np.int32), repl)
        if occ == "rb":
            from ..ops import runblock

            d = runblock.from_dense_np(f, S=rb_S, idx_dtype=idx_dtype)
            lay = runblock.shard_layout_np(d, n_idx)
            acc = jax.device_put(np.asarray(d["acc"]), repl)
            mega = d["mega"] if d["mega"] is not None else np.zeros((1, ASIZE), np.int32)
            return cls(
                mesh=mesh, occ_bits=None, occ_block=None,
                occ_super=jax.device_put(mega, repl),
                acc=acc, comp=comp, n=f.n, nb_local=lay["nb_local"],
                rb_rows=jax.device_put(lay["rows"], shard),
                rb_esc=jax.device_put(lay["esc"], shard),
                rb_S=int(d["S"]), rb_nb=len(d["rows"]),
            )
        if idx_dtype is None:
            idx_dtype = jnp.int32 if f.n < (1 << 31) - (1 << 20) else jnp.int64
        nb = len(f.occ_block)
        nb_pad = (nb + n_idx - 1) // n_idx * n_idx
        acc = jax.device_put(f.acc.astype(idx_dtype), repl)
        # one fused (nb, 12) row table for both dtypes (ops/rank.py layout:
        # absolute int32 counts, or uint32 megablock-relative for int64 with
        # the tiny base table riding in occ_super)
        occf_np, mega = rank_mod.build_occf(f, int64=idx_dtype == jnp.int64)
        occf = np.zeros((nb_pad, 12), dtype=np.int32)
        occf[:nb] = occf_np
        return cls(
            mesh=mesh, occ_bits=None, occ_block=None,
            occ_super=jax.device_put(mega, repl) if mega is not None else None,
            acc=acc, comp=comp, n=f.n, nb_local=nb_pad // n_idx,
            occf=jax.device_put(occf, shard),
        )

    @property
    def rb(self) -> tuple[int, int] | None:
        """(S, nb) static rb parameters, or None in dense mode (threaded into
        rank1a_local so the shard-local decode picks the right format)."""
        return (self.rb_S, self.rb_nb) if self.rb_S is not None else None

    @property
    def tables(self):
        """Pytree of the sharded occ tables (mode-dependent arity)."""
        if self.rb_S is not None:
            return (self.rb_rows, self.rb_esc, self.occ_super)
        if self.occf is not None:
            if self.occ_super is not None:  # fused int64: + megablock bases
                return (self.occf, self.occ_super)
            return (self.occf,)
        return (self.occ_bits, self.occ_block, self.occ_super)

    @property
    def table_specs(self):
        if self.rb_S is not None:
            return (P("idx", None), P("idx", None), P())
        if self.occf is not None:
            if self.occ_super is not None:
                return (P("idx", None), P())
            return (P("idx", None),)
        return (P("idx", None), P("idx", None), P())


def rank1a_local(tables, nb_local: int, k: jax.Array, dt, rb=None):
    """Masked local rank partial for positions k against THIS shard's blocks.

    Inside shard_map: `tables` holds the local slabs — (occf,) fused rows,
    (occ_bits, occ_block, occ_super), or with rb=(S, nb) the compressed
    (rb_rows, rb_esc, occ_super) runblock slabs; the caller psums the result
    over the `idx` axis.  Only the owning shard contributes."""
    from ..ops.rank import _inblock_counts

    shard_id = jax.lax.axis_index("idx").astype(jnp.int32)
    if rb is not None:  # run-aware compressed rows (ops/runblock.py)
        from ..ops.runblock import decode_row_counts

        S, nb = rb
        rows, esc, mega = tables
        # k == n with S | n resolves to the last real block at off == S (same
        # as RunBlockIndex._counts_and_inblock), so its symbols all count
        bi_own = jnp.minimum(k // S, nb - 1).astype(jnp.int32)
        owner = bi_own // nb_local
        mine = owner == shard_id
        bi_loc = jnp.where(mine, bi_own - shard_id * nb_local, 0)
        row = rows[bi_loc]
        off = (k - bi_own.astype(k.dtype) * S).astype(jnp.int32)
        counts, _ = decode_row_counts(row, off, esc, mega, S, bi_own, dt)
        return jnp.where(mine[..., None], counts, jnp.zeros_like(counts))
    bi_glob = (k // BLOCK).astype(jnp.int32)
    owner = bi_glob // nb_local
    mine = owner == shard_id
    bi_loc = jnp.where(mine, bi_glob - shard_id * nb_local, 0)
    if len(tables) == 1:  # fused int32 rows: one gather per shard
        row = tables[0][bi_loc]
        bits = jax.lax.bitcast_convert_type(row[..., :6], jnp.uint32)
        base = row[..., 6:].astype(dt)
    elif len(tables) == 2:  # fused int64: + one-hot megablock bases (global)
        from ..ops import rank as rank_mod

        occf, mega = tables
        row = occf[bi_loc]
        bits = jax.lax.bitcast_convert_type(row[..., :6], jnp.uint32)
        lo = jax.lax.bitcast_convert_type(row[..., 6:], jnp.uint32).astype(dt)
        ns = mega.shape[0]
        mi = bi_glob >> rank_mod.MEGA_BLOCK_SHIFT
        oh = (jax.lax.broadcasted_iota(jnp.int32, mi.shape + (ns,), mi.ndim) == mi[..., None]).astype(dt)
        base = jnp.sum(oh[..., None] * mega, axis=-2, dtype=dt) + lo
    else:
        occ_bits, occ_block, occ_super = tables
        si = (bi_glob // BLOCKS_PER_SUPER).astype(jnp.int32)
        base = occ_super[si] + occ_block[bi_loc].astype(dt)
        bits = occ_bits[bi_loc]
    off = (k % BLOCK).astype(jnp.int32)
    local = base + _inblock_counts(bits, off).astype(dt)
    return jnp.where(mine[..., None], local, jnp.zeros_like(local))


def extend_sharded(tables, acc, nb_local: int, ik: jax.Array, is_back: jax.Array, rb=None):
    """Bidirectional extend inside shard_map; one psum over `idx` per call."""
    dt = acc.dtype
    ik = ik.astype(dt)
    prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
    kl = jnp.stack([prim, prim + ik[..., 2]], 0)
    r = rank1a_local(tables, nb_local, kl, dt, rb=rb)
    r = jax.lax.psum(r, "idx")
    tk, tl = r[0], r[1]
    sz = tl - tk
    prim_out = acc[:ASIZE] + tk
    sec_in = jnp.where(is_back, ik[..., 1], ik[..., 0])
    sec_out = jnp.zeros_like(prim_out)
    o = sec_in
    for c, prev in zip(_EXT_ORDER, (None,) + _EXT_ORDER[:-1]):
        if prev is not None:
            o = o + sz[..., prev]
        sec_out = sec_out.at[..., c].set(o)
    x0 = jnp.where(is_back[..., None], prim_out, sec_out)
    x1 = jnp.where(is_back[..., None], sec_out, prim_out)
    return jnp.stack([x0, x1, sz], axis=-1)


def extend_sharded_c(tables, acc, nb_local: int, ik: jax.Array, c: jax.Array, is_back: jax.Array, rb=None):
    """Single-symbol bidirectional extend inside shard_map (bit-identical to
    extend_sharded row c, cf. ops/rank.extend_c): one psum over `idx`, no
    (Q, 6, 3) candidate tensor, tiny-table lookups as one-hot arithmetic."""
    from ..ops.rank import _EXT_PREFIX

    dt = acc.dtype
    ik = ik.astype(dt)
    prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
    kl = jnp.stack([prim, prim + ik[..., 2]], 0)
    r = rank1a_local(tables, nb_local, kl, dt, rb=rb)
    r = jax.lax.psum(r, "idx")
    tk, tl = r[0], r[1]
    sz = tl - tk  # (Q, 6)
    onehot = (jax.lax.broadcasted_iota(jnp.int32, sz.shape, sz.ndim - 1) == c[..., None]).astype(dt)
    szc = jnp.sum(sz * onehot, axis=-1, dtype=dt)
    tkc = jnp.sum(tk * onehot, axis=-1, dtype=dt)
    prim_out = jnp.sum(acc[:ASIZE] * onehot, axis=-1, dtype=dt) + tkc
    sec_in = jnp.where(is_back, ik[..., 1], ik[..., 0])
    wrow = jnp.sum(onehot[..., None] * jnp.asarray(_EXT_PREFIX), axis=-2).astype(dt)
    sec_out = sec_in + jnp.sum(sz * wrow, axis=-1, dtype=dt)
    x0 = jnp.where(is_back, prim_out, sec_out)
    x1 = jnp.where(is_back, sec_out, prim_out)
    return jnp.stack([x0, x1, szc], axis=-1)


def make_mesh(dp: int, idx: int, devices=None) -> Mesh:
    """(dp, idx) mesh over the first dp*idx devices in order (any order is
    fine on an all-to-all interconnect such as NVLink)."""
    from .. import require_device

    require_device()
    devices = np.asarray(devices if devices is not None else jax.devices()[: dp * idx])
    return Mesh(devices.reshape(dp, idx), ("dp", "idx"))
