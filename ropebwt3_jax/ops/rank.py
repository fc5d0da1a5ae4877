"""Batched rank / bidirectional-extend on device — the primitive under every
query and construction op (cf. rld_rank2a / rld_extend, rld0.c:416-502).

The dense index (index/dense.py) is uploaded as one fused row table:
  occf       : (n_blocks+1, 12) int32 — 3 bit-planes x 2 words (cols 0:6) +
               counts before block (cols 6:12; absolute for int32 indexes,
               uint32 megablock-relative for int64 — see DeviceIndex)
  occ_super  : megablock base rows (int64 mode) — resolved one-hot, tiny
  acc        : (7,) idx — cumulative symbol counts

rank1a(k) for a batch of positions is ONE row gather plus, per symbol, six
xor/and ops and two popcounts on the masked bit-planes — pure VPU work, no
data-dependent control flow, so XLA fuses the whole thing.  idx dtype is int32
for indexes below 2^31 symbols and int64 above.
"""

from __future__ import annotations

from dataclasses import dataclass


from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
import numpy as np

from ..index.dense import BLOCK, BLOCKS_PER_SUPER, DenseFMIndex

ASIZE = 6
# bidirectional-extend complement order: the secondary coordinate accumulates
# sizes in the order 0,4,3,2,1,5 (rld_extend, rld0.c:495-500)
_EXT_ORDER = (0, 4, 3, 2, 1, 5)
# KEY[sym] = position of sym in the complement order.  Bit-planes are packed
# on KEY[sym] rather than sym, so "count of symbols preceding c in the extend
# order" (the secondary-coordinate prefix sum) is a single bit-parallel
# less-than circuit — see extend_c.
KEY = np.zeros(ASIZE, dtype=np.uint8)
for _pos, _c in enumerate(_EXT_ORDER):
    KEY[_c] = _pos


def pack_bitplanes(bwt_blocks: np.ndarray) -> np.ndarray:
    """(nb, 64) uint8 symbols -> (nb, 6) uint32 bit-planes of KEY[sym].

    Column layout: [p0_lo, p0_hi, p1_lo, p1_hi, p2_lo, p2_hi] where plane i
    holds bit i of the 3-bit keyed symbol, lo = block positions 0..31,
    hi = 32..63.  In-block rank for any symbol is then 6 xors/ands + 2
    popcounts instead of a (BLOCK, 6) one-hot reduction — far less VPU work
    and HBM traffic — and the keyed order additionally gives extend_c its
    one-comparison prefix count."""
    nb = bwt_blocks.shape[0]
    keyed = KEY[bwt_blocks]
    out = np.zeros((nb, 6), dtype=np.uint32)
    for plane in range(3):
        bits = (keyed >> plane) & 1
        words = np.packbits(bits, axis=1, bitorder="little").view("<u4")  # (nb, 2)
        out[:, plane * 2] = words[:, 0]
        out[:, plane * 2 + 1] = words[:, 1]
    return out


# blocks per 2^32-symbol megablock: int64-mode occf rows store counts as
# uint32 relative to the containing megablock (module attr so tests can
# shrink it to exercise multi-megablock indexes at toy sizes)
MEGA_BLOCK_SHIFT = 32 - 6  # log2(2^32 / BLOCK)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceIndex:
    """All indexes store ONE fused row table `occf` (nb, 12) int32 — columns
    0:6 the uint32 bit-planes (bitcast), 6:12 counts before the block — so a
    rank is a single row gather; every gather inside the SMEM loop body is an
    XLA fusion break and costs like a kernel dispatch.  int32 indexes (< 2^31 symbols) hold absolute counts; int64
    indexes hold uint32 counts relative to the containing 2^32-symbol
    megablock, whose int64 base rows live in the tiny `occ_super` table and
    are resolved by one-hot arithmetic (a handful of rows even at terabase
    scale), NOT a second gather.  The legacy three-table layout (occ_bits +
    uint16 occ_block under occ_super) remains readable for the sharded path."""

    occ_bits: jax.Array | None  # (nb, 6) uint32 bit-planes (int64 mode)
    occ_block: jax.Array | None  # (nb, 6) uint16 within-super counts (int64 mode)
    occ_super: jax.Array  # (ns, 6) idx; single zero row flags fused mode
    acc: jax.Array  # (7,) idx
    n: int
    comp: jax.Array  # (6,) complement table
    occf: jax.Array | None = None  # (nb, 12) int32 fused rows (int32 mode)

    def tree_flatten(self):
        return (self.occ_bits, self.occ_block, self.occ_super, self.acc, self.comp, self.occf), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        b, ob, os_, acc, comp, occf = children
        return cls(b, ob, os_, acc, (aux[0]), comp, occf)

    def bits_and_base(self, bi: jax.Array, dt) -> tuple[jax.Array, jax.Array]:
        """Gathered (., 6) uint32 planes and (., 6) dt counts-before-block for
        block rows bi — one fused gather (+ one-hot megablock base for int64),
        or block+super gathers for the legacy three-table layout."""
        if self.occf is not None:
            row = self.occf[bi]
            bits = jax.lax.bitcast_convert_type(row[..., :6], jnp.uint32)
            if dt == jnp.int32:
                return bits, row[..., 6:12].astype(dt)
            lo = jax.lax.bitcast_convert_type(row[..., 6:12], jnp.uint32).astype(dt)
            ns = self.occ_super.shape[0]
            mi = (bi >> MEGA_BLOCK_SHIFT).astype(jnp.int32)
            oh = (jax.lax.broadcasted_iota(jnp.int32, mi.shape + (ns,), mi.ndim) == mi[..., None]).astype(dt)
            base = jnp.sum(oh[..., None] * self.occ_super[:, :ASIZE], axis=-2, dtype=dt)
            return bits, base + lo
        si = bi // BLOCKS_PER_SUPER
        return self.occ_bits[bi], self.occ_super[si] + self.occ_block[bi].astype(dt)

    def bits_base_pre(self, bi: jax.Array, dt) -> tuple[jax.Array, jax.Array, jax.Array]:
        """Prefix-occ rows only (occf width 18): gathered (., 6) uint32
        planes, (., 6) dt counts-before-block, and (., 6) dt complement-order
        PREFIX sums before the block (pre[c] = sum of counts of symbols
        preceding c in the 0,4,3,2,1,5 extend order) — the extension's
        secondary-coordinate term as a stored column instead of a 6-wide dot
        (round-2 lever list #2)."""
        row = self.occf[bi]
        bits = jax.lax.bitcast_convert_type(row[..., :6], jnp.uint32)
        if dt == jnp.int32:
            return bits, row[..., 6:12].astype(dt), row[..., 12:18].astype(dt)
        lo = jax.lax.bitcast_convert_type(row[..., 6:18], jnp.uint32).astype(dt)
        ns = self.occ_super.shape[0]
        mi = (bi >> MEGA_BLOCK_SHIFT).astype(jnp.int32)
        oh = (jax.lax.broadcasted_iota(jnp.int32, mi.shape + (ns,), mi.ndim) == mi[..., None]).astype(dt)
        base12 = jnp.sum(oh[..., None] * self.occ_super, axis=-2, dtype=dt)  # (., 12)
        return bits, base12[..., :6] + lo[..., :6], base12[..., 6:] + lo[..., 6:]

    @property
    def has_prefix(self) -> bool:
        return self.occf is not None and self.occf.shape[-1] == 18

    @property
    def idx_dtype(self):
        return self.acc.dtype

    @classmethod
    def from_dense(cls, f: DenseFMIndex, idx_dtype=None, prefix: bool | None = None) -> "DeviceIndex":
        if idx_dtype is None:
            idx_dtype = jnp.int32 if f.n < (1 << 31) - (1 << 20) else jnp.int64
        if prefix is None:
            import os

            prefix = bool(os.environ.get("RB3JAX_PREFIX_OCC"))
        comp = jnp.asarray(np.array([0, 4, 3, 2, 1, 5], dtype=np.int32))
        acc = jnp.asarray(f.acc.astype(idx_dtype))
        occf, mega = build_occf(f, int64=idx_dtype == jnp.int64, prefix=prefix)
        return cls(
            occ_bits=None,
            occ_block=None,
            occ_super=jnp.zeros((1, ASIZE), jnp.int32) if mega is None else jnp.asarray(mega),
            acc=acc,
            n=f.n,
            comp=comp,
            occf=jnp.asarray(occf),
        )


def build_occf(f: DenseFMIndex, int64: bool, prefix: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
    """Host-side fused row table: (occf (nb, 12|18) int32, mega | None).

    int32 mode: absolute counts, mega None.  int64 mode: uint32 counts
    relative to the containing 2^32-symbol megablock plus the tiny (n_mega,
    6|12) int64 base table; chunked so int64 temporaries stay cache-sized at
    terabase nb.  prefix=True appends 6 complement-order prefix-sum columns
    (cols 12:18; megablock-relative in int64 mode, with the base prefix in
    mega cols 6:12) — see DeviceIndex.bits_base_pre."""
    nb = len(f.occ_block)
    W = 18 if prefix else 12
    occf = np.empty((nb, W), np.int32)
    occf[:, :6] = pack_bitplanes(f.bwt[: nb * BLOCK].reshape(nb, BLOCK)).view(np.int32)
    if not int64:
        cnt = np.repeat(f.occ_super, BLOCKS_PER_SUPER, axis=0)[:nb] + f.occ_block
        occf[:, 6:12] = cnt
        if prefix:
            occf[:, 12:18] = cnt @ _EXT_PREFIX.T
        return occf, None
    mega_blocks = 1 << MEGA_BLOCK_SHIFT
    n_mega = (nb + mega_blocks - 1) // mega_blocks
    mega = np.zeros((n_mega, 2 * ASIZE if prefix else ASIZE), np.int64)
    step = 1 << 20
    for b0 in range(0, nb, step):
        b1 = min(b0 + step, nb)
        s0 = b0 // BLOCKS_PER_SUPER
        sup = np.repeat(f.occ_super[s0 : (b1 - 1) // BLOCKS_PER_SUPER + 1], BLOCKS_PER_SUPER, axis=0)
        sup = sup[b0 - s0 * BLOCKS_PER_SUPER : b0 - s0 * BLOCKS_PER_SUPER + (b1 - b0)]
        glob = sup + f.occ_block[b0:b1]
        if prefix:
            glob = np.concatenate([glob, glob @ _EXT_PREFIX.T.astype(np.int64)], axis=1)
        for mb in range(b0 >> MEGA_BLOCK_SHIFT, ((b1 - 1) >> MEGA_BLOCK_SHIFT) + 1):
            r = mb << MEGA_BLOCK_SHIFT
            if b0 <= r < b1:
                mega[mb] = glob[r - b0]
        rel = glob - mega[(np.arange(b0, b1) >> MEGA_BLOCK_SHIFT)]
        occf[b0:b1, 6:] = rel.astype(np.uint32).view(np.int32)
    return occf, mega


def _inblock_counts(bits: jax.Array, off: jax.Array) -> jax.Array:
    """bits: (..., 6) uint32 planes; off: (...,) int32 in [0, 64].
    Returns (..., 6) int32 counts of each symbol among positions < off."""
    off = off.astype(jnp.uint32)
    one = jnp.uint32(1)
    full = jnp.uint32(0xFFFFFFFF)
    off_lo = jnp.minimum(off, 32)
    off_hi = jnp.where(off > 32, off - 32, 0)
    mask_lo = jnp.where(off_lo >= 32, full, (one << off_lo) - one)
    mask_hi = jnp.where(off_hi >= 32, full, (one << off_hi) - one)
    p = [bits[..., i] for i in range(6)]
    outs = []
    for c in range(ASIZE):
        kc = int(KEY[c])  # planes hold keyed symbols
        eq_lo = mask_lo
        eq_hi = mask_hi
        for plane in range(3):
            if (kc >> plane) & 1:
                eq_lo = eq_lo & p[plane * 2]
                eq_hi = eq_hi & p[plane * 2 + 1]
            else:
                eq_lo = eq_lo & ~p[plane * 2]
                eq_hi = eq_hi & ~p[plane * 2 + 1]
        cnt = jax.lax.population_count(eq_lo) + jax.lax.population_count(eq_hi)
        outs.append(cnt.astype(jnp.int32))
    return jnp.stack(outs, axis=-1)


def rank1a(idx, k: jax.Array) -> jax.Array:
    """occ[..., c] = |{i < k : B[i] = c}|.  k: idx-dtype array."""
    if hasattr(idx, "rank1a"):  # RunBlockIndex
        return idx.rank1a(k)
    dt = idx.idx_dtype
    k = k.astype(dt)
    bi = k // BLOCK
    if dt == jnp.int32 or idx.occf is not None:
        # row count < 2^31 for any index that fits one device's memory:
        # gather with int32 indices even in int64 mode
        bi = bi.astype(jnp.int32)
    bits, base = idx.bits_and_base(bi, dt)
    off = (k % BLOCK).astype(jnp.int32)
    add = _inblock_counts(bits, off)
    return base + add.astype(dt)


def rank2a(idx: DeviceIndex, k: jax.Array, l: jax.Array) -> tuple[jax.Array, jax.Array]:
    kl = jnp.stack([k, l], axis=0)
    r = rank1a(idx, kl)
    return r[0], r[1]


def extend(idx, ik: jax.Array, is_back: jax.Array) -> jax.Array:
    """Bidirectional extension of bi-intervals.

    ik: (..., 3) rows (x0, x1, size); is_back: (...,) bool (per-lane direction).
    Returns ok: (..., 6, 3) — for each next symbol c the extended bi-interval,
    with the exact complement-order prefix sums of the reference."""
    if hasattr(idx, "extend"):  # RunBlockIndex (ops/runblock.py) carries its own decode
        return idx.extend(ik, is_back)
    dt = idx.idx_dtype
    ik = ik.astype(dt)
    prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
    tk, tl = rank2a(idx, prim, prim + ik[..., 2])
    sz = tl - tk  # (..., 6)
    prim_out = idx.acc[:ASIZE] + tk  # (..., 6)
    sec_in = jnp.where(is_back, ik[..., 1], ik[..., 0])
    # prefix sums over the fixed complement order
    sec_out = jnp.zeros_like(prim_out)
    o = sec_in
    for c, prev in zip(_EXT_ORDER, (None,) + _EXT_ORDER[:-1]):
        if prev is not None:
            o = o + sz[..., prev]
        sec_out = sec_out.at[..., c].set(o)
    x0 = jnp.where(is_back[..., None], prim_out, sec_out)
    x1 = jnp.where(is_back[..., None], sec_out, prim_out)
    return jnp.stack([x0, x1, sz], axis=-1)


# _EXT_PREFIX[c, p] = 1 iff symbol p precedes c in the complement order —
# sec_out[c] = sec_in + sum_p prefix[c,p] * sz[p]
_EXT_PREFIX = np.zeros((ASIZE, ASIZE), dtype=np.int32)
for _pos, _c in enumerate(_EXT_ORDER):
    for _p in _EXT_ORDER[:_pos]:
        _EXT_PREFIX[_c, _p] = 1


def _inblock_c_and_prefix(bits: jax.Array, off: jax.Array, kc: jax.Array) -> tuple[jax.Array, jax.Array]:
    """bits: (..., 6) uint32 keyed planes; off: (...,) int32 in [0, 64];
    kc: (...,) int32 keyed symbol.  Returns (occ, pre) int32 counts below off
    of positions whose keyed symbol is == kc and < kc respectively."""
    off = off.astype(jnp.uint32)
    one = jnp.uint32(1)
    full = jnp.uint32(0xFFFFFFFF)
    off_lo = jnp.minimum(off, 32)
    off_hi = jnp.where(off > 32, off - 32, 0)
    masks = (
        jnp.where(off_lo >= 32, full, (one << off_lo) - one),
        jnp.where(off_hi >= 32, full, (one << off_hi) - one),
    )
    kcu = kc.astype(jnp.uint32)
    m = [jnp.uint32(0) - ((kcu >> i) & one) for i in range(3)]  # all-ones iff bit set
    occ = pre = None
    for h in range(2):
        x = [bits[..., p * 2 + h] ^ m[p] for p in range(3)]
        # per-plane: differs-and-kc-bit-set means value-bit < kc-bit
        lt0, lt1, lt2 = x[0] & m[0], x[1] & m[1], x[2] & m[2]
        eq1, eq2 = ~x[1], ~x[2]
        lt = (lt2 | (eq2 & (lt1 | (eq1 & lt0)))) & masks[h]
        eq = (eq2 & eq1 & ~x[0]) & masks[h]
        oc = jax.lax.population_count(eq)
        pc = jax.lax.population_count(lt)
        occ = oc if occ is None else occ + oc
        pre = pc if pre is None else pre + pc
    return occ.astype(jnp.int32), pre.astype(jnp.int32)


def _extend_c_prefix(idx: DeviceIndex, ik: jax.Array, c: jax.Array, is_back: jax.Array) -> jax.Array:
    """extend_c on a prefix-occ index (occf width 18) — bit-identical.

    The complement-order prefix sum (the extension's secondary-coordinate
    term) is a stored column: one one-hot select from the gathered row's
    prefix cols + the in-block lt circuit replace the 6-wide sz vector and
    its prefix-matrix dot (round-2 lever list #2).  The in-block part uses
    the eq/lt circuits of extend_c_circuit; the keyed symbol KEY[c] equals
    the nt6 complement arithmetic (KEY = position in the 0,4,3,2,1,5 order)."""
    dt = idx.idx_dtype
    ik = ik.astype(dt)
    prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
    kl = jnp.stack([prim, prim + ik[..., 2]], axis=0)  # (2, Q)
    bi = (kl // BLOCK).astype(jnp.int32)
    bits, base, basep = idx.bits_base_pre(bi, dt)  # (2, Q, 6) each
    off = (kl % BLOCK).astype(jnp.int32)
    kc = jnp.where(c % 5 == 0, c, 5 - c)  # KEY[c] == nt6 complement
    occ_in, pre_in = _inblock_c_and_prefix(bits, off, kc)  # (2, Q)
    oh = (jax.lax.broadcasted_iota(jnp.int32, base.shape, base.ndim - 1) == c[None, ..., None]).astype(dt)
    occ = jnp.sum(base * oh, axis=-1, dtype=dt) + occ_in.astype(dt)  # (2, Q)
    pre = jnp.sum(basep * oh, axis=-1, dtype=dt) + pre_in.astype(dt)
    szc = occ[1] - occ[0]
    acc_c = jnp.sum(idx.acc[:ASIZE] * oh[0], axis=-1, dtype=dt)
    prim_out = acc_c + occ[0]
    sec_in = jnp.where(is_back, ik[..., 1], ik[..., 0])
    sec_out = sec_in + (pre[1] - pre[0])
    x0 = jnp.where(is_back, prim_out, sec_out)
    x1 = jnp.where(is_back, sec_out, prim_out)
    return jnp.stack([x0, x1, szc], axis=-1)


def extend_c(idx: DeviceIndex, ik: jax.Array, c: jax.Array, is_back: jax.Array) -> jax.Array:
    """Bidirectional extension by ONE symbol per lane.

    Same math as `extend` restricted to row c (bit-identical), but never
    materializes the (Q, 6, 3) candidate tensor — inside the SMEM loop body
    the next symbol is already known, so the all-symbols variant would move
    3x the bytes.  All per-lane
    selections from tiny tables (acc, the complement-order prefix matrix) are
    one-hot arithmetic, not gathers: gathers break XLA fusion.
    ik: (Q, 3); c: (Q,) int32; is_back: (Q,) bool.  Returns (Q, 3)."""
    if hasattr(idx, "extend_c"):  # RunBlockIndex
        return idx.extend_c(ik, c, is_back)
    if idx.has_prefix:
        return _extend_c_prefix(idx, ik, c, is_back)
    dt = idx.idx_dtype
    ik = ik.astype(dt)
    prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
    tk, tl = rank2a(idx, prim, prim + ik[..., 2])
    sz = tl - tk  # (Q, 6)
    onehot = (jax.lax.broadcasted_iota(jnp.int32, sz.shape, sz.ndim - 1) == c[..., None]).astype(dt)
    szc = jnp.sum(sz * onehot, axis=-1, dtype=dt)
    tkc = jnp.sum(tk * onehot, axis=-1, dtype=dt)
    prim_out = jnp.sum(idx.acc[:ASIZE] * onehot, axis=-1, dtype=dt) + tkc
    sec_in = jnp.where(is_back, ik[..., 1], ik[..., 0])
    wrow = jnp.sum(onehot[..., None] * jnp.asarray(_EXT_PREFIX), axis=-2).astype(dt)  # (Q, 6)
    sec_out = sec_in + jnp.sum(sz * wrow, axis=-1, dtype=dt)
    x0 = jnp.where(is_back, prim_out, sec_out)
    x1 = jnp.where(is_back, sec_out, prim_out)
    return jnp.stack([x0, x1, szc], axis=-1)


def extend_c_circuit(idx: DeviceIndex, ik: jax.Array, c: jax.Array, is_back: jax.Array) -> jax.Array:
    """extend_c via eq/lt bit-circuits on the keyed planes — bit-identical.

    Because the planes hold KEY[sym] (complement-order position, rld_extend's
    accumulation order rld0.c:495-500), the two quantities the extension needs
    per endpoint — occ_c and the complement-order prefix sum over symbols
    preceding c — are one equality circuit and one less-than circuit on the
    gathered plane words, skipping the per-symbol (Q, 6) count tensors.
    Not used by the SMEM loop: the lt mux tree is a serial dependency chain,
    and it lost to extend_c on the previous accelerator.  Kept in-tree
    (equivalence-tested) for fused-body kernels where op count matters more
    than ILP."""
    dt = idx.idx_dtype
    ik = ik.astype(dt)
    prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
    kl = jnp.stack([prim, prim + ik[..., 2]], axis=0)  # (2, Q)
    bi = kl // BLOCK
    if dt == jnp.int32 or idx.occf is not None:
        bi = bi.astype(jnp.int32)
    bits, base6 = idx.bits_and_base(bi, dt)  # (2, Q, 6) each
    off = (kl % BLOCK).astype(jnp.int32)
    kc = jnp.take(jnp.asarray(KEY.astype(np.int32)), c)  # (Q,)
    occ_in, pre_in = _inblock_c_and_prefix(bits, off, kc)  # (2, Q)
    onehot = (jax.lax.broadcasted_iota(jnp.int32, base6.shape, base6.ndim - 1) == c[None, ..., None]).astype(dt)
    occ = jnp.sum(base6 * onehot, axis=-1, dtype=dt) + occ_in.astype(dt)  # (2, Q)
    wrow = jnp.take(jnp.asarray(_EXT_PREFIX.reshape(-1)), c[..., None] * ASIZE + jnp.arange(ASIZE, dtype=jnp.int32)).astype(dt)
    pre = jnp.sum(base6 * wrow[None], axis=-1, dtype=dt) + pre_in.astype(dt)  # (2, Q)
    szc = occ[1] - occ[0]
    prim_out = jnp.take(idx.acc, c) + occ[0]
    sec_in = jnp.where(is_back, ik[..., 1], ik[..., 0])
    sec_out = sec_in + (pre[1] - pre[0])
    x0 = jnp.where(is_back, prim_out, sec_out)
    x1 = jnp.where(is_back, sec_out, prim_out)
    return jnp.stack([x0, x1, szc], axis=-1)


def set_intv(idx: DeviceIndex, c: jax.Array) -> jax.Array:
    """Initial bi-interval of one symbol (fm-index.h:90-93); c: (...,) int32.

    Tiny-table lookups (acc[c], acc[comp], acc[c+1]) are one-hot sums, not
    gathers — the SMEM loop body calls this every iteration and gathers break
    XLA fusion; comp is arithmetic (fixed points 0 and 5, else 5-c)."""
    c = c.astype(jnp.int32)
    oh = (jax.lax.broadcasted_iota(jnp.int32, c.shape + (ASIZE,), c.ndim) == c[..., None]).astype(idx.acc.dtype)
    comp = jnp.where(c % 5 == 0, c, 5 - c)
    ohc = (jax.lax.broadcasted_iota(jnp.int32, c.shape + (ASIZE,), c.ndim) == comp[..., None]).astype(idx.acc.dtype)
    acc_c = jnp.sum(idx.acc[:ASIZE] * oh, axis=-1, dtype=idx.acc.dtype)
    acc_c1 = jnp.sum(idx.acc[1 : ASIZE + 1] * oh, axis=-1, dtype=idx.acc.dtype)
    acc_comp = jnp.sum(idx.acc[:ASIZE] * ohc, axis=-1, dtype=idx.acc.dtype)
    return jnp.stack([acc_c, acc_comp, acc_c1 - acc_c], axis=-1)
