"""Run-aware compressed device occ rows — the beyond-device-memory capacity
format.

The dense fused rows (ops/rank.py) cost 0.75 B/sym, capping a replicated
index at the device memory over 0.75; the reference serves 14.66 Tsym from a
27.6 GB host index precisely because its rld0 blocks are run-length coded
(rld0.c:107-204).  This module is the device analog: per RB-block of S
symbols (S static per index, picked at build time) ONE 160-byte row

    cols 0:6   counts before the block (absolute int32 below 2^31 symbols;
               uint32 relative to the containing 2^32-symbol megablock above,
               with the tiny int64 base table resolved one-hot — same
               convention as DeviceIndex)
    col  6     dense-escape row index, or -1 for run-coded blocks
    col  7     pad
    cols 8:40  64 packed uint16 run records: (cumulative in-block end << 3)
               | keyed symbol, zero-length-padded

plus, for the rare blocks holding more than 64 split-runs, a dense-escape
side table of three keyed bit-planes (3*S/32 int32 words per row).  A rank
is then exactly the gather shape XLA likes: one (2, Q) row gather + one
(2, Q) escape-row gather (lanes on run blocks read escape row 0), all
decode pure elementwise VPU work.  At mean run length g the footprint is
~160/S + esc ~= 0.3 B/sym at 1% divergence (S=512) down to ~0.02 B/sym at
pangenome redundancy (S=8192).

Symbols inside records/planes are stored KEYED (position in the 0,4,3,2,1,5
complement order, rank.KEY), so the extension's secondary-coordinate prefix
("how many symbols before c in complement order") is a `<` compare on the
run records and the standard lt-circuit on the escape planes — identical
math to rank.extend_c_circuit, equivalence-tested in tests/test_runblock.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .. import _jax_setup as __jx

__jx()
import jax
import jax.numpy as jnp
import numpy as np

from .rank import ASIZE, KEY, _EXT_ORDER, _EXT_PREFIX

RB_R = 64  # run records per row; 16-bit records support S <= 8192


def _key_perm() -> np.ndarray:
    """perm[c] = KEY[c]: counts produced in keyed space -> nt6 space."""
    return KEY.astype(np.int32)


@jax.tree_util.register_pytree_node_class
@dataclass
class RunBlockIndex:
    rows: jax.Array  # (nb, 40) int32
    esc: jax.Array  # (max(n_esc,1), 3*S/32) int32 keyed bit-planes
    occ_super: jax.Array  # (n_mega, 6) int64 (int64 mode) | (1, 6) int32 zeros
    acc: jax.Array  # (7,) idx dtype
    n: int
    S: int
    comp: jax.Array  # (6,) int32

    def tree_flatten(self):
        return (self.rows, self.esc, self.occ_super, self.acc, self.comp), (self.n, self.S)

    @classmethod
    def tree_unflatten(cls, aux, children):
        rows, esc, os_, acc, comp = children
        return cls(rows, esc, os_, acc, aux[0], aux[1], comp)

    @property
    def idx_dtype(self):
        return self.acc.dtype

    # ---- device decode ---------------------------------------------------

    def _counts_and_inblock(self, kl: jax.Array, dt):
        """kl: (2, Q) positions clamped to [0, n].  Returns (counts6 (2,Q,6)
        dt in nt6 order, occk (2,Q,6) int32 keyed in-block counts below off).

        k == n with S | n has no block of its own: it resolves to the last
        block at off == S, so that block's symbols are all counted."""
        S = self.S
        nb = self.rows.shape[0]
        bi = jnp.minimum(kl // S, nb - 1).astype(jnp.int32)
        off = (kl - bi.astype(kl.dtype) * S).astype(jnp.int32)
        row = self.rows[bi]  # (2, Q, 40)
        return decode_row_counts(row, off, self.esc, self.occ_super, S, bi, dt)

    def extend(self, ik: jax.Array, is_back: jax.Array) -> jax.Array:
        """All-symbols bidirectional extension; same contract as rank.extend."""
        dt = self.idx_dtype
        ik = ik.astype(dt)
        prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
        nmax = jnp.asarray(self.n, dt)
        kl = jnp.stack([jnp.minimum(prim, nmax), jnp.minimum(prim + ik[..., 2], nmax)], axis=0)
        occ, _ = self._counts_and_inblock(kl, dt)  # (2, Q, 6) nt6
        tk, tl = occ[0], occ[1]
        sz = tl - tk
        prim_out = self.acc[:ASIZE] + tk
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

    def extend_c(self, ik: jax.Array, c: jax.Array, is_back: jax.Array) -> jax.Array:
        """Single-symbol extension; same contract as rank.extend_c."""
        dt = self.idx_dtype
        ik = ik.astype(dt)
        prim = jnp.where(is_back, ik[..., 0], ik[..., 1])
        nmax = jnp.asarray(self.n, dt)
        kl = jnp.stack([jnp.minimum(prim, nmax), jnp.minimum(prim + ik[..., 2], nmax)], axis=0)
        occ6, occk = self._counts_and_inblock(kl, dt)  # nt6 / keyed
        oh = (jax.lax.broadcasted_iota(jnp.int32, occ6.shape, occ6.ndim - 1) == c[None, ..., None]).astype(dt)
        occ = jnp.sum(occ6 * oh, axis=-1, dtype=dt)  # (2, Q)
        # complement-order prefix: base part from nt6 counts x prefix matrix,
        # in-block part by summing keyed counts below KEY[c]
        wrow = jnp.sum(oh[..., None] * jnp.asarray(_EXT_PREFIX), axis=-2).astype(dt)  # (2,Q,6)
        base6 = occ6 - occk[..., jnp.asarray(_key_perm())].astype(dt)  # counts before block, nt6
        pre_base = jnp.sum(base6 * wrow, axis=-1, dtype=dt)
        kc = jnp.where(c % 5 == 0, c, 5 - c)  # KEY[c]
        ltmask = (jax.lax.broadcasted_iota(jnp.int32, occk.shape, occk.ndim - 1) < kc[None, ..., None]).astype(jnp.int32)
        pre_in = jnp.sum(occk * ltmask, axis=-1)
        pre = pre_base + pre_in.astype(dt)
        szc = occ[1] - occ[0]
        acc_c = jnp.sum(self.acc[:ASIZE] * oh[0], axis=-1, dtype=dt)
        prim_out = acc_c + occ[0]
        sec_in = jnp.where(is_back, ik[..., 1], ik[..., 0])
        sec_out = sec_in + (pre[1] - pre[0])
        x0 = jnp.where(is_back, prim_out, sec_out)
        x1 = jnp.where(is_back, sec_out, prim_out)
        return jnp.stack([x0, x1, szc], axis=-1)

    def rank1a(self, k: jax.Array) -> jax.Array:
        """(..., 6) nt6 counts below k — testing aid."""
        dt = self.idx_dtype
        k = jnp.minimum(k.astype(dt), jnp.asarray(self.n, dt))
        occ, _ = self._counts_and_inblock(jnp.stack([k, k], axis=0), dt)
        return occ[0]


def decode_row_counts(row: jax.Array, off: jax.Array, esc: jax.Array, occ_super: jax.Array, S: int, bi_glob: jax.Array, dt):
    """Pure-elementwise decode of gathered rb rows — shared by the
    single-device RunBlockIndex and the idx-sharded mesh path
    (parallel/mesh.rank1a_local, rb mode).

    row: (..., 40) gathered rows; off: (...,) in-block offsets in [0, S];
    esc: the (local) escape-plane table row[...,6] indexes into;
    occ_super: megablock int64 bases (int64 mode) — indexed by the GLOBAL
    block id bi_glob, so sharded callers pass global ids while gathering
    rows from their local slab.  Returns (counts6 (...,6) dt nt6 order,
    occk (...,6) int32 keyed in-block counts below off)."""
    if dt == jnp.int32:
        counts = row[..., :6].astype(dt)
    else:
        lo = jax.lax.bitcast_convert_type(row[..., :6], jnp.uint32).astype(dt)
        ns = occ_super.shape[0]
        mega_shift = 32 - int(S).bit_length() + 1  # log2(2^32 / S)
        mi = (bi_glob >> mega_shift).astype(jnp.int32)
        oh = (jax.lax.broadcasted_iota(jnp.int32, mi.shape + (ns,), mi.ndim) == mi[..., None]).astype(dt)
        counts = jnp.sum(oh[..., None] * occ_super, axis=-2, dtype=dt) + lo
    esc_i = row[..., 6]
    # run path: keyed in-block counts via the packed records
    recs = row[..., 8:40]
    lo16 = recs & jnp.int32(0xFFFF)
    hi16 = (recs >> 16) & jnp.int32(0xFFFF)
    e16 = jnp.stack([lo16, hi16], axis=-1).reshape(recs.shape[:-1] + (RB_R,))
    sym = e16 & jnp.int32(7)
    end = e16 >> 3
    start = jnp.concatenate([jnp.zeros_like(end[..., :1]), end[..., :-1]], axis=-1)
    cov = jnp.clip(jnp.minimum(off[..., None], end) - start, 0, None)  # (...,64)
    ohk = (jax.lax.broadcasted_iota(jnp.int32, cov.shape + (ASIZE,), cov.ndim) == sym[..., None]).astype(jnp.int32)
    occk_run = jnp.sum(cov[..., None] * ohk, axis=-2)  # (...,6) keyed
    # dense path: multi-word keyed planes
    planes = esc[jnp.clip(esc_i, 0)]  # (..., 3W)
    occk_dense = _dense_counts_keyed(planes, off)
    occk = jnp.where((esc_i >= 0)[..., None], occk_dense, occk_run)
    # keyed -> nt6: counts6[c] = occk[KEY[c]] (static permutation)
    perm = jnp.asarray(_key_perm())
    occ_nt6 = occk[..., perm]
    return counts + occ_nt6.astype(dt), occk


def _dense_counts_keyed(planes: jax.Array, off: jax.Array) -> jax.Array:
    """planes: (..., 3W) int32 keyed bit-planes; off: (...,) int32 in [0, S].
    Returns (..., 6) int32 counts per KEYED symbol below off."""
    W = planes.shape[-1] // 3
    u = jax.lax.bitcast_convert_type(planes, jnp.uint32)
    p = [u[..., i * W : (i + 1) * W] for i in range(3)]
    wi = jax.lax.broadcasted_iota(jnp.int32, off.shape + (W,), off.ndim)
    off_w = jnp.clip(off[..., None] - 32 * wi, 0, 32).astype(jnp.uint32)
    full = jnp.uint32(0xFFFFFFFF)
    mask = jnp.where(off_w >= 32, full, (jnp.uint32(1) << off_w) - jnp.uint32(1))
    outs = []
    for kc in range(ASIZE):
        eq = mask
        for plane in range(3):
            eq = eq & (p[plane] if (kc >> plane) & 1 else ~p[plane])
        outs.append(jnp.sum(jax.lax.population_count(eq).astype(jnp.int32), axis=-1))
    return jnp.stack(outs, axis=-1)


# ---- host-side builder ---------------------------------------------------


def choose_S(lens: np.ndarray, n: int) -> tuple[int, dict]:
    """Pick the block size minimizing total bytes (rows 160 B/block + dense
    escapes 3S/8 B each); returns (S, {S: (bytes, esc_frac)})."""
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    lens = np.ascontiguousarray(lens, np.int64)
    stats = {}
    best, best_bytes = 512, float("inf")
    for S in (8192, 4096, 2048, 1024, 512, 256):
        nb = (n + S - 1) // S
        cnt = np.zeros(nb, np.int32)
        lib.rb3t_runblock_count(
            ctypes.c_void_p(lens.ctypes.data), len(lens), S, ctypes.c_void_p(cnt.ctypes.data)
        )
        n_esc = int((cnt > RB_R).sum())
        total = nb * 160 + n_esc * (3 * S // 8)
        stats[S] = (total, n_esc / max(nb, 1))
        if total < best_bytes:
            best, best_bytes = S, total
    return best, stats


def build_runblock_np(syms: np.ndarray, lens: np.ndarray, n: int | None = None, S: int | None = None, idx_dtype=None) -> dict:
    """Build the compressed rows on the host; returns the raw numpy pieces
    {rows, esc, mega|None, acc, n, S, int64} (build_runblock wraps them onto
    the device; ShardedIndex re-shards them over the idx mesh axis)."""
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native codec unavailable; runblock build needs it")
    syms = np.ascontiguousarray(syms, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    if n is None:
        n = int(lens.sum())
    if S is None:
        S, _ = choose_S(lens, n)
    if idx_dtype is None:
        idx_dtype = jnp.int32 if n < (1 << 31) - (1 << 20) else jnp.int64
    int64 = idx_dtype == jnp.int64
    nb = (n + S - 1) // S
    cnt = np.zeros(nb, np.int32)
    P = ctypes.c_void_p
    lib.rb3t_runblock_count(P(lens.ctypes.data), len(lens), S, P(cnt.ctypes.data))
    rows = np.zeros((nb, 40), np.int32)
    esc_blocks = np.flatnonzero(cnt > RB_R)
    rows[:, 6] = -1
    rows[esc_blocks, 6] = np.arange(len(esc_blocks), dtype=np.int32)
    esc = np.zeros((max(len(esc_blocks), 1), 3 * S // 32), np.int32)
    bpm = (1 << 32) // S
    n_mega = (nb + bpm - 1) // bpm if int64 else 1
    mega = np.zeros((n_mega, ASIZE), np.int64)
    lib.rb3t_runblock_fill(
        P(syms.ctypes.data), P(lens.ctypes.data), len(lens), n, S, RB_R,
        P(rows.ctypes.data), P(esc.ctypes.data),
        P(mega.ctypes.data) if int64 else None,
    )
    acc = np.zeros(7, np.int64)
    np.add.at(acc[1:], syms, lens)
    acc = np.cumsum(acc)
    return dict(rows=rows, esc=esc, mega=mega if int64 else None,
                acc=acc.astype(np.int64 if int64 else np.int32), n=n, S=S, int64=int64)


def _to_device(d: dict) -> RunBlockIndex:
    comp = jnp.asarray(np.array([0, 4, 3, 2, 1, 5], dtype=np.int32))
    return RunBlockIndex(
        rows=jnp.asarray(d["rows"]),
        esc=jnp.asarray(d["esc"]),
        occ_super=jnp.asarray(d["mega"]) if d["mega"] is not None else jnp.zeros((1, ASIZE), jnp.int32),
        acc=jnp.asarray(d["acc"]),
        n=int(d["n"]),
        S=int(d["S"]),
        comp=comp,
    )


def build_runblock(syms: np.ndarray, lens: np.ndarray, n: int | None = None, S: int | None = None, idx_dtype=None) -> RunBlockIndex:
    """Build the compressed device index from global BWT runs."""
    return _to_device(build_runblock_np(syms, lens, n=n, S=S, idx_dtype=idx_dtype))


def shard_layout_np(d: dict, n_idx: int) -> dict:
    """Re-lay host-built rows for an n_idx-way shard of the block axis
    (parallel/mesh.ShardedIndex occ="rb"): rows pad to a multiple of n_idx
    and their escape ids renumber PER SHARD (each shard carries only its own
    escape planes, padded to the max per-shard count so the slabs are
    equal-shaped).  The tiny megablock base table stays replicated.

    Returns {rows (nb_pad, 40), esc (n_idx*esc_pad, 3S/32), nb_local,
    esc_pad} — shard s owns rows[s*nb_local:(s+1)*nb_local] and
    esc[s*esc_pad:(s+1)*esc_pad]."""
    rows, esc = d["rows"], d["esc"]
    nb = len(rows)
    nb_pad = (nb + n_idx - 1) // n_idx * n_idx
    nb_local = nb_pad // n_idx
    rows2 = np.full((nb_pad, 40), 0, np.int32)
    rows2[:nb] = rows
    rows2[nb:, 6] = -1  # pad blocks: no escape row
    has = rows[:, 6] >= 0
    owner = np.arange(nb) // nb_local
    counts = np.bincount(owner[has], minlength=n_idx)
    esc_before = np.concatenate([[0], np.cumsum(counts)])[:n_idx]
    glob = rows[:, 6]
    local = glob - esc_before[owner]
    rows2[:nb][has, 6] = local[has]
    esc_pad = max(1, int(counts.max()) if n_idx else 1)
    esc_sh = np.zeros((n_idx * esc_pad, esc.shape[1]), np.int32)
    esc_sh[owner[has] * esc_pad + local[has]] = esc[glob[has]]
    return dict(rows=rows2, esc=esc_sh, nb_local=nb_local, esc_pad=esc_pad)


# ---- sidecar cache (`<idx>.dense.rb.npz`) --------------------------------
# Deriving runs from a multi-GB dense BWT costs tens of seconds; persisting
# the built rows makes rb-engine startup (serve, bench, capacity mode) a
# single file read — the analog of the `.dense` sidecar for the compressed
# format.


def save_cache(path: str, d: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"  # np.savez appends .npz to a bare stem
    np.savez(tmp, rows=d["rows"], esc=d["esc"],
             mega=d["mega"] if d["mega"] is not None else np.zeros(0, np.int64),
             acc=d["acc"], meta=np.array([d["n"], d["S"], int(d["int64"])], np.int64))
    os.replace(tmp + ".npz", path)


def load_cache(path: str, n: int) -> dict | None:
    try:
        z = np.load(path, allow_pickle=False)
        meta = z["meta"]
        if int(meta[0]) != n:
            return None
        int64 = bool(meta[2])
        mega = z["mega"]
        return dict(rows=z["rows"], esc=z["esc"], mega=mega if int64 and mega.size else None,
                    acc=z["acc"], n=int(meta[0]), S=int(meta[1]), int64=int64)
    except Exception:
        return None


def runs_from_dense(f) -> tuple[np.ndarray, np.ndarray]:
    """(syms, lens) of the global BWT runs of a DenseFMIndex."""
    bwt = np.asarray(f.bwt[: f.n])
    brk = np.flatnonzero(np.diff(bwt)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [f.n]])
    return bwt[starts], ends - starts


def from_dense_np(f, S: int | None = None, idx_dtype=None, cache: str | None | bool = True) -> dict:
    """Host-side rows from a DenseFMIndex, through the sidecar cache when the
    index itself came from a `.dense` sidecar (cache=True resolves the path;
    pass a string to override, None/False to disable)."""
    if cache is True:
        sc = getattr(f, "_sidecar_path", None)
        cache = sc + ".rb.npz" if sc else None
    if cache and os.path.exists(cache) and S is None and idx_dtype is None:
        got = load_cache(cache, int(f.n))
        if got is not None:
            return got
    syms, lens = runs_from_dense(f)
    d = build_runblock_np(syms, lens, n=f.n, S=S, idx_dtype=idx_dtype)
    if cache and S is None and idx_dtype is None:
        try:
            save_cache(cache, d)
        except OSError:
            pass
    return d


def from_dense(f, S: int | None = None, idx_dtype=None, cache: str | None | bool = True) -> RunBlockIndex:
    """Build from a DenseFMIndex (cached via `<sidecar>.rb.npz` by default)."""
    return _to_device(from_dense_np(f, S=S, idx_dtype=idx_dtype, cache=cache))
