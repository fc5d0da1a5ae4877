"""Dense occurrence-checkpoint FM-index — the device-resident representation.

Replaces rld0's frame+Elias-delta decode (rld0.c:348-502) with O(1) vectorized
lookups: the BWT is stored as one byte per symbol plus two-level occurrence
checkpoints (uint16 per-block counts every BLOCK symbols relative to int64
superblock counts every SUPER symbols).  rank(k, ·) = superblock row + block
row + an in-block prefix count — a handful of gathers and compares, ideal for
batching across thousands of query lanes on the VPU.

Memory: 1 B/sym (BWT) + 12 B/BLOCK (block rows) + 48 B/SUPER (superblock rows)
≈ 1.19 B/sym at BLOCK=64.  mtb152 (~1.3 G symbols) fits in one device's memory; larger
indexes shard the position axis across a device mesh (parallel/).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

ASIZE = 6
BLOCK = 64
SUPER = 1 << 16
BLOCKS_PER_SUPER = SUPER // BLOCK


@dataclass
class DenseFMIndex:
    bwt: np.ndarray  # uint8 [n_pad], padded with zeros beyond n
    n: int
    acc: np.ndarray  # int64 [7] cumulative symbol counts (C-array), acc[0]=0
    occ_block: np.ndarray  # uint16 [n_blocks+1, 6], counts in [super_start, block_start)
    occ_super: np.ndarray  # int64 [n_supers+1, 6], counts before superblock
    # lazily attached extras
    ssa: object | None = field(default=None, repr=False)
    sid: object | None = field(default=None, repr=False)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_bwt(cls, bwt: np.ndarray) -> "DenseFMIndex":
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        n = len(bwt)
        n_blocks = (n + BLOCK - 1) // BLOCK
        n_pad = (n_blocks + 1) * BLOCK
        b = np.zeros(n_pad, dtype=np.uint8)
        b[:n] = bwt
        # one-pass native table build (round 4): the numpy path below costs
        # multiple GB-scale int64 passes per call (~65 s/G at pangenome
        # scale, dominating multi-batch merges); the native pass writes the
        # uint16/int64 tables directly, threaded over superblocks.
        try:
            import ctypes
            import os as _os

            from ..native import get_lib as _get_lib

            _lib = _get_lib()
            if _lib is not None and hasattr(_lib, "rb3t_dense_tables"):
                n_supers = (n_blocks + BLOCKS_PER_SUPER - 1) // BLOCKS_PER_SUPER
                occ_block = np.empty((n_blocks + 1, ASIZE), dtype=np.uint16)
                occ_super = np.empty((n_supers + 1, ASIZE), dtype=np.int64)
                acc = np.zeros(ASIZE + 1, dtype=np.int64)
                P = ctypes.c_void_p
                _lib.rb3t_dense_tables(
                    P(b.ctypes.data), n, n_blocks, n_supers,
                    P(occ_block.ctypes.data), P(occ_super.ctypes.data), P(acc.ctypes.data),
                    int(_os.cpu_count() or 1),
                )
                return cls(bwt=b, n=n, acc=acc, occ_block=occ_block, occ_super=occ_super)
        except Exception:
            pass
        if n % BLOCK:
            # padding bytes beyond n must not pollute counts of the last block
            b[n : n_blocks * BLOCK] = 255
        # per-block symbol counts, (6, n_blocks+1) layout so the exclusive
        # cumulative runs over contiguous rows; chunked so the boolean
        # temporaries stay cache-sized even for multi-GB BWTs
        per_block_rows = np.zeros((n_blocks + 1, ASIZE), dtype=np.int64)
        _native_counts = False
        try:
            import ctypes

            from ..native import get_lib

            lib = get_lib()
            if lib is not None:
                lib.rb3t_block_counts(
                    b.ctypes.data_as(ctypes.c_void_p), n, n_blocks, per_block_rows.ctypes.data_as(ctypes.c_void_p)
                )
                _native_counts = True
        except Exception:
            pass
        if not _native_counts:
            CHUNK_BLOCKS = 1 << 18
            for b0 in range(0, n_blocks, CHUNK_BLOCKS):
                b1 = min(b0 + CHUNK_BLOCKS, n_blocks)
                blk = b[b0 * BLOCK : b1 * BLOCK].reshape(b1 - b0, BLOCK)
                for c in range(ASIZE):
                    per_block_rows[b0 + 1 : b1 + 1, c] = (blk == c).sum(axis=1)
        per_block = np.ascontiguousarray(per_block_rows.T)
        del per_block_rows
        occ_glob_t = np.cumsum(per_block, axis=1)  # [6, n_blocks+1] counts before block
        if n % BLOCK:
            b[n : n_blocks * BLOCK] = 0
        n_supers = (n_blocks + BLOCKS_PER_SUPER - 1) // BLOCKS_PER_SUPER
        sb = np.arange(n_supers + 1) * BLOCKS_PER_SUPER
        np.clip(sb, 0, n_blocks, out=sb)
        occ_super = np.ascontiguousarray(occ_glob_t[:, sb].T)
        # per-block counts relative to the containing superblock: sequential
        # repeat of the super rows instead of a giant index gather
        reps = np.repeat(occ_super, BLOCKS_PER_SUPER, axis=0)[: n_blocks + 1]
        occ_block = (occ_glob_t.T - reps).astype(np.uint16)
        acc = np.zeros(ASIZE + 1, dtype=np.int64)
        acc[1:] = np.cumsum(occ_glob_t[:, n_blocks])
        return cls(bwt=b, n=n, acc=acc, occ_block=occ_block, occ_super=occ_super)

    @classmethod
    def from_runs(cls, syms: np.ndarray, lens: np.ndarray) -> "DenseFMIndex":
        syms = np.ascontiguousarray(syms, dtype=np.uint8)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        try:
            import ctypes

            from ..native import get_lib

            lib = get_lib()
            if lib is not None:
                n = int(lens.sum())
                bwt = np.empty(n, dtype=np.uint8)
                lib.rb3t_runs_expand(
                    syms.ctypes.data_as(ctypes.c_void_p),
                    lens.ctypes.data_as(ctypes.c_void_p),
                    len(syms),
                    bwt.ctypes.data_as(ctypes.c_void_p),
                )
                return cls.from_bwt(bwt)
        except Exception:
            pass
        return cls.from_bwt(np.repeat(syms, lens))

    # -- conversions -------------------------------------------------------
    def to_runs(self) -> tuple[np.ndarray, np.ndarray]:
        b = self.bwt[: self.n]
        if self.n == 0:
            return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
        change = np.flatnonzero(b[1:] != b[:-1]) + 1
        starts = np.concatenate(([0], change))
        ends = np.concatenate((change, [self.n]))
        return b[starts].copy(), (ends - starts).astype(np.int64)

    @property
    def n_runs(self) -> int:
        b = self.bwt[: self.n]
        if self.n == 0:
            return 0
        return int(1 + np.count_nonzero(b[1:] != b[:-1]))

    # -- rank (numpy golden implementation) --------------------------------
    def rank1a(self, k) -> np.ndarray:
        """occ[c] = |{i < k : B[i] = c}| for all c; vectorized over array k.

        Returns shape k.shape + (6,)."""
        k = np.minimum(np.asarray(k, dtype=np.int64), self.n)
        blk_i = k // BLOCK
        sup_i = blk_i // BLOCKS_PER_SUPER
        base = self.occ_super[sup_i] + self.occ_block[blk_i].astype(np.int64)
        blks = self.bwt[(blk_i[..., None] * BLOCK + np.arange(BLOCK)).reshape(-1)].reshape(*k.shape, BLOCK)
        off = (k % BLOCK)[..., None]
        inpref = np.arange(BLOCK) < off
        add = np.stack([((blks == c) & inpref).sum(axis=-1) for c in range(ASIZE)], axis=-1)
        return base + add

    def rank2a(self, k, l) -> tuple[np.ndarray, np.ndarray]:
        return self.rank1a(k), self.rank1a(l)

    def rank1a_fast(self, k) -> np.ndarray:
        """rank1a via the native threaded batch kernel (rb3t_rank_batch:
        AVX in-block counts + distance prefetch) when available; equality
        with the numpy golden path is property-tested.  k: (m,) int64."""
        k = np.ascontiguousarray(np.asarray(k, dtype=np.int64))
        if k.ndim != 1 or len(k) < 2048:
            return self.rank1a(k)
        try:
            from ..native import get_sw_lib

            lib = get_sw_lib()
        except Exception:
            lib = None
        if lib is None:
            return self.rank1a(k)
        import ctypes
        import os

        out = np.empty((len(k), ASIZE), np.int64)
        P = ctypes.c_void_p
        lib.rb3t_rank_batch(
            P(self.bwt.ctypes.data), P(self.occ_block.ctypes.data), P(self.occ_super.ctypes.data),
            P(self.acc.ctypes.data), int(self.n), P(k.ctypes.data), len(k),
            P(out.ctypes.data), int(os.cpu_count() or 1),
        )
        return out

    def symbol_at(self, k) -> np.ndarray:
        return self.bwt[np.asarray(k, dtype=np.int64)]

    # -- bidirectional extension (fm-index.c:384-400 semantics) ------------
    def extend(self, ik: np.ndarray, is_back: bool) -> np.ndarray:
        """ik: [..., 3] int64 rows (x0, x1, size) = (backward lo, forward lo, size).
        Returns ok: [..., 6, 3] for each next symbol, replicating the exact
        complement-order prefix sums of rld_extend (rld0.c:486-502)."""
        ik = np.asarray(ik, dtype=np.int64)
        prim = 0 if is_back else 1  # index of x[!is_back]
        sec = 1 - prim
        tk = self.rank1a(ik[..., prim])
        tl = self.rank1a(ik[..., prim] + ik[..., 2])
        sz = tl - tk  # [..., 6]
        ok = np.zeros(ik.shape[:-1] + (ASIZE, 3), dtype=np.int64)
        ok[..., :, prim] = self.acc[:ASIZE] + tk
        ok[..., :, 2] = sz
        o = ik[..., sec]
        for c, prev in ((0, None), (4, 0), (3, 4), (2, 3), (1, 2), (5, 1)):
            if prev is not None:
                o = o + sz[..., prev]
            ok[..., c, sec] = o
        return ok

    def set_intv(self, c: int) -> np.ndarray:
        """Initial bi-interval of single symbol c (fm-index.h:90-93)."""
        comp = 5 - c if 1 <= c <= 4 else c
        return np.array([self.acc[c], self.acc[comp], self.acc[c + 1] - self.acc[c]], dtype=np.int64)

    def is_symmetric(self) -> bool:
        a = self.acc
        return (a[1] & 1) == 0 and a[2] - a[1] == a[5] - a[4] and a[3] - a[2] == a[4] - a[3]

    # -- LF mapping --------------------------------------------------------
    def lf(self, k) -> tuple[np.ndarray, np.ndarray]:
        """Return (symbol at k, LF(k)) vectorized."""
        k = np.asarray(k, dtype=np.int64)
        ok = self.rank1a(k)
        c = self.bwt[k].astype(np.int64)
        return c, self.acc[c] + np.take_along_axis(ok, c[..., None], axis=-1)[..., 0]

    def retrieve(self, k: int) -> np.ndarray:
        """Decode the sequence whose sentinel-walk passes BWT position k
        (fm-index.c:552-567); returns nt6 codes (no sentinel).  Uses the
        native LF-walk (rb3t_retrieve) when available — the walk is a
        dependent chain, ~50x the scalar-numpy steps."""
        k = int(k)
        if k < 0 or k >= self.n:
            return np.zeros(0, dtype=np.uint8), -1
        try:
            from ..native import get_sw_lib

            lib = get_sw_lib()
        except Exception:
            lib = None
        if lib is not None:
            import ctypes

            out = np.empty(self.n, np.uint8)
            kend = ctypes.c_int64()
            P = ctypes.c_void_p
            ln = lib.rb3t_retrieve(
                P(self.bwt.ctypes.data), P(self.occ_block.ctypes.data), P(self.occ_super.ctypes.data),
                P(self.acc.ctypes.data), int(self.n), k, P(out.ctypes.data), int(self.n),
                ctypes.byref(kend),
            )
            return out[:ln][::-1].copy(), int(kend.value)
        out = []
        while True:
            c, nk = self.lf(np.array(k))
            c = int(c)
            if c == 0:
                break  # k stays at the sentinel-holding position, like the reference
            out.append(c)
            k = int(nk)
        return np.asarray(out[::-1], dtype=np.uint8), k
