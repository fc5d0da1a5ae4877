"""Sampled-suffix-array generation and locate.

Generation (cf. rb3_ssa_gen, ssa.c:17-81) is a full LF-walk of every sequence;
here it is a *batched* LF-walk — all m sequences advance in lock-step with one
vectorized rank gather per step — the same access pattern as the merge-rank
kernel, so the device path reuses the batched rank primitive.

Locate: single-position rb3_ssa (ssa.c:93-112) and the heap-driven multi
locate rb3_ssa_multi (ssa.c:158-192), expected O(s/m) per position on
redundant collections.
"""

from __future__ import annotations

import numpy as np

from .formats.ssa import SSA
from .index.dense import DenseFMIndex


def ssa_gen_native(f: DenseFMIndex, ssa_shift: int = 8, n_threads: int | None = None) -> SSA:
    """Native (C++) ssa_gen: interleaved prefetching LF-walk state machines
    (rb3t_ssa_gen in bwasw_core.cpp), bit-identical to ssa_gen."""
    import ctypes
    import os

    from .native import get_sw_lib

    lib = get_sw_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    m = int(f.acc[1])
    ms = 1
    while (1 << ms) < m:
        ms += 1
    n_ssa = (int(f.acc[6]) - m + (1 << ssa_shift) - 1) >> ssa_shift
    r2i = np.zeros(m, dtype=np.uint64)
    ssa = np.zeros(n_ssa, dtype=np.uint64)
    if m:
        P = ctypes.c_void_p
        nt = n_threads or min(os.cpu_count() or 1, max(1, m))
        lib.rb3t_ssa_gen(
            P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data),
            P(f.acc.ctypes.data), int(f.n), m, ssa_shift, ms,
            P(r2i.ctypes.data), P(ssa.ctypes.data), int(nt),
        )
    return SSA(ssa_shift, ms, m, r2i, ssa)


def ssa_gen(f: DenseFMIndex, ssa_shift: int = 8, batch: int = 1 << 15) -> SSA:
    m = int(f.acc[1])
    ms = 1
    while (1 << ms) < m:
        ms += 1
    n_ssa = (int(f.acc[6]) - m + (1 << ssa_shift) - 1) >> ssa_shift
    mask = (1 << ssa_shift) - 1
    r2i = np.zeros(m, dtype=np.uint64)
    ssa = np.zeros(n_ssa, dtype=np.uint64)
    n0 = m  # f.acc[1]
    for b0 in range(0, m, batch):
        k0 = np.arange(b0, min(b0 + batch, m), dtype=np.int64)
        k = k0.copy()
        active = np.ones(len(k0), dtype=bool)
        l = 0
        # per-lane records of sampled ranks visited: store (x, l) pairs
        rec_x: list[np.ndarray] = []
        rec_l: list[np.ndarray] = []
        rec_lane: list[np.ndarray] = []
        seq_len = np.zeros(len(k0), dtype=np.int64)
        while active.any():
            idx = np.flatnonzero(active)
            l += 1
            c, nk = f.lf(k[idx])
            k[idx] = nk
            nz = c != 0
            # sampled-position hits among still-walking lanes
            hit = nz & (((nk - n0) & mask) == 0)
            if hit.any():
                rec_x.append(((nk[hit] - n0) >> ssa_shift).astype(np.int64))
                rec_l.append(np.full(int(hit.sum()), l, dtype=np.int64))
                rec_lane.append(idx[hit])
            done = ~nz
            if done.any():
                lanes = idx[done]
                r2i[nk[done]] = k0[lanes].astype(np.uint64)
                seq_len[lanes] = l - 1
                active[lanes] = False
        if rec_x:
            X = np.concatenate(rec_x)
            L = np.concatenate(rec_l)
            LN = np.concatenate(rec_lane)
            off = seq_len[LN] - L
            ssa[X] = ((off.astype(np.uint64)) << np.uint64(ms)) | k0[LN].astype(np.uint64)
    return SSA(ssa_shift, ms, m, r2i, ssa)


def ssa_gen_device(f: DenseFMIndex, ssa_shift: int = 8, mesh=None) -> SSA:
    """Device-batched SSA generation: all m sequence LF-walks advance in
    lock-step lanes with one vectorized rank per step (device analog of the
    kt_for in rb3_ssa_gen, ssa.c:54-81).  Produces byte-identical SSA.

    With `mesh`, lanes shard over the dp axis via shard_map (tables
    replicated): each shard runs its own while_loop to ITS lanes' death —
    no lock-step across shards — and the per-shard scatter buffers combine
    with one pmax at the end (every SSA slot has exactly one writer
    globally, so max over {-1/0, value} reconstitutes the full array)."""
    from . import _jax_setup

    _jax_setup()
    import jax
    import jax.numpy as jnp

    from .ops.rank import DeviceIndex, rank1a

    m = int(f.acc[1])
    ms = 1
    while (1 << ms) < m:
        ms += 1
    n_ssa = (int(f.acc[6]) - m + (1 << ssa_shift) - 1) >> ssa_shift
    mask = (1 << ssa_shift) - 1
    idx = DeviceIndex.from_dense(f)
    dt = idx.idx_dtype
    n0 = m
    bwt_sym = jnp.asarray(f.bwt[: f.n])  # symbol-at-k lookups

    def mk_body(ix, bwt):
        def body(state):
            k, alive, l, ssa_l, ssa_lane, death_l, final_k, lane_ids = state
            c = jnp.take(bwt, k).astype(jnp.int32)
            ok = rank1a(ix, k)
            sel = (jax.lax.broadcasted_iota(jnp.int32, (k.shape[0], 6), 1) == c[:, None]).astype(dt)
            occ_c = jnp.sum(ok * sel, axis=1, dtype=dt)
            nk = jnp.take(ix.acc, c) + occ_c
            l = l + 1
            nz = c != 0
            hit = alive & nz & (((nk - n0) & mask) == 0)
            # non-hit lanes scatter into a dummy slot (n_ssa) so
            # duplicate-index write order can never clobber a real hit
            x = jnp.where(hit, (nk - n0) >> ssa_shift, n_ssa)
            ssa_l = ssa_l.at[x].set(l)
            ssa_lane = ssa_lane.at[x].set(lane_ids)
            died = alive & ~nz
            death_l = jnp.where(died, l, death_l)
            final_k = jnp.where(died, nk, final_k)
            alive2 = alive & nz
            k = jnp.where(alive2, nk, k)
            return k, alive2, l, ssa_l, ssa_lane, death_l, final_k, lane_ids

        return body

    def init_state(k0, alive0, lane_ids):
        return (
            k0,
            alive0,
            jnp.zeros((), jnp.int32),
            jnp.zeros((n_ssa + 1,), jnp.int32),
            jnp.full((n_ssa + 1,), -1, jnp.int32),
            jnp.zeros(k0.shape, jnp.int32),
            jnp.zeros(k0.shape, dt),
            lane_ids,
        )

    if mesh is None:
        state = init_state(jnp.arange(m, dtype=dt), jnp.ones((m,), jnp.bool_), jnp.arange(m, dtype=jnp.int32))
        state = jax.lax.while_loop(lambda s: jnp.any(s[1]), mk_body(idx, bwt_sym), state)
        _, _, _, ssa_l, ssa_lane, death_l, final_k, _ = (np.asarray(s) for s in state)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        dp = mesh.shape["dp"]
        mp = -(-m // dp) * dp  # pad lanes are born dead and slice off below
        k0 = np.zeros(mp, dtype=np.int64 if dt == jnp.int64 else np.int32)
        k0[:m] = np.arange(m)
        alive0 = np.zeros(mp, bool)
        alive0[:m] = True
        lids = np.arange(mp, dtype=np.int32)
        rep = NamedSharding(mesh, P())
        idx_r, bwt_r = jax.device_put(idx, rep), jax.device_put(bwt_sym, rep)

        def shard_fn(ix, bwt, k0s, a0s, lid_s):
            st = init_state(k0s, a0s, lid_s)
            st = jax.lax.while_loop(lambda s: jnp.any(s[1]), mk_body(ix, bwt), st)
            _, _, _, ssa_l, ssa_lane, death_l, final_k, _ = st
            # one writer per slot globally: pmax over {0/-1, value} merges
            return jax.lax.pmax(ssa_l, "dp"), jax.lax.pmax(ssa_lane, "dp"), death_l, final_k

        fn = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P("dp"), P("dp"), P("dp")),
            out_specs=(P(), P(), P("dp"), P("dp")),
            check_vma=False,
        )
        from .parallel.launch import to_host

        # to_host: np.asarray single-process; allgather when the mesh spans
        # multiple jax.distributed processes (dp-sharded outputs)
        ssa_l, ssa_lane, death_l, final_k = (to_host(x) for x in fn(idx_r, bwt_r, k0, alive0, lids))
        death_l, final_k = death_l[:m], final_k[:m]
    ssa_l, ssa_lane = ssa_l[:n_ssa], ssa_lane[:n_ssa]
    r2i = np.zeros(m, dtype=np.uint64)
    r2i[final_k] = np.arange(m, dtype=np.uint64)
    ssa = np.zeros(n_ssa, dtype=np.uint64)
    filled = ssa_lane >= 0
    lanes = ssa_lane[filled].astype(np.int64)
    offs = (death_l[lanes] - 1 - ssa_l[filled]).astype(np.uint64)
    ssa[filled] = (offs << np.uint64(ms)) | lanes.astype(np.uint64)
    return SSA(ssa_shift, ms, m, r2i, ssa)


def ssa_lookup1(f: DenseFMIndex, sa: SSA, k: int) -> tuple[int, int]:
    """Return (pos, sid) for BWT position k (rb3_ssa). pos==-1 on failure."""
    mask = (1 << sa.ss) - 1
    x = 0
    n0 = int(f.acc[1])
    if k >= int(f.acc[6]):
        return -1, -1
    while k < n0 or ((k - n0) & mask):
        x += 1
        c, nk = f.lf(np.array(int(k)))
        c, k = int(c), int(nk)
        if c == 0:
            return x - 1, int(sa.r2i[k])
    e = int(sa.ssa[(k - n0) >> sa.ss])
    sid = e & ((1 << sa.ms) - 1)
    return x + (e >> sa.ms), sid


def ssa_multi_batch(f: DenseFMIndex, sa: SSA, reqs: list[tuple[int, int, int]], n_threads: int = 0) -> list[list[tuple[int, int]]] | None:
    """Native batched multi-locate: reqs = [(lo, hi, max_sa), ...] -> per-req
    (sid, pos) lists, byte-identical to ssa_multi.  None if the native
    library is unavailable (callers fall back to the Python path)."""
    from .native import get_sw_lib

    lib = get_sw_lib()
    if lib is None or not reqs:
        return None if lib is None else []
    import ctypes
    import os

    n_req = len(reqs)
    lo = np.fromiter((r[0] for r in reqs), np.int64, n_req)
    hi = np.fromiter((r[1] for r in reqs), np.int64, n_req)
    cap = np.fromiter((max(0, min(r[2], r[1] - r[0])) for r in reqs), np.int64, n_req)
    off = np.zeros(n_req + 1, np.int64)
    np.cumsum(cap, out=off[1:])
    out_sid = np.empty(int(off[-1]), np.int64)
    out_pos = np.empty(int(off[-1]), np.int64)
    n_out = np.zeros(n_req, np.int64)
    P = ctypes.c_void_p

    def _pline():
        from .align.bwasw import _pline_arg

        return _pline_arg(f)

    lib.rb3t_ssa_multi_batch(
        P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data), P(f.acc.ctypes.data),
        int(f.n), int(sa.ss), int(sa.ms), P(sa.r2i.ctypes.data), P(sa.ssa.ctypes.data), n_req,
        P(lo.ctypes.data), P(hi.ctypes.data), P(cap.ctypes.data), P(off.ctypes.data),
        P(out_sid.ctypes.data), P(out_pos.ctypes.data), P(n_out.ctypes.data),
        int(n_threads) or (os.cpu_count() or 1), _pline(),
    )
    out = []
    sid_l, pos_l = out_sid.tolist(), out_pos.tolist()
    for r in range(n_req):
        o0, o1 = int(off[r]), int(off[r]) + int(n_out[r])
        out.append(list(zip(sid_l[o0:o1], pos_l[o0:o1])))
    return out


def ssa_multi(f: DenseFMIndex, sa: SSA, lo: int, hi: int, max_sa: int) -> list[tuple[int, int]]:
    """Positions of up to max_sa suffixes in SA interval [lo, hi): list of
    (sid, pos). Mirrors rb3_ssa_multi including its traversal order.
    Dispatches to the native batched core when available."""
    got = ssa_multi_batch(f, sa, [(lo, hi, max_sa)])
    if got is not None:
        return got[0]
    return ssa_multi_py(f, sa, lo, hi, max_sa)


def ssa_multi_py(f: DenseFMIndex, sa: SSA, lo: int, hi: int, max_sa: int) -> list[tuple[int, int]]:
    """Pure-Python reference implementation of rb3_ssa_multi.

    Precondition (as in the reference, ssa.c:158-192): lo >= acc[1] — SA
    intervals of non-empty queries never start in the sentinel rows, and the
    recursion only produces lo = acc[c] + ok[c] with c >= 1.  Below that the
    sampled-entry index (k - n0) >> ss goes negative (UB in the C twins)."""
    if max_sa == 0 or lo >= hi:
        return []
    out: list[tuple[int, int]] = []
    max_sa = min(max_sa, hi - lo)
    n0 = int(f.acc[1])
    msk_sid = (1 << sa.ms) - 1
    # exact replica of the klib binary max-heap on interval size (ksort.h:38-59)
    # so that tie order — and thus which positions are reported under the
    # max_sa cap — matches the reference byte-for-byte.
    heap: list[tuple[int, int, int]] = []  # (lo, hi, off), keyed by hi-lo

    def _lt(a, b) -> bool:
        return a[1] - a[0] < b[1] - b[0]

    def _heapup():
        k = len(heap) - 1
        tmp = heap[k]
        while k:
            i = (k - 1) >> 1
            if _lt(tmp, heap[i]):
                break
            heap[k] = heap[i]
            k = i
        heap[k] = tmp

    def _heapdown(i: int, n: int):
        k = i
        tmp = heap[i]
        while True:
            k = (k << 1) + 1
            if k >= n:
                break
            if k != n - 1 and _lt(heap[k], heap[k + 1]):
                k += 1
            if _lt(heap[k], tmp):
                break
            heap[i] = heap[k]
            i = k
        heap[i] = tmp

    def add_intv(lo: int, hi: int, off: int) -> bool:
        """Harvest sampled entries inside [lo,hi); push leftover subintervals.
        Returns False once out is full (mirrors ssa_add_intv, ssa.c:138-156)."""
        if len(out) == max_sa:
            return False
        k = ((lo - n0) >> sa.ss << sa.ss) + n0
        while k < hi:
            if k >= lo:
                e = int(sa.ssa[(k - n0) >> sa.ss])
                out.append((e & msk_sid, off + (e >> sa.ms)))
                if len(out) == max_sa:
                    return False
                if lo < k:
                    heap.append((lo, k, off))
                    _heapup()
                lo = k + 1
            k += 1 << sa.ss
        heap.append((lo, hi, off))
        _heapup()
        return True

    add_intv(lo, hi, 0)
    while heap and len(out) < max_sa:
        xlo, xhi, off = heap[0]
        last = heap.pop()
        if heap:
            heap[0] = last
            _heapdown(0, len(heap))
        ok = f.rank1a(np.array(xlo))
        ol = f.rank1a(np.array(xhi))
        for l in range(int(ok[0]), int(ol[0])):  # sentinels reached
            out.append((int(sa.r2i[l]), off))
            if len(out) == max_sa:
                return out
        for c in range(1, 6):
            if ok[c] < ol[c]:
                if not add_intv(int(f.acc[c] + ok[c]), int(f.acc[c] + ol[c]), off + 1):
                    return out
    return out
