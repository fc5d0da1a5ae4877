"""Batched BWT merge — Algorithm 2 of the ropebwt3 paper, re-formulated.

The reference computes, for every symbol of the new partial BWT B2, its
insertion rank into the existing BWT B1 via per-sequence LF-loops
(fm-index.c:143-175), then *inserts* symbols one-by-one into a B+-tree
(fm-index.c:237-249).  Here the rank phase is a **batched LF-walk** — one lane
per sequence of B2, each step doing a vectorized rank gather on B1 and an O(1)
LF lookup on B2 — and the insert phase is a **stable counting merge / scatter**
that rebuilds the dense BWT array directly (no tree).  Both phases are
embarrassingly data-parallel: the native engine runs the walks as
interleaved host state machines, and the same batched rank the queries use
runs them on the device when asked for.
"""

from __future__ import annotations

import numpy as np

from ..index.dense import ASIZE, DenseFMIndex


def lf2_table(seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For a plain BWT `seq` (uint8), return (acc2[7], lf2[n]) where
    lf2[i] = acc2[seq[i]] + occ(seq[i], i) — cf. rb3_mg_rank_plain
    (fm-index.c:202-215)."""
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = len(seq)
    try:
        import ctypes

        from ..native import get_sw_lib

        lib = get_sw_lib()
        if lib is not None:
            acc2 = np.zeros(ASIZE + 1, dtype=np.int64)
            lf2 = np.empty(n, dtype=np.int64)
            lib.rb3t_lf2(
                ctypes.c_void_p(seq.ctypes.data), n,
                ctypes.c_void_p(acc2.ctypes.data), ctypes.c_void_p(lf2.ctypes.data),
            )
            return acc2, lf2
    except Exception:
        pass
    cnt = np.bincount(seq, minlength=ASIZE).astype(np.int64)
    acc2 = np.zeros(ASIZE + 1, dtype=np.int64)
    acc2[1:] = np.cumsum(cnt)
    # occ-before for each position of its own symbol: per-symbol counting
    # (6 masked passes beat a 64M stable argsort by ~25x)
    within = np.empty(n, dtype=np.int64)
    for c in range(ASIZE):
        m = np.flatnonzero(seq == c)
        within[m] = np.arange(len(m), dtype=np.int64)
    lf2 = acc2[seq.astype(np.int64)] + within
    return acc2, lf2


def merge_rank_plain(fa: DenseFMIndex, seq: np.ndarray, step_cb=None) -> tuple[np.ndarray, np.ndarray]:
    """Compute insertion ranks of every symbol of partial BWT `seq` into `fa`.

    Returns (acc2, ins) where ins[i] (int64) is the number of B1 symbols that
    precede B2 position i in the merged BWT; the merged position of B2[i] is
    ins[i] + i.  Batched across all m2 sequences of B2 (lanes), sequential in
    sequence length only.
    """
    acc2, lf2 = lf2_table(seq)
    n2 = len(seq)
    m2 = int(acc2[1])  # number of sentinels = sequences in B2
    ins = np.empty(n2, dtype=np.int64)
    if n2 == 0:
        return acc2, ins
    ka = np.full(m2, fa.acc[1], dtype=np.int64)  # insertion pos into B1
    kb = np.arange(m2, dtype=np.int64)  # current B2 position per lane
    active = np.ones(m2, dtype=bool)
    seq64 = seq.astype(np.int64)
    while active.any():
        idx = np.flatnonzero(active)
        kb_a, ka_a = kb[idx], ka[idx]
        c = seq64[kb_a]
        ins[kb_a] = ka_a
        alive = c != 0
        if not alive.any():
            active[idx] = False
            break
        idx2 = idx[alive]
        c2 = c[alive]
        kb[idx2] = lf2[kb[idx2]]
        oa = fa.rank1a(ka[idx2])
        ka[idx2] = fa.acc[c2] + np.take_along_axis(oa, c2[:, None], axis=-1)[:, 0]
        active[idx[~alive]] = False
        if step_cb is not None:
            step_cb(int(alive.sum()))
    return acc2, ins


def _mg_window_fn():
    """Module-level jitted window kernel (built lazily so importing this
    module never touches JAX)."""
    from .. import _jax_setup

    _jax_setup()
    import functools

    import jax
    import jax.numpy as jnp

    from ..ops.rank import rank1a

    @functools.partial(jax.jit, static_argnames=("W",))
    def window(idx, seq_d, lf2_d, ka, kb, alive, W):
        m2 = ka.shape[0]
        dt = ka.dtype

        def step(t, st):
            ka, kb, alive, kbuf, abuf = st
            kbuf = jax.lax.dynamic_update_index_in_dim(kbuf, kb, t, 0)
            abuf = jax.lax.dynamic_update_index_in_dim(abuf, ka, t, 0)
            c = jnp.take(seq_d, kb)
            oa = rank1a(idx, ka)
            sel = (jax.lax.broadcasted_iota(jnp.int32, (m2, 6), 1) == c[:, None]).astype(dt)
            oc = jnp.sum(oa * sel, axis=1, dtype=dt)
            alive2 = alive & (c != 0)
            ka = jnp.where(alive2, jnp.take(idx.acc, c) + oc, ka)
            kb = jnp.where(alive2, jnp.take(lf2_d, kb), kb)
            return ka, kb, alive2, kbuf, abuf

        kbuf = jnp.zeros((W, m2), kb.dtype)
        abuf = jnp.zeros((W, m2), dt)
        return jax.lax.fori_loop(0, W, step, (ka, kb, alive, kbuf, abuf))

    return window


def merge_rank_device(fa: DenseFMIndex, seq: np.ndarray, window: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Device-batched variant of merge_rank_plain: one vectorized rank gather
    on B1 per step, all m2 sequence walks in lock-step lanes (the device
    analog of kt_for(worker_cal_rank), fm-index.c:189-200).

    The (kb, ka) trajectory is recorded into (W, m2) window buffers on device
    and applied to `ins` with numpy fancy assignment on host instead of a
    per-step device scatter.  Lanes that die keep re-recording their final
    identical pair, which overwrites harmlessly."""
    from .. import require_device

    require_device()
    import jax.numpy as jnp

    from ..ops.rank import DeviceIndex

    acc2, lf2 = lf2_table(seq)
    n2 = len(seq)
    m2 = int(acc2[1])
    idx = DeviceIndex.from_dense(fa)
    dt = idx.idx_dtype
    seq_d = jnp.asarray(seq.astype(np.int32))
    lf2_d = jnp.asarray(lf2.astype(np.int32 if dt == jnp.int32 else np.int64))
    window_fn = _mg_window_fn()
    W = int(window) if window else int(max(256, min(65536, (16 << 20) // max(1, m2))))
    ka = jnp.full((m2,), int(fa.acc[1]), dt)
    kb = jnp.arange(m2, dtype=lf2_d.dtype)
    alive = jnp.ones((m2,), jnp.bool_)
    ins = np.zeros(n2, dtype=np.int64)
    while True:
        ka, kb, alive, kbuf, abuf = window_fn(idx, seq_d, lf2_d, ka, kb, alive, W)
        ins[np.asarray(kbuf).ravel()] = np.asarray(abuf).ravel()
        if not bool(np.asarray(jnp.any(alive))):
            break
    return acc2, ins


def merge_rank_native(fa: DenseFMIndex, seq: np.ndarray, n_threads: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Native (C++) merge_rank_plain: interleaved prefetching LF-walk state
    machines over the dense tables (bwasw_core.cpp), the host analog of
    kt_for(worker_cal_rank) fm-index.c:189-200.  Uses the packed-record walk:
    rec[i] = (lf2[i]<<3)|seq[i] is consumed exactly once per B2 position and
    overwritten in place with the insertion rank, so the B2 side costs one
    random cache line per step.  Bit-identical to merge_rank_plain."""
    import ctypes
    import os

    from ..native import get_sw_lib

    lib = get_sw_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n2 = len(seq)
    P = ctypes.c_void_p
    acc2 = np.zeros(ASIZE + 1, dtype=np.int64)
    rec = np.empty(n2, dtype=np.int64)
    if n2 == 0:
        return acc2, rec
    lib.rb3t_lf2_packed(P(seq.ctypes.data), n2, P(acc2.ctypes.data), P(rec.ctypes.data))
    m2 = int(acc2[1])
    nt = n_threads or min(os.cpu_count() or 1, max(1, m2))
    lib.rb3t_merge_rank_packed(
        P(fa.bwt.ctypes.data), P(fa.occ_block.ctypes.data), P(fa.occ_super.ctypes.data),
        P(fa.acc.ctypes.data), int(fa.n), P(rec.ctypes.data), n2, m2, int(nt),
    )
    return acc2, rec


def merge_plain(fa: DenseFMIndex, seq: np.ndarray, engine: str = "auto", mesh=None) -> DenseFMIndex:
    """Merge a plain partial BWT `seq` (B2) into dense index `fa` (B1) and
    return the merged dense index. Stable counting merge replaces the rope
    insertion of rb3_fmi_merge_plain (fm-index.c:279-303).

    mesh: a (dp, idx) jax Mesh — the rank phase then runs sharded (LF lanes
    over dp, occ rows over idx; parallel/merge_sharded.py)."""
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    if mesh is not None:
        from ..parallel.merge_sharded import merge_rank_sharded

        _, ins = merge_rank_sharded(fa, seq, mesh)
        return _merge_apply(fa, seq, ins)
    if engine in ("auto", "native"):
        from ..native import get_sw_lib

        if get_sw_lib() is not None:
            _, ins = merge_rank_native(fa, seq)
            return _merge_apply(fa, seq, ins)
        if engine == "native":
            raise RuntimeError("native engine unavailable")
    if engine == "device":  # only when asked for; its failure is an error
        _, ins = merge_rank_device(fa, seq)
    else:
        _, ins = merge_rank_plain(fa, seq)
    return _merge_apply(fa, seq, ins)


def _merge_apply(fa: DenseFMIndex, seq: np.ndarray, ins: np.ndarray) -> DenseFMIndex:
    n1, n2 = fa.n, len(seq)
    try:
        import ctypes

        from ..native import get_sw_lib

        lib = get_sw_lib()
        if lib is not None:
            merged = np.empty(n1 + n2, dtype=np.uint8)
            bwt1 = np.ascontiguousarray(fa.bwt[:n1])
            lib.rb3t_merge_apply(
                ctypes.c_void_p(bwt1.ctypes.data), n1,
                ctypes.c_void_p(seq.ctypes.data), ctypes.c_void_p(ins.ctypes.data),
                n2, ctypes.c_void_p(merged.ctypes.data),
            )
            return DenseFMIndex.from_bwt(merged)
    except Exception:
        pass
    merged = np.empty(n1 + n2, dtype=np.uint8)
    pos2 = ins + np.arange(n2, dtype=np.int64)  # merged positions of B2 symbols
    mask = np.ones(n1 + n2, dtype=bool)
    mask[pos2] = False
    merged[pos2] = seq
    merged[mask] = fa.bwt[:n1]
    return DenseFMIndex.from_bwt(merged)
