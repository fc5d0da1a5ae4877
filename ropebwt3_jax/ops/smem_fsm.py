"""Engine-agnostic SMEM-TG lane state machine.

The FSM (phases START/BACK1/FWD/BACK2/DONE, see ops/smem.py docstring) is
parameterized over the extend/set_intv primitives so the same loop body runs
single-chip (ops/rank.py) and sharded under shard_map (parallel/mesh.py).
"""

from __future__ import annotations

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp

PH_START, PH_BACK1, PH_FWD, PH_BACK2, PH_DONE, PH_B2INIT = 0, 1, 2, 3, 4, 5


def emit(mems, n_mem, lane_mask, st, en, ik, seg=None):
    """Append (st, en, size, lo, lo_rc[, seg]) to masked lanes' buffers.

    Expressed as a one-hot select over the M axis rather than a scatter: a
    (Q, M, 5|6) elementwise select that streams at memory speed.  Called once
    per loop iteration."""
    Q, M, _ = mems.shape
    slot = jnp.minimum(n_mem, M - 1)
    cols = [st.astype(mems.dtype), en.astype(mems.dtype), ik[:, 2], ik[:, 0], ik[:, 1]]
    if seg is not None:
        cols.append(seg.astype(mems.dtype))
    row = jnp.stack(cols, axis=-1)
    sel = (jax.lax.broadcasted_iota(jnp.int32, (Q, M), 1) == slot[:, None]) & lane_mask[:, None]
    mems = jnp.where(sel[:, :, None], row[:, None, :], mems)
    # n_mem counts TRUE emits (may exceed M); hosts detect overflow and rerun
    n_mem = jnp.where(lane_mask, n_mem + 1, n_mem)
    return mems, n_mem


def smem_fsm(extend_all, set_intv_c, comp, q, qlen, dt, *, min_occ, min_len, max_mems, max_iters, unroll=1, seed_tab=None, seed_k=0, segments=None, extend_one=None, carry_sp=False, uniform_segments=None, return_parts=False):
    """Run the batched TG loop.

    extend_all(ik (Q,3), is_back (Q,)) -> (Q,6,3)
    extend_one(ik (Q,3), c (Q,), is_back (Q,)) -> (Q,3): optional single-
    symbol variant (ops/rank.extend_c) — bit-identical, ~3x less per-step
    traffic; preferred when provided.
    set_intv_c(c (Q,)) -> (Q,3)
    comp: (6,) complement table; q: (Q,L) int32; qlen: (Q,) int32.
    unroll: body steps per while-loop trip.  The body is a no-op for DONE
    lanes, so running a few extra steps after the last lane finishes is
    harmless; amortizing the `any(phase != DONE)` scalar reduction (a
    device-wide sync each trip) and letting XLA fuse elementwise chains
    across steps.
    seed_tab/seed_k: optional (4**k, 3) k-mer bi-interval table (ops/seed.py).
    Lanes entering BACK1 or BACK2 jump k-1 extends when the k-mer suffix of
    the window exists with size >= min_occ; all other cases (including every
    failure, whose position determines the restart point) run sequentially,
    so output is bit-identical with or without the table.  Requires
    seed_k <= min_len - 1.
    segments: optional (seg_off (Q,R) int32, seg_len (Q,R) int32, n_seg (Q,))
    packing several reads per lane (separated by >= 1 zero symbol in q).  A
    lane runs its reads back-to-back — per-read state fully resets at the
    boundary, so each read's trace is identical to the single-read kernel.
    Packing averages per-read iteration counts within a lane, shrinking the
    max-over-lanes tail that sets the loop trip count.  `qlen` is ignored;
    emitted rows gain a 6th column holding the segment id.
    uniform_segments: optional (stride (Q,), rlen (Q,), n_seg (Q,)) — the
    per-lane-UNIFORM packing variant: lane l holds n_seg[l] reads, all of
    length rlen[l], at offsets seg*stride[l].  off/qlen_cur become elementwise
    arithmetic on loop state instead of the per-iteration seg-record gather —
    one of the body's 3 gathers disappears, and the remaining dependent-gather chain shortens from
    seg->q->occf to q->occf.  Values are identical to the general packed path
    whenever both apply, so the trace (and output) is bit-identical.
    Returns (mems (Q,max_mems,5|6) dt, n_mem (Q,) int32, iters)."""
    Q, L = q.shape
    q_flat = q.reshape(-1)
    lane_base = jnp.arange(Q, dtype=jnp.int32) * L
    uniform = uniform_segments is not None
    if uniform:
        assert segments is None and not carry_sp
        u_stride, u_rlen, n_seg = uniform_segments
        u_stride = u_stride.astype(jnp.int32)
        u_rlen = u_rlen.astype(jnp.int32)
    packed = segments is not None or uniform
    if packed and not uniform:
        seg_off, seg_len, n_seg = segments
        R = seg_off.shape[1]
        # (off << 16 | len) packed per slot: ONE flat gather per iteration
        # resolves both (off < 32768 and len < 32768 for every lane class).
        # carry_sp=True instead rides the record in loop state and folds the
        # refresh into the symbol take (speculatively fetching slot seg and
        # seg+1; after that take the only possible advance is the FWD hit_end
        # +1, so a select suffices).  Off by default: it lost on the
        # previous accelerator; kept (equivalence-tested) until it is
        # measured on the current one.
        seg_pack_flat = ((seg_off.astype(jnp.int32) << 16) | seg_len.astype(jnp.int32)).reshape(-1)
        lane_rbase = jnp.arange(Q, dtype=jnp.int32) * R
        if carry_sp:
            # one flat array so q symbols and seg records share a single take
            cat_flat = jnp.concatenate([q_flat, seg_pack_flat])

    def qsym(pos):
        # flat 1-D take: the axis-0 gather lowering (take_along_axis can
        # pick a slower one inside loop bodies)
        p = jnp.clip(pos, 0, L - 1)
        return jnp.take(q_flat, lane_base + p)

    def qsym2(pa, pb):
        # both per-iteration symbol lookups in ONE gather op — each gather is
        # an XLA fusion break costing like a whole extra kernel dispatch
        pa = jnp.clip(pa, 0, L - 1)
        pb = jnp.clip(pb, 0, L - 1)
        s = jnp.take(q_flat, jnp.concatenate([lane_base + pa, lane_base + pb]))
        return s[:Q], s[Q:]

    use_seed = seed_tab is not None and seed_k > 0
    if use_seed:
        assert seed_k <= min_len - 1, (seed_k, min_len)
        from .seed import seed_keys

        kk, kv = seed_keys(q, jnp.full((Q,), L, jnp.int32) if packed else qlen, seed_k)
        keys_flat, valid_flat = kk.reshape(-1), kv.reshape(-1)
        # column-major flat layout so each column is a 1-D take (same
        # lowering concern as take_along_axis)
        nkeys = seed_tab.shape[0]
        tab_flat = seed_tab.T.reshape(-1)

        def seed_at(pos):
            """(interval (Q,3), usable (Q,)) for the k-mer at q[pos:pos+k]."""
            p = jnp.clip(pos, 0, L - 1)
            key = jnp.take(keys_flat, lane_base + p)
            ok = jnp.take(valid_flat, lane_base + p)
            key = jnp.clip(key, 0, nkeys - 1)
            cols = [jnp.take(tab_flat, key + c * nkeys) for c in range(3)]
            row = jnp.stack(cols, axis=-1)
            return row, ok & (cols[2] >= min_occ)

    state = dict(
        phase=jnp.full(Q, PH_START, jnp.int32),
        x=jnp.zeros(Q, jnp.int32),
        i=jnp.zeros(Q, jnp.int32),
        j=jnp.zeros(Q, jnp.int32),
        ik=jnp.zeros((Q, 3), dt),
        n_mem=jnp.zeros(Q, jnp.int32),
        mems=jnp.zeros((Q, max_mems, 6 if packed else 5), dt),
        it=jnp.zeros((), jnp.int32),
    )
    if packed:
        state["seg"] = jnp.zeros(Q, jnp.int32)
        if carry_sp:
            state["sp"] = jnp.take(seg_pack_flat, lane_rbase)  # record of seg 0

    def cond(s):
        return jnp.any(s["phase"] != PH_DONE) & (s["it"] < max_iters)

    def body(s):
        phase, x, i, j, ik = s["phase"], s["x"], s["i"], s["j"], s["ik"]
        mems, n_mem = s["mems"], s["n_mem"]
        if uniform:
            seg = s["seg"]
            off, qlen_cur = seg * u_stride, u_rlen  # no gather: per-lane arithmetic
        elif packed:
            seg = s["seg"]
            sp = s["sp"] if carry_sp else jnp.take(seg_pack_flat, lane_rbase + seg)
            off, qlen_cur = sp >> 16, sp & 0xFFFF
        else:
            off, qlen_cur = 0, qlen

        # ---- resolve (no rank) ------------------------------------------
        start = phase == PH_START
        fin = start & (qlen_cur - x < min_len)
        if packed:
            # advance to the lane's next read; it begins next iteration
            # (off/qlen_cur above are stale for these lanes, but they take no
            # other action this iteration)
            adv = fin & (seg + 1 < n_seg)
            seg = jnp.where(adv, seg + 1, seg)
            x = jnp.where(adv, 0, x)
            phase = jnp.where(fin & ~adv, PH_DONE, phase)
        else:
            phase = jnp.where(fin, PH_DONE, phase)
        begin = start & ~fin
        # one set_intv per iteration, shared by lanes starting a new window
        # (BACK1 entry) and lanes whose FWD extension failed last iteration
        # (PH_B2INIT, the deferred BACK2 entry: i was set to j-1 at fail time,
        # so the failing position j is i+1).  Deferring the BACK2 set_intv to
        # this resolve step is trace-identical — the failing iteration only
        # did state setup after its emit — and halves the per-iteration
        # set_intv/q-gather count.
        b2i = phase == PH_B2INIT
        sv_pos = jnp.where(begin, x + min_len - 1, i + 1)
        need_sv = begin | b2i
        phase = jnp.where(b2i, PH_BACK2, phase)
        i = jnp.where(begin, x + min_len - 2, i)
        phase = jnp.where(begin, PH_BACK1, phase)
        if use_seed:
            # seed jumps modify ik/i before the extend, so the set_intv must
            # be applied here (the seed path forgoes the merged qsym2 gather)
            ik = jnp.where(need_sv[:, None], set_intv_c(qsym(off + sv_pos)).astype(dt), ik)
            srow, sok = seed_at(off + x + min_len - seed_k)
            jump = begin & sok
            ik = jnp.where(jump[:, None], srow.astype(dt), ik)
            i = jnp.where(jump, x + min_len - 1 - seed_k, i)
            # BACK2 entry jump (deferred with the set_intv): safe only when
            # the k-1 covered steps cannot hit the i <= x stop; intermediate
            # extends all succeed (supersets of the k-mer interval)
            srow2, sok2 = seed_at(off + i + 2 - seed_k)
            jump2 = b2i & sok2 & (i - seed_k + 2 > x)
            ik = jnp.where(jump2[:, None], srow2.astype(dt), ik)
            i = jnp.where(jump2, i + 1 - seed_k, i)
        skip = (phase == PH_BACK1) & (i < x)
        j = jnp.where(skip, x + min_len, j)
        phase = jnp.where(skip, PH_FWD, phase)
        fwd_end = (phase == PH_FWD) & (j >= qlen_cur)
        # buffered emit: at most one per lane per iteration, applied at the end
        # (emit_ik is snapshotted after the deferred set_intv below — at
        # min_len=1 a begin lane can skip straight to FWD and emit here)
        emit_mask, emit_st, emit_en = fwd_end, x, qlen_cur
        emit_seg = seg if packed else None  # the emitting read's id (pre-advance)
        phase = jnp.where(fwd_end, PH_DONE, phase)
        if packed:
            # a finished read hands the lane back to START for the next one
            nxt = fwd_end & (seg + 1 < n_seg)
            seg = jnp.where(nxt, seg + 1, seg)
            x = jnp.where(nxt, 0, x)
            phase = jnp.where(nxt, PH_START, phase)
        b2_end = (phase == PH_BACK2) & (i <= x)
        x = jnp.where(b2_end, i + 1, x)
        phase = jnp.where(b2_end, PH_START, phase)

        # ---- one batched extend -----------------------------------------
        back = phase != PH_FWD
        b1 = phase == PH_BACK1
        b2 = phase == PH_BACK2
        fw = phase == PH_FWD
        active = b1 | b2 | fw
        pos = jnp.where(fw, j, i)
        sp0 = sp1 = None
        if use_seed:
            craw = qsym(off + pos)
        elif packed and carry_sp:
            # ONE take resolves the two symbol lookups AND the seg-record
            # refresh: seg here already includes every resolve-step advance,
            # and the only advance still possible this iteration is the FWD
            # hit_end +1, handled by selecting sp1 below.  (The deferred
            # set_intv sharing is as in the unpacked branch.)
            pa = jnp.clip(off + pos, 0, L - 1)
            pb = jnp.clip(off + sv_pos, 0, L - 1)
            QL = jnp.int32(Q * L)
            seg_i = lane_rbase + seg
            seg_i1 = lane_rbase + jnp.minimum(seg + 1, R - 1)
            v = jnp.take(cat_flat, jnp.concatenate([lane_base + pa, lane_base + pb, QL + seg_i, QL + seg_i1]))
            craw, svsym, sp0, sp1 = v[:Q], v[Q : 2 * Q], v[2 * Q : 3 * Q], v[3 * Q :]
            ik = jnp.where(need_sv[:, None], set_intv_c(svsym).astype(dt), ik)
        else:
            # the deferred set_intv (PH_B2INIT/begin) shares one gather with
            # the extend-symbol lookup; applying it here is safe — nothing
            # between the resolve block and this point reads ik of a need_sv
            # lane (their phases are disjoint from the emit/skip paths)
            craw, svsym = qsym2(off + pos, off + sv_pos)
            ik = jnp.where(need_sv[:, None], set_intv_c(svsym).astype(dt), ik)
        emit_ik = ik
        # nt6 complement (= the comp table [0,4,3,2,1,5]) as arithmetic — a
        # 6-entry table gather would break fusion inside the loop body
        c = jnp.where(fw, jnp.where(craw % 5 == 0, craw, 5 - craw), craw)
        safe_ik = jnp.where(active[:, None], ik, jnp.zeros_like(ik))
        if extend_one is not None:
            ok_c = extend_one(safe_ik, c, back)
        else:
            ok_all = extend_all(safe_ik, back)
            # per-lane symbol row select via masked sum (avoids a slow gather)
            sel = (jax.lax.broadcasted_iota(jnp.int32, (Q, 6), 1) == c[:, None]).astype(ok_all.dtype)
            ok_c = jnp.sum(ok_all * sel[:, :, None], axis=1, dtype=ok_all.dtype)
        succ = ok_c[:, 2] >= min_occ

        # BACK1
        m = b1 & succ
        ik = jnp.where(m[:, None], ok_c, ik)
        i = jnp.where(m, i - 1, i)
        to_fwd = m & (i < x)
        j = jnp.where(to_fwd, x + min_len, j)
        phase = jnp.where(to_fwd, PH_FWD, phase)
        m = b1 & ~succ
        x = jnp.where(m, i + 1, x)
        phase = jnp.where(m, PH_START, phase)

        # FWD
        m = fw & succ
        ik = jnp.where(m[:, None], ok_c, ik)
        j = jnp.where(m, j + 1, j)
        hit_end = m & (j >= qlen_cur)
        phase = jnp.where(hit_end, PH_DONE, phase)
        m = fw & ~succ
        both = hit_end | m
        emit_mask = emit_mask | both
        emit_st = jnp.where(both, x, emit_st)
        emit_en = jnp.where(hit_end, qlen_cur, jnp.where(m, j, emit_en))
        emit_ik = jnp.where(both[:, None], ik, emit_ik)
        if packed:
            nxt = hit_end & (seg + 1 < n_seg)
            seg = jnp.where(nxt, seg + 1, seg)
            x = jnp.where(nxt, 0, x)
            phase = jnp.where(nxt, PH_START, phase)
            if carry_sp:
                if sp0 is not None:  # refresh the carried record (fused take)
                    sp = jnp.where(nxt, sp1, sp0)
                else:  # seed path: plain re-gather at the final seg
                    sp = jnp.take(seg_pack_flat, lane_rbase + seg)
        # BACK2 entry (ik = set_intv at the failing position) is deferred to
        # the next iteration's resolve step — see PH_B2INIT above
        i = jnp.where(m, j - 1, i)
        phase = jnp.where(m, PH_B2INIT, phase)

        # BACK2
        m = b2 & succ
        ik = jnp.where(m[:, None], ok_c, ik)
        i = jnp.where(m, i - 1, i)
        fell = m & (i <= x)
        x = jnp.where(fell, i + 1, x)
        phase = jnp.where(fell, PH_START, phase)
        m = b2 & ~succ
        x = jnp.where(m, i + 1, x)
        phase = jnp.where(m, PH_START, phase)

        mems, n_mem = emit(mems, n_mem, emit_mask, emit_st, emit_en, emit_ik, emit_seg)
        out = dict(phase=phase, x=x, i=i, j=j, ik=ik, n_mem=n_mem, mems=mems, it=s["it"] + 1)
        if packed:
            out["seg"] = seg
            if carry_sp:
                out["sp"] = sp
        return out

    if return_parts:
        # building blocks for multi-population loops (smem_fsm_dual): the
        # caller composes states/bodies into one while_loop
        return state, body

    if unroll > 1:
        def outer(s):
            for _ in range(unroll):
                s = body(s)
            return s
    else:
        outer = body
    out = jax.lax.while_loop(cond, outer, state)
    return out["mems"], out["n_mem"], out["it"]


def smem_fsm_dual(parts_a, parts_b, max_iters, unroll=1):
    """Run TWO independent lane populations in ONE while_loop.

    parts_* = (state, body) from smem_fsm(..., return_parts=True).  Each trip
    applies both bodies: the per-trip fixed cost (the `any` device-wide
    reduction + loop machinery) amortizes over two populations, and the two
    bodies' gathers are independent so XLA may interleave them.  Each
    population's trace is untouched — a population whose lanes are all DONE
    no-ops (its body is phase-gated) while the other finishes, so outputs are
    bit-identical to two separate smem_fsm runs.
    Returns ((mems_a, n_mem_a), (mems_b, n_mem_b), iters)."""
    state_a, body_a = parts_a
    state_b, body_b = parts_b

    def cond(s):
        a, b = s
        live = jnp.any(a["phase"] != PH_DONE) | jnp.any(b["phase"] != PH_DONE)
        return live & (a["it"] < max_iters)

    def outer(s):
        a, b = s
        for _ in range(unroll):
            a = body_a(a)
            b = body_b(b)
        return (a, b)

    a, b = jax.lax.while_loop(cond, outer, (state_a, state_b))
    return (a["mems"], a["n_mem"]), (b["mems"], b["n_mem"]), a["it"]
