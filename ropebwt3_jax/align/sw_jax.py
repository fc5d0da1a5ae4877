"""Device BWA-SW scoring: lock-step sw_core over general prefix DAWGs.

Generalizes the linear-chain hapdiv kernel (align/hapdiv_jax.py) to the full
`sw` PAF path (sw_core, bwa-sw.c:329-526): nodes may have MULTIPLE
predecessor rows (prefix DAWG, dawg.c:109-228), the ks_ksmall row-count prune
applies (bwa-sw.c:366-376), and every node's top-N row is archived so the
existing host backtrack (align/bwasw.sw_backtrack) produces the PAF/e2e
output — the device owns the scoring phase (H/E extends, khashl candidate
merge, klib top-N selection, F-closure), the host owns CIGAR/cs generation.

Batching model: W reads run in lock-step over node index i (each read's DAWG
padded to a common node cap); per node ONE batched bidirectional extend
covers all (W, P*N) predecessor cells, and the F-closure rounds batch across
reads exactly like the hapdiv kernel.  Exactness arguments (heap content =
top-N of (H<<32|bucket), khashl bucket replay, first-attainment merge scans)
are inherited from hapdiv_jax's module doc; reads that hit a structural cap
or an order-sensitive corner are flagged `bad` and rerun on the host engine,
so the combined result is always byte-exact.

Reads are device-eligible when: index < 2^32 symbols (lo/hi ride as uint32
halves of the packed int64 key; int64 indexes up to 4 Gsym — e.g. the 2.4G
bench index — qualify since round 3), 2 <= n_best <= 64 (khashl geometry
parameterized via nb_params), DAWG fits (n_node <= node cap, in-degree <=
P_MAX, depth < 512 for the 9-bit rlen/qlen packing).
"""

from __future__ import annotations

from functools import partial

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rank import DeviceIndex, extend as rank_extend
from .hapdiv_jax import (
    BIGI,
    bucket_scan,
    FCAP,
    FROM_E,
    FROM_EXT,
    FROM_F,
    FROM_H,
    FROM_OPEN,
    KEY_EMPTY,
    KEY_HUGE,
    MAXC,
    NB,
    SCAP,
    UNSET,
    _PNONE,
    _ftake,
    _ftake2,
    _home_bucket,
    nb_params,
    _onehot_set,
    _pick,
    _pick2,
    _pack_pos,
    _pack_sc,
    _unpack_pos,
    _unpack_sc,
)

N_BEST = 25  # khashl bucket table (NB=128) is sized for the default n_best
P_MAX = 6  # max DAWG in-degree on device (host fallback above; see dawg_gen)

# carried row word: H(12) E(12) rlen(9) qlen(9)
_RW_E, _RW_RL, _RW_QL = 12, 24, 33
_M12, _M9 = np.int64(0xFFF), np.int64(0x1FF)


def _pack_row(H, E, rlen, qlen):
    return (
        H.astype(jnp.int64)
        | E.astype(jnp.int64) << _RW_E
        | rlen.astype(jnp.int64) << _RW_RL
        | qlen.astype(jnp.int64) << _RW_QL
    )


def _unpack_row(w):
    H = (w & _M12).astype(jnp.int32)
    E = ((w >> _RW_E) & _M12).astype(jnp.int32)
    rlen = ((w >> _RW_RL) & _M9).astype(jnp.int32)
    qlen = ((w >> _RW_QL) & _M9).astype(jnp.int32)
    return H, E, rlen, qlen


# archive word: valid(1) H(12) Hf(2) Ef(1) Ff(1) Fos(1) Foffr(5) Hpos(16) Epos(16)
def _pack_arch(valid, H, Hf, Ef, Ff, Fos, Foffr, Hpos, Epos):
    return (
        valid.astype(jnp.int64)
        | H.astype(jnp.int64) << 1
        | Hf.astype(jnp.int64) << 13
        | Ef.astype(jnp.int64) << 15
        | Ff.astype(jnp.int64) << 16
        | Fos.astype(jnp.int64) << 17
        | Foffr.astype(jnp.int64) << 18
        | (Hpos.astype(jnp.int64) & np.int64(0xFFFF)) << 23
        | (Epos.astype(jnp.int64) & np.int64(0xFFFF)) << 39
    )


def unpack_arch_np(w: np.ndarray):
    """numpy unpack of the archive word (host rebuild)."""
    valid = (w & 1).astype(bool)
    H = ((w >> 1) & 0xFFF).astype(np.int32)
    Hf = ((w >> 13) & 3).astype(np.int32)
    Ef = ((w >> 15) & 1).astype(np.int32)
    Ff = ((w >> 16) & 1).astype(np.int32)
    Fos = ((w >> 17) & 1).astype(np.int32)
    Foffr = ((w >> 18) & 0x1F).astype(np.int32)
    Hpos = ((w >> 23) & 0xFFFF).astype(np.int64)
    Epos = ((w >> 39) & 0xFFFF).astype(np.int64)
    return valid, H, Hf, Ef, Ff, Fos, Foffr, Hpos, Epos


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10, 11))
def sw_device(idx: DeviceIndex, node_c, pre_ids, n_node, NC: int,
              min_sc: int = 30, end_len: int = 11, match: int = 1, mis: int = 3,
              gap_open: int = 5, gap_ext: int = 2, n_best: int = N_BEST):
    """Lock-step sw_core scoring over W padded DAWGs.

    node_c: (W, NC) int32 node edge symbols; pre_ids: (W, NC, P_MAX) int32
    predecessor node ids (-1 pad); n_node: (W,) int32.  Returns
    (arch_lo, arch_hi, arch_rc, arch_w) each (NC, W, N) — node 0 is the root
    row — plus best_score (W,), best_pos (W,) (global cell positions,
    bwa-sw.c:489-490) and bad (W,) host-rerun flags."""
    W = node_c.shape[0]
    N = n_best
    # khashl geometry follows kh_resize(n_best*4) (hapdiv_jax.nb_params):
    # shadows the module defaults so non-default -N keeps exact probe order
    NB_BITS_, NB, MAXC = nb_params(n_best)
    P = pre_ids.shape[2]
    PN = P * N
    S = PN * 6  # candidate slots: per pre cell 5 H-cands + 1 E-slot
    dt = idx.idx_dtype
    acc = idx.acc
    maxpen = max(gap_open + gap_ext, mis)

    iota_n = jax.lax.broadcasted_iota(jnp.int32, (W, N), 1)
    iota_nb = jax.lax.broadcasted_iota(jnp.int32, (W, NB), 1)
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (W, S), 1)
    iota_pn = jax.lax.broadcasted_iota(jnp.int32, (W, PN), 1)

    # ---- carried rows: key (lo<<32|hi), packed (H,E,rlen,qlen), lorc -------
    rows_key = jnp.full((W, NC * N), KEY_EMPTY, jnp.int64)
    root_key = jnp.asarray(acc[6], jnp.int64)  # lo=0 -> key = hi
    rows_key = rows_key.at[:, 0].set(root_key)
    rows_w = jnp.zeros((W, NC * N), jnp.int64)
    rows_rc = jnp.zeros((W, NC * N), jnp.int32)

    lastp_qlen = jnp.zeros((W,), jnp.int32)  # w.last_p dangles across nodes
    best_sc = jnp.zeros((W,), jnp.int32)
    best_pos = jnp.zeros((W,), jnp.int32)
    bad0 = jnp.zeros((W,), bool)

    def node_body(carry, xs):
        rows_key, rows_w, rows_rc, lastp_qlen, best_sc, best_pos, bad = carry
        node_i, c_node, pres = xs  # scalar, (W,), (W, P)
        live = node_i < n_node

        # ---- gather predecessor rows (slot order = pre order x cell) -------
        pre_ok = pres >= 0  # (W, P)
        gidx = jnp.where(pre_ok, pres, 0)[:, :, None] * np.int32(N) + jnp.arange(N, dtype=jnp.int32)
        gidx = gidx.reshape(W, PN)
        pk = _ftake2(rows_key, gidx)
        pw = _ftake2(rows_w, gidx)
        prc = _ftake2(rows_rc, gidx)
        slot_ok = jnp.broadcast_to(pre_ok[:, :, None], (W, P, N)).reshape(W, PN)
        pvalid = slot_ok & (pk != KEY_EMPTY) & live[:, None]
        pH, pE, prlen, pqlen = _unpack_row(pw)
        p_lo = ((pk >> 32) & np.int64(0xFFFFFFFF)).astype(dt)  # unsigned: lo may be >= 2^31
        p_hi = (pk & np.int64(0xFFFFFFFF)).astype(dt)

        # ---- w.last_p: last visited cell (visited even when pruned) --------
        lp_slot = jnp.max(jnp.where(pvalid, iota_pn, np.int32(-1)), axis=1)
        has_cells = lp_slot >= 0
        lastp_qlen = jnp.where(has_cells, _pick(pqlen, jnp.maximum(lp_slot, 0)), lastp_qlen)
        gate_f = lastp_qlen >= np.int32(end_len)

        # ---- ks_ksmall prune (bwa-sw.c:366-376) -----------------------------
        n_pre = jnp.sum(pre_ok, axis=1).astype(jnp.int32)
        n_cell = jnp.sum(pvalid, axis=1).astype(jnp.int32)
        hs = jnp.sort(jnp.where(pvalid, pH, np.int32(-1)), axis=1, descending=True)
        kth = hs[:, N] if PN > N else jnp.zeros((W,), jnp.int32)
        mms = jnp.where((n_pre > 1) & (n_cell > np.int32(N)), kth, 0)
        mms = jnp.where(n_pre > 1, jnp.maximum(mms - np.int32(maxpen), 0), 0)
        cell_live = pvalid & (pH + np.int32(match) >= mms[:, None])

        # ---- one batched extend of all pre cells ---------------------------
        ik = jnp.stack(
            [p_lo, prc.astype(dt), jnp.where(pvalid, p_hi - p_lo, jnp.zeros((), dt))],
            axis=-1,
        )
        ok = rank_extend(idx, ik.reshape(W * PN, 3), jnp.ones((W * PN,), bool)).reshape(W, PN, 6, 3)

        # ---- candidate slots (insert order: pre slot, then c=1..5, E) ------
        c_n = c_node[:, None]  # (W, 1)
        sym = iota_s % 6 + 1  # 1..5 H-cands, 6 => E-slot
        is_e = sym == 6
        sym_c = jnp.minimum(sym, 5)

        def rep6(a):
            return jnp.broadcast_to(a[:, :, None], (W, PN, 6)).reshape(W, S)

        ok15 = ok[:, :, 1:6, :]  # (W, PN, 5, 3)
        ok16 = jnp.concatenate([ok15, ok15[:, :, 4:5, :]], axis=2)
        e_lo = ok16[..., 0].reshape(W, S)
        e_rc = ok16[..., 1].reshape(W, S)
        e_sz = ok16[..., 2].reshape(W, S)
        pHk, pEk = rep6(pH), rep6(pE)
        pqk, prk = rep6(pqlen), rep6(prlen)
        clk = rep6(cell_live.astype(jnp.int32)) == 1
        sc = jnp.where((sym_c == c_n) & (sym_c != 5), np.int32(match), np.int32(-mis))
        mms_s = jnp.broadcast_to(mms[:, None], (W, S))
        h_pass = (
            clk
            & ~is_e
            & (e_sz > 0)
            & (pHk + sc > 0)
            & (pHk + sc >= mms_s)
            & ((sym_c == c_n) | (pqk >= np.int32(end_len)))
        )
        # stale lo_rc for the E-slot (bwa-sw.c:418 quirk, see hapdiv_jax)
        hp_full = (h_pass & ~is_e).reshape(W, PN, 6)
        hp_i = jnp.where(hp_full, jax.lax.broadcasted_iota(jnp.int32, (W, PN, 6), 2) + 1, 0)
        last_c = jnp.max(hp_i, axis=2)  # (W, PN)
        oh_last = (
            jax.lax.broadcasted_iota(jnp.int32, (W, PN, 5), 2) + 1 == last_c[:, :, None]
        ).astype(dt)
        stale_rc = jnp.sum(ok15[..., 1] * oh_last, axis=2, dtype=dt)
        e_open = pHk - np.int32(gap_open) > pEk
        e_val = jnp.where(e_open, pHk - np.int32(gap_open), pEk) - np.int32(gap_ext)
        e_from = jnp.where(e_open, np.int32(FROM_OPEN), np.int32(FROM_EXT))
        e_pass = clk & is_e & (e_val > 0) & (e_val >= mms_s) & (pqk >= np.int32(end_len))
        cvalid = h_pass | e_pass
        lo_s = jnp.where(is_e, rep6(p_lo), e_lo)
        hi_s = jnp.where(is_e, rep6(p_hi), e_lo + e_sz)
        key = jnp.where(cvalid, (lo_s.astype(jnp.int64) << 32) | hi_s.astype(jnp.int64), KEY_HUGE)
        lorc = jnp.where(is_e, rep6(stale_rc), e_rc)
        cH = jnp.where(is_e, e_val, pHk + sc)
        cE = jnp.where(is_e, e_val, np.int32(0))
        crlen = jnp.where(is_e, prk, prk + 1)
        cqlen = pqk + 1
        cHfrom = jnp.where(is_e, np.int32(FROM_E), np.int32(FROM_H))
        cEfrom = jnp.where(is_e, e_from, np.int32(0))
        # global cell position: pre_id * N + cell col (bwa-sw.c:393) —
        # broadcast per pre slot, no gather
        pid_pn = jnp.broadcast_to(jnp.where(pre_ok, pres, 0)[:, :, None], (W, P, N)).reshape(W, PN)
        gpos_pn = pid_pn * np.int32(N) + jnp.broadcast_to(
            jnp.arange(N, dtype=jnp.int32)[None, None], (W, P, N)
        ).reshape(W, PN)
        gpos = rep6(gpos_pn)
        cHpos = jnp.where(is_e, np.int32(-1), gpos)
        cEpos = jnp.where(is_e, gpos, np.int32(-1))
        # packed-word caps: 12-bit scores, 9-bit rlen/qlen
        bad = bad | jnp.any(cvalid & ((cH > 4095) | (crlen > 510) | (cqlen > 510)), axis=1)

        # ---- phase A: sorted-segment dedup + running-max merge --------------
        # (one variadic stable sort + forward/backward segmented scans; see
        # hapdiv_jax for why this is gather-free)
        spos = iota_s
        scw0 = _pack_sc(
            jnp.where(cvalid, cH, 0), jnp.where(cvalid, cE, 0),
            jnp.zeros((W, S), jnp.int32), jnp.where(cvalid, crlen, 0),
            jnp.where(cvalid, cqlen, 0), cHfrom, cEfrom,
            jnp.zeros((W, S), jnp.int32), jnp.zeros((W, S), jnp.int32),
        )
        posw0 = _pack_pos(
            jnp.where(cHpos < 0, _PNONE, cHpos),
            jnp.where(cEpos < 0, _PNONE, cEpos),
            jnp.full((W, S), UNSET, jnp.int32),
        )
        key_s, slot_s, scw_s, posw_s, lorc_s = jax.lax.sort(
            (key, spos, scw0, posw0, lorc), dimension=1, is_stable=True, num_keys=1,
        )
        valid_s = key_s != KEY_HUGE
        head = jnp.concatenate([jnp.ones((W, 1), bool), key_s[:, 1:] != key_s[:, :-1]], axis=1)
        H_s, E_s, _, rl_s, ql_s, Hfrom_s, Efrom_s, _, _ = _unpack_sc(scw_s)
        Hpos_s, Epos_s, _ = _unpack_pos(posw_s)

        def fcomb(a, b):
            fa, fb = a["f"], b["f"]
            o = {"f": fa | fb}
            upH = b["mH"] > a["mH"]
            for k2 in ("mH", "hf", "hp"):
                o[k2] = jnp.where(fb, b[k2], jnp.where(upH, b[k2], a[k2]))
            o["hstart"] = jnp.where(fb, b["hstart"], jnp.where(upH, False, a["hstart"]))
            upE = b["mE"] > a["mE"]
            for k2 in ("mE", "ef", "ep"):
                o[k2] = jnp.where(fb, b[k2], jnp.where(upE, b[k2], a[k2]))
            o["mrl"] = jnp.where(fb, b["mrl"], jnp.maximum(a["mrl"], b["mrl"]))
            o["mql"] = jnp.where(fb, b["mql"], jnp.maximum(a["mql"], b["mql"]))
            for k2 in ("hp_head", "slot_head", "lorc_head", "key_head"):
                o[k2] = jnp.where(fb, b[k2], a[k2])
            return o

        elems = dict(
            f=head, mH=H_s, hf=Hfrom_s, hp=Hpos_s, hstart=jnp.ones((W, S), bool),
            mE=E_s, ef=Efrom_s, ep=Epos_s, mrl=rl_s, mql=ql_s,
            hp_head=Hpos_s, slot_head=slot_s, lorc_head=lorc_s, key_head=key_s,
        )
        fw = jax.lax.associative_scan(fcomb, elems, axis=1)
        tail = jnp.concatenate([head[:, 1:], jnp.ones((W, 1), bool)], axis=1)

        def bcomb(a, b):
            o = {"f": a["f"] | b["f"]}
            for k2 in a:
                if k2 != "f":
                    o[k2] = jnp.where(b["f"], b[k2], a[k2])
            return o

        bw_in = {k2: jnp.flip(v, 1) for k2, v in fw.items() if k2 not in ("hp_head", "slot_head", "lorc_head", "key_head")}
        bw_in["f"] = jnp.flip(tail, 1)
        bw = {k2: jnp.flip(v, 1) for k2, v in jax.lax.associative_scan(bcomb, bw_in, axis=1).items()}

        ambiguous = (~bw["hstart"]) & (bw["hf"] == np.int32(FROM_E))
        bad = bad | jnp.any(head & valid_s & ambiguous, axis=1)
        gHpos = jnp.where(bw["hstart"], fw["hp_head"], bw["hp"])

        u_scw = _pack_sc(
            bw["mH"], bw["mE"], jnp.zeros((W, S), jnp.int32), bw["mrl"], bw["mql"],
            bw["hf"], bw["ef"], jnp.zeros((W, S), jnp.int32), jnp.zeros((W, S), jnp.int32),
        )
        u_posw = _pack_pos(gHpos, bw["ep"], jnp.full((W, S), UNSET, jnp.int32))
        ukey_src = jnp.where(head & valid_s, fw["slot_head"], BIGI)
        ukey_sorted, u_key, u_sc, u_pos, u_lorc = jax.lax.sort(
            (ukey_src, jnp.where(head & valid_s, key_s, KEY_EMPTY), u_scw, u_posw, lorc_s),
            dimension=1, is_stable=True, num_keys=1,
        )
        u_valid = ukey_sorted != BIGI
        u_count = jnp.sum(u_valid, axis=1).astype(jnp.int32)
        bad = bad | (u_count >= np.int32(MAXC))

        # ---- khashl bucket replay (first-occurrence inserts): scan with the
        # home as xs and the bucket as ys — the while_loop's per-iteration
        # gathers/column-DUS dominated the hapdiv kernel (see hapdiv_jax)
        u_home = _home_bucket(u_key, NB_BITS_)
        UCAP = min(S, MAXC - 1)
        u_bucket = bucket_scan(u_home, u_count, bad, NB, UCAP)
        if S > UCAP:
            u_bucket = jnp.concatenate([u_bucket, jnp.zeros((W, S - UCAP), jnp.int32)], axis=1)

        # ---- materialize the 128-bucket table -------------------------------
        bvalid = u_valid & ~bad[:, None]
        oh_b = (u_bucket[:, :, None] == iota_nb[:, None, :]) & bvalid[:, :, None]
        hitj = jnp.any(oh_b, axis=1)
        uiota = jax.lax.broadcasted_iota(jnp.int32, (W, S, 1), 1)
        srcu = jnp.sum(oh_b * uiota, axis=1)  # (W, NB)
        rows_u = jnp.stack([u_key, u_sc, u_pos, u_lorc.astype(jnp.int64)], axis=-1).reshape(W * S, 4)
        base_w = (jnp.arange(W, dtype=jnp.int32) * np.int32(S))[:, None]
        g = jnp.take(rows_u, base_w + srcu, axis=0)  # (W, NB, 4)
        tkey = jnp.where(hitj, g[..., 0], KEY_EMPTY)
        tsc = jnp.where(hitj, g[..., 1], np.int64(0))
        tpos = jnp.where(hitj, g[..., 2], _pack_pos(jnp.full((W, NB), _PNONE), jnp.full((W, NB), _PNONE), jnp.full((W, NB), UNSET)))
        tlorc = jnp.where(hitj, g[..., 3].astype(dt), jnp.zeros((), dt))
        count = jnp.where(bad, 0, u_count)

        # ---- first selection: top-N by (H << 32 | bucket) -------------------
        def topn(tkey, tsc):
            tH = (tsc & _M12).astype(jnp.int64)
            x = jnp.where(tkey != KEY_EMPTY, (tH << 32) | iota_nb.astype(jnp.int64), np.int64(-1))
            return jnp.sort(x, axis=1, descending=True)[:, :N]

        row_x = topn(tkey, tsc)

        # ---- F-closure (identical machinery to hapdiv_jax) ------------------
        heap = jnp.flip(row_x, 1)
        hlen = jnp.sum(row_x >= 0, axis=1).astype(jnp.int32)
        rb = (row_x & np.int64(0xFFFFFFFF)).astype(jnp.int32)
        r_valid0 = row_x >= 0
        rH0 = (row_x >> 32).astype(jnp.int32)
        elig = r_valid0 & (rH0 > np.int32(gap_open + gap_ext)) & gate_f[:, None] & ~bad[:, None]
        rev_csum = jnp.flip(jnp.cumsum(jnp.flip(elig.astype(jnp.int32), 1), axis=1), 1)
        slot_of_j = rev_csum - elig.astype(jnp.int32)
        st_perm = jnp.argsort(jnp.where(elig, slot_of_j, BIGI), axis=1, stable=True)
        st_bucket = _pick2(rb, st_perm)
        st_n = jnp.sum(elig, axis=1).astype(jnp.int32)

        def table_rows(tk, ts, tp, tl, bcol):
            rws = jnp.stack([tk, ts, tp, tl.astype(jnp.int64)], axis=-1).reshape(W * NB, 4)
            bw_ = (jnp.arange(W, dtype=jnp.int32) * np.int32(NB))[:, None]
            return jnp.take(rws, bw_ + bcol, axis=0)

        def from_table(bcol):
            g2 = table_rows(tkey, tsc, tpos, tlorc, bcol)
            k2 = g2[..., 0]
            H, E, F, rl, ql, *_ = _unpack_sc(g2[..., 1])
            return dict(
                lo=((k2 >> 32) & np.int64(0xFFFFFFFF)).astype(dt), hi=(k2 & np.int64(0xFFFFFFFF)).astype(dt),
                lorc=g2[..., 3].astype(dt), H=H, F=F, rlen=rl, qlen=ql,
            )

        stc = from_table(st_bucket)

        def padN(a, fill=0):
            return jnp.concatenate([a, jnp.full((W, SCAP - N), fill, a.dtype)], axis=1)

        stack = dict(
            lo=padN(stc["lo"]), hi=padN(stc["hi"]), lorc=padN(stc["lorc"]),
            H=padN(stc["H"]), F=padN(stc["F"]), rlen=padN(stc["rlen"]), qlen=padN(stc["qlen"]),
        )
        sp = st_n
        fpar = jnp.full((W, FCAP), KEY_EMPTY, jnp.int64)
        nfp = jnp.zeros((W,), jnp.int32)
        iota_sc = jax.lax.broadcasted_iota(jnp.int32, (W, SCAP), 1)

        def cl_cond(st):
            return jnp.any((st["sp"] > 0) & ~st["bad"]) & (st["rounds"] < np.int32(1024))

        def cl_body(st):
            tkey, tsc, tpos, tlorc = st["tkey"], st["tsc"], st["tpos"], st["tlorc"]
            heap, hlen = st["heap"], st["hlen"]
            stack, sp = st["stack"], st["sp"]
            fpar, nfp, count, bad = st["fpar"], st["nfp"], st["count"], st["bad"]

            minv = jnp.where(hlen < N, 0, (heap[:, 0] >> 32).astype(jnp.int32))
            live2 = (iota_sc < sp[:, None]) & ~bad[:, None]
            f_open_all = stack["H"] - np.int32(gap_open) > stack["F"]
            F2_all = jnp.where(f_open_all, stack["H"] - np.int32(gap_open), stack["F"]) - np.int32(gap_ext)
            qual = live2 & (F2_all > minv[:, None])
            chosen = jnp.max(jnp.where(qual, iota_sc, np.int32(-1)), axis=1)
            pend = chosen >= 0
            sp = jnp.where(bad, sp, jnp.maximum(chosen, 0))
            at = jnp.maximum(chosen, 0)
            z = {f2: _pick(stack[f2], at) for f2 in stack}
            pF2 = _pick(F2_all, at)
            pFfrom = jnp.where(_pick(f_open_all.astype(jnp.int32), at) == 1, np.int32(FROM_OPEN), np.int32(FROM_EXT))
            pmin = minv

            ikz = jnp.stack(
                [z["lo"].astype(dt), z["lorc"].astype(dt), jnp.where(pend, (z["hi"] - z["lo"]).astype(dt), jnp.zeros((), dt))],
                axis=-1,
            )
            okz = rank_extend(idx, ikz, jnp.ones((W,), bool))  # (W, 6, 3)

            rH = pF2
            zkey = (z["lo"].astype(jnp.int64) << 32) | z["hi"].astype(jnp.int64)
            occ_extra = jnp.zeros((W, NB), bool)
            wbuf = []
            pushes = []
            for c in range(1, 6):
                csz = okz[:, c, 2]
                putm = pend & (csz > 0)
                lo_c = okz[:, c, 0]
                hi_c = lo_c + csz
                key_c = (lo_c.astype(jnp.int64) << 32) | hi_c.astype(jnp.int64)
                home = _home_bucket(key_c, NB_BITS_)
                d = (iota_nb - home[:, None]) & np.int32(NB - 1)
                elig_b = ((tkey == KEY_EMPTY) & ~occ_extra) | (tkey == key_c[:, None])
                b = jnp.argmin(jnp.where(elig_b, d, BIGI), axis=1).astype(jnp.int32)
                occ_extra = occ_extra | ((iota_nb == b[:, None]) & putm[:, None])
                cur_key = _pick(tkey, b)
                absent = cur_key == KEY_EMPTY
                bad = bad | (putm & (count >= np.int32(MAXC)))
                putm = putm & ~bad
                count = count + (putm & absent)
                cw = _pick(tsc, b)
                tH, tE, tF, trl, tql, tHf, tEf, tFf, tFo = _unpack_sc(cw)
                pw2 = _pick(tpos, b)
                tHp, tEp, tFoff = _unpack_pos(pw2)
                nH = jnp.where(absent, rH, jnp.maximum(tH, rH))
                nHf = jnp.where(absent | (tH < rH), np.int32(FROM_F), tHf)
                nHp = jnp.where(absent, _PNONE, tHp)
                nE = jnp.where(absent, np.int32(0), tE)
                nEf = jnp.where(absent, np.int32(0), tEf)
                nEp = jnp.where(absent, _PNONE, tEp)
                chF = absent | (tF < rH)
                nF = jnp.where(chF, rH, tF)
                nFf = jnp.where(chF, pFfrom, tFf)
                nrl = jnp.where(absent, z["rlen"] + 1, jnp.maximum(trl, z["rlen"] + 1))
                nql = jnp.where(absent, z["qlen"], jnp.maximum(tql, z["qlen"]))
                bad = bad | (putm & (nrl > np.int32(510)))  # 9-bit rlen cap
                nFo = jnp.where(absent, np.int32(0), tFo)
                do_f = putm & chF
                bad = bad | (do_f & (nfp >= np.int32(FCAP)))
                do_f = do_f & ~bad
                nFoff = jnp.where(chF, nfp, tFoff)
                fpar = _onehot_set(fpar, nfp, zkey, do_f)
                nfp = nfp + do_f
                x = (rH.astype(jnp.int64) << 32) | np.int64(0xFFFFFFFF)
                grow = do_f & (hlen < N)
                repl = do_f & (hlen >= N) & (x > heap[:, 0])
                ins = grow | repl
                p2 = jnp.sum(heap < x[:, None], axis=1).astype(jnp.int32)
                shifted = jnp.concatenate([heap[:, 1:], heap[:, -1:]], axis=1)
                cand_h = jnp.where(iota_n < p2[:, None] - 1, shifted, jnp.where(iota_n == p2[:, None] - 1, x[:, None], heap))
                heap = jnp.where(ins[:, None], cand_h, heap)
                hlen = hlen + grow
                push = do_f & (rH - np.int32(gap_ext) > pmin)
                bad = bad | (push & (sp >= np.int32(SCAP)))
                push = push & ~bad
                new_lorc = jnp.where(absent, okz[:, c, 1], _pick(tlorc, b))
                pushes.append((sp, push, dict(
                    lo=lo_c.astype(dt), hi=hi_c.astype(dt), lorc=new_lorc.astype(dt),
                    H=nH, F=nF, rlen=nrl, qlen=nql,
                )))
                sp = sp + push
                nkey = jnp.where(absent, key_c, cur_key)
                nsc = _pack_sc(nH, nE, nF, nrl, nql, nHf, nEf, nFf, nFo)
                npos = _pack_pos(nHp, nEp, nFoff)
                wbuf.append((b, putm, nkey, nsc, npos, new_lorc.astype(dt)))

            def write5(arr, vals_at):
                out = arr
                for b, putm, *vals in wbuf:
                    sel = (iota_nb == b[:, None]) & putm[:, None]
                    out = jnp.where(sel, vals[vals_at][:, None].astype(arr.dtype), out)
                return out

            tkey = write5(tkey, 0)
            tsc = write5(tsc, 1)
            tpos = write5(tpos, 2)
            tlorc = write5(tlorc, 3)
            for f2 in stack:
                out = stack[f2]
                for slot, push, pf in pushes:
                    sel = (iota_sc == slot[:, None]) & push[:, None]
                    out = jnp.where(sel, pf[f2][:, None].astype(out.dtype), out)
                stack[f2] = out

            return dict(
                tkey=tkey, tsc=tsc, tpos=tpos, tlorc=tlorc, heap=heap, hlen=hlen,
                stack=stack, sp=sp, fpar=fpar, nfp=nfp, count=count, bad=bad,
                rounds=st["rounds"] + 1,
            )

        st0 = dict(
            tkey=tkey, tsc=tsc, tpos=tpos, tlorc=tlorc, heap=heap, hlen=hlen,
            stack=stack, sp=sp, fpar=fpar, nfp=nfp, count=count, bad=bad,
            rounds=jnp.asarray(0, jnp.int32),
        )
        stf = jax.lax.while_loop(cl_cond, cl_body, st0)
        tkey, tsc, tpos, tlorc = stf["tkey"], stf["tsc"], stf["tpos"], stf["tlorc"]
        fpar, nfp = stf["fpar"], stf["nfp"]
        bad = stf["bad"] | (stf["sp"] > 0)

        # ---- rebuild: final top-N by (H<<32|bucket) --------------------------
        row_x = topn(tkey, tsc)
        r_valid = (row_x >= 0) & live[:, None]
        rbuck = (row_x & np.int64(0xFFFFFFFF)).astype(jnp.int32)
        gr = table_rows(tkey, tsc, tpos, tlorc, rbuck)
        rkey, rsc, rpos, rlorc = gr[..., 0], gr[..., 1], gr[..., 2], gr[..., 3].astype(dt)
        rH, rE, rF, rrl, rql, rHf, rEf, rFf, rFo = _unpack_sc(rsc)
        rHp, rEp, rFoff = _unpack_pos(rpos)

        # ---- sw_track_F: fpar index -> row column (bwa-sw.c:301-324) --------
        need = r_valid & (rF > 0) & (rFoff != UNSET)
        fkey = _pick2(fpar, jnp.where(need, jnp.minimum(rFoff, FCAP - 1), 0))
        mt = (rkey[:, None, :] == fkey[:, :, None]) & r_valid[:, None, :]
        hit = jnp.any(mt, axis=2)
        j2 = jnp.argmax(mt, axis=2).astype(jnp.int32)
        rFoffr = jnp.where(need & hit, j2, np.int32(31))
        rFos = jnp.where(need & hit, np.int32(1), np.int32(0))

        # ---- write the new row into the carry + archive ----------------------
        nkey = jnp.where(r_valid, rkey, KEY_EMPTY)
        nw = _pack_row(jnp.where(r_valid, rH, 0), jnp.where(r_valid, rE, 0),
                       jnp.where(r_valid, rrl, 0), jnp.where(r_valid, rql, 0))
        nrc = jnp.where(r_valid, rlorc.astype(jnp.int32), 0)
        col0 = node_i.astype(jnp.int32) * np.int32(N)
        rows_key = jax.lax.dynamic_update_slice(rows_key, nkey, (np.int32(0), col0))
        rows_w = jax.lax.dynamic_update_slice(rows_w, nw, (np.int32(0), col0))
        rows_rc = jax.lax.dynamic_update_slice(rows_rc, nrc, (np.int32(0), col0))

        upd = r_valid[:, 0] & (rH[:, 0] > best_sc)
        best_sc = jnp.where(upd, rH[:, 0], best_sc)
        best_pos = jnp.where(upd, node_i.astype(jnp.int32) * np.int32(N), best_pos)

        arch_lo = jnp.where(r_valid, (rkey >> 32) & np.int64(0xFFFFFFFF), 0).astype(jnp.int32)  # uint32 bit pattern
        arch_hi = jnp.where(r_valid, (rkey & np.int64(0xFFFFFFFF)), 0).astype(jnp.int32)
        arch_rc = nrc
        arch_w = _pack_arch(
            r_valid, jnp.where(r_valid, rH, 0), rHf, rEf, rFf, rFos, rFoffr,
            jnp.where(rHp == _PNONE, np.int32(0xFFFF), rHp),
            jnp.where(rEp == _PNONE, np.int32(0xFFFF), rEp),
        )
        return (rows_key, rows_w, rows_rc, lastp_qlen, best_sc, best_pos, bad), (arch_lo, arch_hi, arch_rc, arch_w)

    xs = (
        jnp.arange(1, NC, dtype=jnp.int32),
        node_c.T[1:],
        jnp.transpose(pre_ids, (1, 0, 2))[1:],
    )
    carry0 = (rows_key, rows_w, rows_rc, lastp_qlen, best_sc, best_pos, bad0)
    (_, _, _, _, best_sc, best_pos, bad), (a_lo, a_hi, a_rc, a_w) = jax.lax.scan(node_body, carry0, xs)

    # prepend the root row (node 0)
    root_lo = jnp.zeros((1, W, N), jnp.int32)
    root_hi = jnp.where(iota_n == 0, jnp.asarray(acc[6], jnp.int32), 0)[None]
    root_rc = jnp.zeros((1, W, N), jnp.int32)
    root_w = _pack_arch(
        iota_n == 0, jnp.zeros((W, N), jnp.int32), jnp.zeros((W, N), jnp.int32),
        jnp.zeros((W, N), jnp.int32), jnp.zeros((W, N), jnp.int32),
        jnp.zeros((W, N), jnp.int32), jnp.full((W, N), 31, jnp.int32),
        jnp.zeros((W, N), jnp.int32), jnp.full((W, N), 0xFFFF, jnp.int32),
    )[None]
    arch_lo = jnp.concatenate([root_lo, a_lo], axis=0)
    arch_hi = jnp.concatenate([root_hi, a_hi], axis=0)
    arch_rc = jnp.concatenate([root_rc, a_rc], axis=0)
    arch_w = jnp.concatenate([root_w, a_w], axis=0)
    return arch_lo, arch_hi, arch_rc, arch_w, best_sc, best_pos, bad


def rebuild_rows(arch_lo, arch_hi, arch_rc, arch_w, n_node: int):
    """Device archive (one read's (NC, N) slices) -> rows list[list[Cell]] for
    the host backtrack (align/bwasw.sw_backtrack).  E/F are rebuilt as
    indicator values (>0 where the backtrack's asserts require them); the
    walk itself only reads the from-links, lo, H and flt."""
    from .bwasw import SW_F_UNSET, UINT32_MAX, Cell

    valid, H, Hf, Ef, Ff, Fos, Foffr, Hpos, Epos = unpack_arch_np(arch_w[:n_node])
    # int32 archives carry uint32 bit patterns (lo/hi < 2^32 on any
    # supported index) — reinterpret before int() materialization
    import numpy as _np

    lo_u = _np.ascontiguousarray(arch_lo[:n_node]).view(_np.uint32)
    hi_u = _np.ascontiguousarray(arch_hi[:n_node]).view(_np.uint32)
    rows = []
    for i in range(n_node):
        row = []
        for j in range(valid.shape[1]):
            if not valid[i, j]:
                break
            c = Cell.__new__(Cell)
            c.lo, c.hi, c.lo_rc = int(lo_u[i, j]), int(hi_u[i, j]), int(arch_rc[i, j])
            c.H = int(H[i, j])
            c.H_from, c.E_from, c.F_from = int(Hf[i, j]), int(Ef[i, j]), int(Ff[i, j])
            c.F_off_set = int(Fos[i, j])
            c.F_from_off = int(Foffr[i, j]) if Fos[i, j] else SW_F_UNSET
            c.H_from_pos = int(Hpos[i, j]) if Hpos[i, j] != 0xFFFF else UINT32_MAX
            c.E_from_pos = int(Epos[i, j]) if Epos[i, j] != 0xFFFF else UINT32_MAX
            c.E = 1 if c.E_from_pos != UINT32_MAX else 0
            c.F = 1 if c.F_off_set else 0
            c.flt = 0
            c.rlen = c.qlen = 0
            row.append(c)
        rows.append(row)
    return rows


class SwDeviceEngine:
    """CLI driver for `sw --engine=jax`: device sw_core scoring + host
    backtrack, with exact host fallback for flagged/ineligible reads.

    Produces the same hits lists as rb3_sw_batch (byte-identical PAF)."""

    NC_BUCKETS = (64, 128, 256, 384)
    # the kernel reads P from pre_ids.shape[2]; staging buckets each batch by
    # its actual max in-degree so linear (e2e) DAWGs pay S = N*6 slots instead
    # of P_MAX*N*6 (the candidate sort, scans and extend all scale with S —
    # measured 72% of random 150 bp general DAWGs fit P=4, e2e fits P=1)
    P_BUCKETS = (1, 2, 4, P_MAX)

    def __init__(self, f, opt, lanes: int = 256, mesh=None):
        from .bwasw import RB3_SWF_HAPDIV
        from .. import require_device

        require_device()
        import os as _os2

        self.f = f
        self.opt = opt
        # per-node fixed cost amortizes over lanes (the loops are
        # dispatch-bound at small W); env knob for sweeps
        try:
            self.lanes = int(_os2.environ.get("RB3JAX_SW_LANES", lanes))
        except ValueError:  # malformed sweep knob must not crash the CLI
            self.lanes = lanes
        # reads run data-parallel over the mesh's `dp` axis (tables
        # replicated), same GSPMD layout as the hapdiv engine
        self.mesh = mesh
        self.idx = None
        # khashl geometry is parameterized on n_best (round 3); the former
        # n_best == 25 gate is widened to any table the packing supports
        self.supported = (
            f.n < (1 << 32)  # key packing/hash carry lo/hi as uint32 halves
            # upper bound: the F-closure stack holds SCAP slots and is seeded
            # with up to n_best cells (N > SCAP would make the (W, SCAP-N)
            # pad shape negative — caught by the differential fuzzer)
            and 2 <= opt.n_best <= min(64, SCAP)
            and not (opt.flag & RB3_SWF_HAPDIV)
        )

    def _stage(self, a):
        if self.mesh is None:
            return jnp.asarray(a)
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(a, NamedSharding(self.mesh, P("dp", *([None] * (a.ndim - 1)))))

    def _dawg(self, seq):
        from .bwasw import RB3_SWF_E2E
        from .bwtl import bwtl_gen, dawg_gen, dawg_gen_linear

        if self.opt.flag & RB3_SWF_E2E:
            return dawg_gen_linear(seq)
        return dawg_gen(bwtl_gen(seq))

    def run(self, seqs: list[np.ndarray]) -> list[list]:
        from ..ops.smem_ref import smem_present
        from .bwasw import _attach_positions_multi, rb3_sw_batch, sw_backtrack

        o = self.opt
        if not (self.supported and seqs):
            return rb3_sw_batch(o, self.f, seqs)
        if self.idx is None:
            self.idx = DeviceIndex.from_dense(self.f)
            if self.mesh is not None:
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P

                self.idx = jax.device_put(self.idx, NamedSharding(self.mesh, P()))

        # per-read gating: prefilter + DAWG shape caps
        gs: list = [None] * len(seqs)
        gp: dict[int, int] = {}  # read -> max in-degree
        host_idx: list[int] = []
        dev_idx: list[int] = []
        for i, s in enumerate(seqs):
            if o.min_mem_len > 0 and o.min_mem_len > o.end_len and not smem_present(self.f, s, o.min_mem_len):
                gs[i] = ()  # no hits at all
                continue
            g = self._dawg(s)
            maxp = max(len(nd.pre) for nd in g.node)
            if g.n_node <= self.NC_BUCKETS[-1] and g.n_node <= 512 and maxp <= P_MAX:
                gs[i] = g
                gp[i] = maxp
                dev_idx.append(i)
            else:
                host_idx.append(i)

        out: list = [None] * len(seqs)
        for i in range(len(seqs)):
            if gs[i] == ():
                out[i] = []

        # device batches, bucketed by node count for compile reuse
        def bucket_of(n: int) -> int:
            for b in self.NC_BUCKETS:
                if n <= b:
                    return b
            raise AssertionError(n)

        def pbucket_of(m: int) -> int:
            for p in self.P_BUCKETS:
                if m <= p:
                    return p
            raise AssertionError(m)

        for nc in self.NC_BUCKETS:
            for pb in self.P_BUCKETS:
                grp = [i for i in dev_idx if bucket_of(gs[i].n_node) == nc and pbucket_of(gp[i]) == pb]
                self._run_bucket(grp, nc, pb, gs, seqs, out, host_idx)

        hostset = set(host_idx)
        if host_idx:
            # rb3_sw_batch attaches positions itself
            redo = rb3_sw_batch(o, self.f, [seqs[i] for i in host_idx])
            for i, hits in zip(host_idx, redo):
                out[i] = hits
        dev_done = [out[i] for i in range(len(seqs)) if i not in hostset and out[i]]
        _attach_positions_multi(o, self.f, dev_done)
        return out

    def _run_bucket(self, grp, nc, pb, gs, seqs, out, host_idx):
        from .bwasw import _cell_dedup, sw_backtrack

        o = self.opt
        for b0 in range(0, len(grp), self.lanes):
            chunk = grp[b0 : b0 + self.lanes]
            W = len(chunk)
            Wp = max(8, 1 << (W - 1).bit_length())
            if self.mesh is not None:  # lane count must tile over dp
                dp = self.mesh.shape["dp"]
                Wp = -(-Wp // dp) * dp
            node_c = np.zeros((Wp, nc), np.int32)
            pre = np.full((Wp, nc, pb), -1, np.int32)
            n_node = np.ones(Wp, np.int32)
            for r, i in enumerate(chunk):
                g = gs[i]
                n_node[r] = g.n_node
                for ni, nd in enumerate(g.node):
                    node_c[r, ni] = max(nd.c, 0)
                    for pj, pp in enumerate(nd.pre):
                        pre[r, ni, pj] = pp
            a_lo, a_hi, a_rc, a_w, bsc, bpos, bad = sw_device(
                self.idx, self._stage(node_c), self._stage(pre), self._stage(n_node), nc,
                min_sc=o.min_sc, end_len=o.end_len, match=o.match, mis=o.mis,
                gap_open=o.gap_open, gap_ext=o.gap_ext, n_best=o.n_best,
            )
            from ..parallel.launch import to_host

            # to_host: plain np.asarray single-process; under jax.distributed
            # the outputs span non-addressable devices and need an allgather
            a_lo, a_hi, a_rc, a_w = map(to_host, (a_lo, a_hi, a_rc, a_w))
            bsc, bpos, bad = map(to_host, (bsc, bpos, bad))
            for r, i in enumerate(chunk):
                if bad[r]:
                    host_idx.append(i)
                    continue
                g = gs[i]
                if int(bsc[r]) < o.min_sc:
                    out[i] = []
                    continue
                rows = rebuild_rows(a_lo[:, r], a_hi[:, r], a_rc[:, r], a_w[:, r], g.n_node)
                if rows[g.n_node - 1]:
                    _cell_dedup(rows[g.n_node - 1])
                hits, _ = sw_backtrack(o, self.f, g, seqs[i], rows, int(bpos[r]), False)
                out[i] = hits or []
