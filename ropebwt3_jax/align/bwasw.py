"""Revised BWA-SW: DAWG(query) x suffix-trie(reference FM-index) affine-gap DP
— re-implementation of bwa-sw.c with exact tie-breaking (khashl bucket order,
klib heap/k-small semantics) so PAF/e2e outputs byte-match the reference.

Per DAWG node (topological order) a row of <= n_best cells keyed by reference
SA bi-interval; H/E from predecessor rows via one backward extend per
predecessor cell; F (deletion) closure as a DFS over reference symbols; top-N
selection through a khashl candidate set + binary heap (bwa-sw.c:329-526).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..index.dense import DenseFMIndex
from .bwtl import Dawg, bwtl_gen, dawg_gen, dawg_gen_linear
from .khashl_compat import KhashlSet, kh_hash_uint64, ks_heapsort, ks_heapup, ks_heapdown, ks_ksmall

DBG_DAWG, DBG_SW, DBG_QNAME, DBG_BT = 1, 2, 4, 8
dbg_flag = 0  # mirrors rb3_dbg_flag (rb3priv.h:7-10)

SW_FROM_H, SW_FROM_E, SW_FROM_F = 0, 1, 2
SW_FROM_OPEN, SW_FROM_EXT = 0, 1
SW_F_UNSET = 0x3FFFFFF
UINT32_MAX = 0xFFFFFFFF
RB3_SWF_E2E, RB3_SWF_HAPDIV, RB3_SWF_KEEP_RS = 1, 2, 4
RB2_SW_MAX_ED = 6


@dataclass
class SwOpt:
    flag: int = 0
    n_best: int = 25
    min_sc: int = 30
    end_len: int = 11
    min_mem_len: int = 0
    max_pos: int = 0
    match: int = 1
    mis: int = 3
    e2e_drop: int = -1
    gap_open: int = 5
    gap_ext: int = 2
    r2cache_size: int = 0x10000


class Cell:
    __slots__ = ("H", "E", "F", "flt", "H_from", "E_from", "F_from", "F_from_off", "F_off_set", "H_from_pos", "E_from_pos", "rlen", "qlen", "lo", "hi", "lo_rc")

    def __init__(self):
        self.H = self.E = self.F = 0
        self.flt = 0
        self.H_from = self.E_from = self.F_from = 0
        self.F_from_off = 0
        self.F_off_set = 0
        self.H_from_pos = self.E_from_pos = 0
        self.rlen = self.qlen = 0
        self.lo = self.hi = self.lo_rc = 0

    def copy(self) -> "Cell":
        c = Cell.__new__(Cell)
        c.H = self.H
        c.E = self.E
        c.F = self.F
        c.flt = self.flt
        c.H_from = self.H_from
        c.E_from = self.E_from
        c.F_from = self.F_from
        c.F_from_off = self.F_from_off
        c.F_off_set = self.F_off_set
        c.H_from_pos = self.H_from_pos
        c.E_from_pos = self.E_from_pos
        c.rlen = self.rlen
        c.qlen = self.qlen
        c.lo = self.lo
        c.hi = self.hi
        c.lo_rc = self.lo_rc
        return c


def _cell_hash(c: Cell) -> int:
    return (kh_hash_uint64(c.lo) + kh_hash_uint64(c.hi)) & 0xFFFFFFFF


def _cell_eq(a: Cell, b: Cell) -> bool:
    return a.lo == b.lo and a.hi == b.hi


@dataclass
class SwHit:
    score: int = 0
    qlen: int = 0
    rlen: int = 0
    n_cigar: int = 0
    cs_len: int = 0
    blen: int = 0
    mlen: int = 0
    lo: int = 0
    hi: int = 0
    rseq: list = field(default_factory=list)
    cigar: list = field(default_factory=list)
    qoff: list = field(default_factory=list)
    cs: str = ""
    pos: list = field(default_factory=list)

    @property
    def n_qoff(self):
        return len(self.qoff)

    @property
    def n_pos(self):
        return len(self.pos)


@dataclass
class HapDiv:
    n_al: int = 0
    max_ed: int = 0
    n_hap: list = field(default_factory=lambda: [0] * (RB2_SW_MAX_ED + 1))


def _update_candset(h: KhashlSet, p: Cell) -> tuple[Cell, int]:
    """sw_update_candset (bwa-sw.c:265-284). Returns (stored cell, changed)."""
    itr, absent = h.put(p, copy_on_insert=True)
    if not absent:
        q = h.keys[itr]
        q.rlen = max(q.rlen, p.rlen)
        q.qlen = max(q.qlen, p.qlen)
        changed = 0
        if q.E < p.E:
            q.E, q.E_from, q.E_from_pos = p.E, p.E_from, p.E_from_pos
            changed |= 1 << 1
        if q.F < p.F:
            q.F, q.F_from = p.F, p.F_from
            changed |= 1 << 2
        if q.H < p.H:
            q.H, q.H_from = p.H, p.H_from
            changed |= 1 << 0
            if p.H_from == SW_FROM_H:
                q.H_from_pos = p.H_from_pos
        return q, changed
    return h.keys[itr], 7


def _heap_lt(a, b):  # reverse_lt on uint64-packed (score, id)
    return a > b


def _heap_insert1(heap: list, maxn: int, score: int, id_: int) -> int:
    x = (score << 32) | id_
    if len(heap) < maxn:
        heap.append(x)
        ks_heapup(heap, _heap_lt)
        return 1
    if x > heap[0]:
        heap[0] = x
        ks_heapdown(heap, 0, len(heap), _heap_lt)
        return 1
    return 0


def _opt_arr(opt: SwOpt) -> np.ndarray:
    return np.array(
        [opt.flag, opt.n_best, opt.min_sc, opt.end_len, opt.match, opt.mis, opt.e2e_drop,
         opt.gap_open, opt.gap_ext, opt.min_mem_len],
        dtype=np.int32,
    )


def _native_sw_lib():
    """The C++ DP core, or None (debug streams force the Python path so the
    --dbg-* golden traces keep coming from the reference implementation)."""
    import os

    if dbg_flag or os.environ.get("RB3JAX_NATIVE_SW", "1") == "0":
        return None
    from ..native import get_sw_lib

    return get_sw_lib()


def native_sw_available() -> bool:
    return _native_sw_lib() is not None


def _pline_arg(f: "DenseFMIndex"):
    """ctypes arg for the packed one-line rank records (ops/smem_native
    .pline_table) — built/persisted lazily for sidecar-backed indexes, where
    the records mmap hugepage-backed and the halved random-line footprint
    pays (PERF_NOTES.md round 4, in git history); None otherwise (bit-identical either way)."""
    import ctypes

    pl = getattr(f, "_pline_recs", None)
    if pl is None and getattr(f, "_sidecar_path", None):
        from ..ops.smem_native import pline_table

        pl = pline_table(f)
    return ctypes.c_void_p(pl.ctypes.data) if pl is not None else None


def _sw_core_native(lib, opt: SwOpt, f: DenseFMIndex, g: Dawg):
    """Run rb3t_sw_dp and rebuild rows as Cell lists for the Python backtrack."""
    import ctypes

    n_node, n_col = g.n_node, opt.n_best
    node_c = np.empty(n_node, dtype=np.int32)
    pre_off = np.zeros(n_node + 1, dtype=np.int32)
    pres: list[int] = []
    for i, nd in enumerate(g.node):
        node_c[i] = nd.c
        pres.extend(nd.pre)
        pre_off[i + 1] = len(pres)
    pre_flat = np.asarray(pres, dtype=np.int32)
    opt10 = _opt_arr(opt)
    row_len = np.zeros(n_node, dtype=np.int32)
    sz = n_node * n_col
    o64 = np.zeros((sz, 3), dtype=np.int64)
    o32 = np.zeros((sz, 5), dtype=np.int32)
    ou32 = np.zeros((sz, 3), dtype=np.uint32)
    ou8 = np.zeros((sz, 5), dtype=np.uint8)
    best = np.zeros(2, dtype=np.int64)
    P = ctypes.c_void_p
    lib.rb3t_sw_dp(
        P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data), P(f.acc.ctypes.data),
        int(f.n), P(opt10.ctypes.data), n_node, P(node_c.ctypes.data), P(pre_off.ctypes.data),
        P(pre_flat.ctypes.data), P(row_len.ctypes.data), P(o64.ctypes.data), P(o32.ctypes.data),
        P(ou32.ctypes.data), P(ou8.ctypes.data), P(best.ctypes.data), _pline_arg(f),
    )
    rl = row_len.tolist()
    l64, l32, lu32, lu8 = o64.tolist(), o32.tolist(), ou32.tolist(), ou8.tolist()
    rows = []
    for i in range(n_node):
        row = []
        for j in range(rl[i]):
            b = i * n_col + j
            c = Cell.__new__(Cell)
            c.lo, c.hi, c.lo_rc = l64[b]
            c.H, c.E, c.F, c.rlen, c.qlen = l32[b]
            c.H_from_pos, c.E_from_pos, c.F_from_off = lu32[b]
            c.H_from, c.E_from, c.F_from, c.F_off_set, c.flt = lu8[b]
            row.append(c)
        rows.append(row)
    return rows, int(best[0]), int(best[1])


def sw_core(opt: SwOpt, f: DenseFMIndex, g: Dawg, qseq: np.ndarray, want_rst: bool, want_anno: bool):
    """Returns (rows, best_pos, best_score). rows[i] = list[Cell]."""
    lib = _native_sw_lib()
    if lib is not None:
        return _sw_core_native(lib, opt, f, g)
    (out,) = sw_core_multi(opt, f, [g])
    return out


def sw_core_multi(opt: SwOpt, f: DenseFMIndex, gs: list[Dawg]):
    """Lock-step DP over W same-shaped DAWGs (e.g. hapdiv windows): the
    per-cell H/E extends and the F-closure rounds of ALL windows batch into
    single vectorized ranks, while each window's heap/candset logic runs its
    exact scalar sequence (bit-identical to one-window processing).

    Returns [(rows, best_pos, best_score), ...] per window."""
    n_col = opt.n_best
    W = len(gs)
    n_node = gs[0].n_node
    assert all(g.n_node == n_node for g in gs)

    class WState:
        __slots__ = ("g", "rows", "h", "fpar", "last_p", "best_score", "best_pos")

    ws: list[WState] = []
    for g in gs:
        w = WState()
        w.g = g
        w.rows = [[] for _ in range(n_node)]
        root = Cell()
        root.lo, root.hi, root.lo_rc = 0, int(f.acc[6]), 0
        root.H_from = SW_FROM_H
        w.rows[0].append(root)
        w.h = KhashlSet(_cell_hash, _cell_eq)
        w.h.resize(opt.n_best * 4)
        w.fpar = []
        w.last_p = root  # reference keeps a dangling pointer to the last visited cell
        w.best_score, w.best_pos = 0, 0
        ws.append(w)

    def extend_batch(cells) -> np.ndarray:
        iks = np.array([[c.lo, c.lo_rc, c.hi - c.lo] for c in cells], dtype=np.int64)
        return f.extend(iks, True)  # (n, 6, 3)

    for i in range(1, n_node):
        # ---- per-window pruning bound + cell collection -------------------
        batch: list[tuple[WState, int, int, Cell]] = []
        mms: dict[int, int] = {}
        for wi, w in enumerate(ws):
            t = w.g.node[i]
            w.h.clear()
            max_min_sc = 0
            if len(t.pre) > 1:
                n_cell = sum(len(w.rows[p]) for p in t.pre)
                if n_cell > opt.n_best:
                    ks_a = []
                    for pid in t.pre:
                        ks_a.extend(c.H for c in w.rows[pid])
                    max_min_sc = ks_ksmall(ks_a, opt.n_best, lt=lambda a, b: a > b)
                max_min_sc -= max(opt.gap_open + opt.gap_ext, opt.mis)
                if max_min_sc < 0:
                    max_min_sc = 0
            mms[wi] = max_min_sc
            for pid in t.pre:
                for k, p in enumerate(w.rows[pid]):
                    batch.append((w, pid, k, p))
        ok_batch = extend_batch([p for _, _, _, p in batch]) if batch else None

        # ---- H and E (scalar per window, batched extends) ------------------
        widx = {id(w): mms[x] for x, w in enumerate(ws)}
        for bi, (w, pid, k, p) in enumerate(batch):
            t = w.g.node[i]
            h = w.h
            max_min_sc = widx[id(w)]
            w.last_p = p
            if p.H + opt.match < max_min_sc:
                continue
            ok = ok_batch[bi]
            r = Cell()
            r.F_from_off = SW_F_UNSET
            r.H_from, r.H_from_pos, r.E_from_pos = SW_FROM_H, pid * n_col + k, UINT32_MAX
            for c in range(1, 6):
                sc = opt.match if (c == t.c and c != 5) else -opt.mis
                if ok[c][2] == 0:
                    continue
                if p.H + sc <= 0 or p.H + sc < max_min_sc:
                    continue
                if c != t.c and p.qlen < opt.end_len:
                    continue
                r.lo, r.hi, r.lo_rc = int(ok[c][0]), int(ok[c][0] + ok[c][2]), int(ok[c][1])
                r.H = p.H + sc
                r.rlen, r.qlen = p.rlen + 1, p.qlen + 1
                _update_candset(h, r)
            # E (insertion in query)
            if p.H - opt.gap_open > p.E:
                r.E_from, r.E = SW_FROM_OPEN, p.H - opt.gap_open
            else:
                r.E_from, r.E = SW_FROM_EXT, p.E
            r.E -= opt.gap_ext
            if r.E > 0 and r.E >= max_min_sc and p.qlen >= opt.end_len:
                # NB: the reference only sets lo/hi here; lo_rc keeps the
                # stale value from the last H candidate (bwa-sw.c:418)
                r.lo, r.hi = p.lo, p.hi
                r.H = r.E
                r.H_from = SW_FROM_E
                r.E_from_pos, r.H_from_pos = pid * n_col + k, UINT32_MAX
                r.rlen, r.qlen = p.rlen, p.qlen + 1
                _update_candset(h, r)

        # ---- top-n selection + F closure (lock-step rounds) ----------------
        class FCtx:
            __slots__ = ("heap", "fstack", "n_fpar", "fpar_base", "pending_z", "pending_r", "pending_min")

        fctxs: dict[int, FCtx] = {}
        for w in ws:
            w.rows[i] = []
            if w.h.count == 0:
                continue
            heap: list[int] = []
            for itr in w.h:
                _heap_insert1(heap, opt.n_best, w.h.keys[itr].H, itr)
            ks_heapsort(heap, _heap_lt)
            w.rows[i] = [w.h.keys[x & UINT32_MAX].copy() for x in heap]
            heap.reverse()  # remains a heap
            fc = FCtx()
            fc.heap = heap
            fc.n_fpar = 0
            fc.fpar_base = len(w.fpar)
            fc.pending_z = None
            fc.pending_r = None
            if w.last_p.qlen >= opt.end_len:
                fc.fstack = [w.rows[i][j].copy() for j in range(len(w.rows[i]) - 1, -1, -1) if w.rows[i][j].H > opt.gap_open + opt.gap_ext]
            else:
                fc.fstack = []
            fctxs[id(w)] = fc

        # rounds: each active window advances to its next extend-needing pop
        active = [w for w in ws if id(w) in fctxs and fctxs[id(w)].fstack]
        while active:
            todo: list[tuple[WState, FCtx]] = []
            for w in active:
                fc = fctxs[id(w)]
                while fc.fstack:
                    z = fc.fstack.pop()
                    minv = 0 if len(fc.heap) < opt.n_best else fc.heap[0] >> 32
                    r = Cell()
                    r.H_from_pos = r.E_from_pos = UINT32_MAX
                    r.F_from_off = SW_F_UNSET
                    if z.H - opt.gap_open > z.F:
                        r.F_from, r.F = SW_FROM_OPEN, z.H - opt.gap_open
                    else:
                        r.F_from, r.F = SW_FROM_EXT, z.F
                    r.F -= opt.gap_ext
                    r.H, r.H_from = r.F, SW_FROM_F
                    r.rlen, r.qlen = z.rlen + 1, z.qlen
                    if r.H <= minv:
                        continue
                    fc.pending_z, fc.pending_r, fc.pending_min = z, r, minv
                    todo.append((w, fc))
                    break
            if not todo:
                break
            oks = extend_batch([fc.pending_z for _, fc in todo])
            for (w, fc), ok in zip(todo, oks):
                z, r = fc.pending_z, fc.pending_r
                for c in range(1, 6):
                    if ok[c][2] == 0:
                        continue
                    r.lo, r.hi, r.lo_rc = int(ok[c][0]), int(ok[c][0] + ok[c][2]), int(ok[c][1])
                    q, changed = _update_candset(w.h, r)
                    if changed & (1 << 2):  # q->F has been updated
                        _heap_insert1(fc.heap, opt.n_best, r.H, UINT32_MAX)
                        w.fpar.append((z.lo, z.hi))
                        q.F_from, q.F_from_off = r.F_from, fc.fpar_base + fc.n_fpar
                        fc.n_fpar += 1
                        # NB: compares against the heap min captured at pop
                        # time, exactly like the scalar loop (bwa-sw.c:453,476)
                        if r.H - opt.gap_ext > fc.pending_min:
                            fc.fstack.append(q.copy())
            active = [w for w in ws if id(w) in fctxs and fctxs[id(w)].fstack]

        # ---- rebuild heap/row, track F, best, dedup ------------------------
        for w in ws:
            if id(w) not in fctxs:
                continue
            fc = fctxs[id(w)]
            heap = []
            for itr in w.h:
                _heap_insert1(heap, opt.n_best, w.h.keys[itr].H, itr)
            ks_heapsort(heap, _heap_lt)
            assert heap
            w.rows[i] = [w.h.keys[x & UINT32_MAX].copy() for x in heap]
            if fc.n_fpar > 0:
                _track_F(w.h, w.fpar, w.rows[i])
            if w.rows[i][0].H > w.best_score:
                w.best_score, w.best_pos = w.rows[i][0].H, i * n_col
            if i == n_node - 1:
                _cell_dedup(w.rows[i])
            if dbg_flag & DBG_SW:
                import sys

                t = w.g.node[i]
                sys.stderr.write(
                    "SW\t%d\t[%d,%d)\t%d\t%s\t%s\n"
                    % (i, t.lo, t.hi, len(w.rows[i]), ",".join(str(p) for p in t.pre),
                       ",".join("%d(%d)" % (cl.H, cl.qlen - cl.rlen) for cl in w.rows[i]))
                )
    return [(w.rows, w.best_pos, w.best_score) for w in ws]


def _track_F(h: KhashlSet, fpar: list, row: list[Cell]) -> None:
    """Compute F_from_off as a row-column index (bwa-sw.c:301-324)."""
    h.clear()
    for j, cell in enumerate(row):
        r = cell.copy()
        r.H = j  # reuse H as index
        h.put(r)
    for p in row:
        if p.F == 0 or p.F_from_off == SW_F_UNSET:
            continue
        r = Cell()
        r.lo, r.hi = fpar[p.F_from_off]
        k = h.get(r)
        if k != h.end():
            p.F_from_off = h.keys[k].H
            p.F_off_set = 1
        else:
            assert p.H_from != SW_FROM_F
            p.F_from_off = SW_F_UNSET


def _cell_dedup(row: list[Cell]) -> None:
    """Containment dedup of the final row (bwa-sw.c:197-216)."""
    if len(row) <= 1:
        return
    a = [0]
    for i in range(1, len(row)):
        p = row[i]
        contained = False
        for j in a:
            q = row[j]
            if q.lo_rc <= p.lo_rc and q.lo_rc + (q.hi - q.lo) >= p.lo_rc + (p.hi - p.lo):
                contained = True
                break
            if q.lo <= p.lo and q.hi >= p.hi:
                contained = True
                break
        if not contained:
            a.append(i)
        else:
            p.flt = 1


# ---------------------------------------------------------------------------
# Backtrack
# ---------------------------------------------------------------------------


def _ref_base(f: DenseFMIndex, lo: int) -> int:
    for c in range(1, 7):
        if f.acc[c] > lo:
            return c - 1
    return 5


def _backtrack1_core(opt: SwOpt, f: DenseFMIndex, g: Dawg, rows, pos: int, hit: SwHit, len_only: bool) -> int:
    n_col = opt.n_best
    last, last_op, ed = 0, -1, 0
    hit.score = rows[pos // n_col][pos % n_col].H
    hit.n_cigar = hit.rlen = hit.qlen = 0
    cig: list[int] = []
    rseq: list[int] = []
    while pos > 0:
        r = pos // n_col
        p = rows[r][pos % n_col]
        if dbg_flag & DBG_BT:
            import sys

            sys.stderr.write("BT\t%d\t%d\t%d\n" % (r, pos % n_col, p.H))
        x = p.H_from | p.E_from << 2 | p.F_from << 3
        state = (x & 0x3) if last == 0 else last
        ext = (x >> (state + 1)) & 1 if state in (1, 2) else 0
        c = _ref_base(f, p.lo)
        op = state
        if state == SW_FROM_H:
            op = 7 if c == g.node[r].c else 8
            pos = p.H_from_pos
            ed += op == 8
        elif state == SW_FROM_E:
            assert p.E > 0 and p.E_from_pos != UINT32_MAX
            pos = p.E_from_pos
            ed += 1
        else:  # SW_FROM_F
            assert p.F > 0 and p.F_off_set
            pos = r * n_col + p.F_from_off
            ed += 1
        # push state
        if not len_only:
            # sw_push_state writes rseq[rlen] BEFORE bumping rlen
            # (bwa-sw.c:63): an insertion (op 1) leaves rlen unchanged, so its
            # base is overwritten by the next reference-consuming op and never
            # appears in rseq
            if hit.rlen == len(rseq):
                rseq.append(c)
            else:
                rseq[hit.rlen] = c
            if last_op == op:
                cig[-1] += 1 << 4
            else:
                cig.append(1 << 4 | op)
        else:
            hit.n_cigar += 0 if last_op == op else 1
        if op in (7, 8):
            hit.qlen += 1
            hit.rlen += 1
        elif op == 1:
            hit.qlen += 1
        elif op == 2:
            hit.rlen += 1
        last_op = op
        last = state if (state in (1, 2) and ext) else 0
    if not len_only:
        hit.cigar = cig
        hit.rseq = rseq[: hit.rlen]  # drop a trailing insertion's write
        hit.n_cigar = len(cig)
    return ed


def _cs_core(hit: SwHit, qseq: np.ndarray) -> None:
    CH = "$acgtn"
    out = []
    x, y = 0, hit.qoff[0]
    for cval in hit.cigar:
        op, ln = cval & 0xF, cval >> 4
        if op == 7:
            out.append(f":{ln}")
            x += ln
            y += ln
        elif op == 8:
            for i in range(ln):
                out.append(f"*{CH[qseq[y+i]]}{CH[hit.rseq[x+i]]}")
            x += ln
            y += ln
        elif op == 1:
            out.append("+" + "".join(CH[qseq[y + i]] for i in range(ln)))
            y += ln
        elif op == 2:
            out.append("-" + "".join(CH[hit.rseq[x + i]] for i in range(ln)))
            x += ln
    hit.cs = "".join(out)
    hit.cs_len = len(hit.cs)


def _backtrack1(opt: SwOpt, f: DenseFMIndex, g: Dawg, qseq: np.ndarray, rows, pos: int) -> SwHit:
    hit = SwHit()
    n_col = opt.n_best
    p = g.node[pos // n_col]
    q = rows[pos // n_col][pos % n_col]
    hit.lo, hit.hi = q.lo, q.hi
    if p.hi >= 0:  # [lo,hi) is a SA interval on the query
        hit.qoff = [int(g.bwt.sa[k]) for k in range(p.lo, p.hi)]
    else:
        hit.qoff = [p.lo]
    # the reference walks twice (length-only then fill, bwa-sw.c:176-179);
    # replicate so --dbg-bt traces match byte-for-byte
    _backtrack1_core(opt, f, g, rows, pos, hit, True)
    _backtrack1_core(opt, f, g, rows, pos, hit, False)
    _cs_core(hit, qseq)
    hit.mlen = hit.blen = 0
    for cval in hit.cigar:
        op, ln = cval & 0xF, cval >> 4
        hit.blen += ln
        if op == 7:
            hit.mlen += ln
    return hit


def sw_backtrack(opt: SwOpt, f: DenseFMIndex, g: Dawg, qseq: np.ndarray, rows, best_pos: int, want_anno: bool):
    """Returns (list[SwHit] | None, HapDiv | None)."""
    n_col = opt.n_best
    if opt.flag & (RB3_SWF_E2E | RB3_SWF_HAPDIV):
        prow = rows[g.n_node - 1]
        if not prow:
            return ([] if not want_anno else None), (HapDiv() if want_anno else None)
        H0 = prow[0].H
        sel = [
            (i, q)
            for i, q in enumerate(prow)
            if not q.flt and q.H_from == SW_FROM_H and q.H >= opt.min_sc and (opt.e2e_drop < 0 or H0 - q.H <= opt.e2e_drop)
        ]
        if not sel:
            return ([] if not want_anno else None), (HapDiv() if want_anno else None)
        if want_anno:
            a = HapDiv()
            a.n_al = len(sel)
            tmp = SwHit()
            for i, q in sel:
                ed = _backtrack1_core(opt, f, g, rows, (g.n_node - 1) * n_col + i, tmp, True)
                a.max_ed = max(a.max_ed, ed)
                a.n_hap[min(ed, RB2_SW_MAX_ED)] += q.hi - q.lo
            return None, a
        hits = [_backtrack1(opt, f, g, qseq, rows, (g.n_node - 1) * n_col + i) for i, q in sel]
        return hits, None
    return [_backtrack1(opt, f, g, qseq, rows, best_pos)], None


# ---------------------------------------------------------------------------
# Public API (rb3_sw / rb3_hapdiv analogs)
# ---------------------------------------------------------------------------


def _attach_positions_multi(opt: SwOpt, f: DenseFMIndex, hits_lists: list[list["SwHit"]]) -> None:
    """Fill hit.pos via the sampled SA (bwa-sw.c:547-557) for many reads in
    ONE native locate call.

    len(ssa_multi(lo, hi, n)) == min(n, hi - lo) deterministically (every
    suffix locates), so the reference's sequential per-read `rest` budget can
    be computed upfront and every read's lookups batched together (10k
    per-read native calls cost more than the DP itself)."""
    if f.ssa is None:
        return
    from ..ssa_ops import ssa_multi_batch, ssa_multi_py

    reqs: list[tuple[int, int, int]] = []
    spans: list[tuple[int, int]] = []
    for hits in hits_lists:
        rest = opt.max_pos
        start = len(reqs)
        for hit in hits:
            n = rest if rest > 0 else 1
            reqs.append((hit.lo, hit.hi, n))
            rest -= min(n, hit.hi - hit.lo)
        spans.append((start, len(reqs)))
    if not reqs:
        return
    got = ssa_multi_batch(f, f.ssa, reqs)
    if got is None:
        got = [ssa_multi_py(f, f.ssa, *r) for r in reqs]
    for hits, (a, b) in zip(hits_lists, spans):
        for hit, pos in zip(hits, got[a:b]):
            hit.pos = pos


def _attach_positions(opt: SwOpt, f: DenseFMIndex, hits: list[SwHit]) -> None:
    _attach_positions_multi(opt, f, [hits])


def _parse_sw_blob(buf: bytes, n_reads: int) -> list[list[SwHit]]:
    off_table = np.frombuffer(buf, dtype=np.int64, count=n_reads + 1)
    base = (n_reads + 1) * 8
    mv = memoryview(buf)
    out: list[list[SwHit]] = []
    for r in range(n_reads):
        o = base + int(off_table[r])
        n_hits = int.from_bytes(mv[o : o + 8], "little")
        o += 8
        hits: list[SwHit] = []
        for _ in range(n_hits):
            score, qlen, rlen, mlen, blen, lo, hi, nc, nq, nrs, ncs = (
                int(v) for v in np.frombuffer(mv, dtype=np.int64, count=11, offset=o)
            )
            o += 88
            h = SwHit(score=score, qlen=qlen, rlen=rlen, n_cigar=nc, cs_len=ncs, blen=blen, mlen=mlen, lo=lo, hi=hi)
            h.cigar = np.frombuffer(mv, dtype=np.uint32, count=nc, offset=o).tolist()
            o += nc * 4
            h.qoff = np.frombuffer(mv, dtype=np.int32, count=nq, offset=o).tolist()
            o += nq * 4
            h.rseq = list(mv[o : o + nrs])
            o += nrs
            h.cs = bytes(mv[o : o + ncs]).decode()
            o += ncs
            o = (o + 7) & ~7
            hits.append(h)
        out.append(hits)
    return out


def rb3_sw_batch(opt: SwOpt, f: DenseFMIndex, seqs: list[np.ndarray]) -> list[list[SwHit]]:
    """Batch of reads through the native full-sw path (threaded); falls back
    to per-read Python when the native core is unavailable."""
    lib = _native_sw_lib()
    if lib is None:
        return [_rb3_sw_python(opt, f, s) for s in seqs]
    import ctypes
    import os

    from ..nt6 import NT6_TABLE

    n_reads = len(seqs)
    if n_reads == 0:
        return []
    flat = np.ascontiguousarray(NT6_TABLE[np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])])
    seq_off = np.zeros(n_reads + 1, dtype=np.int64)
    seq_off[1:] = np.cumsum([len(s) for s in seqs])
    opt10 = _opt_arr(opt)
    out_len = ctypes.c_int64(0)
    P = ctypes.c_void_p
    ptr = lib.rb3t_sw_batch(
        P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data), P(f.acc.ctypes.data),
        int(f.n), P(opt10.ctypes.data), P(flat.ctypes.data), P(seq_off.ctypes.data), n_reads,
        min(os.cpu_count() or 1, n_reads), ctypes.byref(out_len), _pline_arg(f),
    )
    try:
        raw = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.rb3t_buf_free(ptr)
    hits_lists = _parse_sw_blob(raw, n_reads)
    _attach_positions_multi(opt, f, hits_lists)
    return hits_lists


def _rb3_sw_python(opt: SwOpt, f: DenseFMIndex, seq: np.ndarray) -> list[SwHit]:
    from ..ops.smem_ref import smem_present

    if opt.min_mem_len > 0 and opt.min_mem_len > opt.end_len:
        if not smem_present(f, seq, opt.min_mem_len):
            return []
    if opt.flag & RB3_SWF_E2E:
        g = dawg_gen_linear(seq)
    else:
        g = dawg_gen(bwtl_gen(seq))
    rows, best_pos, best_score = sw_core(opt, f, g, seq, True, False)
    hits: list[SwHit] = []
    if best_score >= opt.min_sc:
        hits, _ = sw_backtrack(opt, f, g, seq, rows, best_pos, False)
        hits = hits or []
    _attach_positions(opt, f, hits)
    return hits


def rb3_sw(opt: SwOpt, f: DenseFMIndex, seq: np.ndarray) -> list[SwHit]:
    if _native_sw_lib() is not None:
        return rb3_sw_batch(opt, f, [seq])[0]
    return _rb3_sw_python(opt, f, seq)


def rb3_hapdiv(opt: SwOpt, f: DenseFMIndex, seq: np.ndarray) -> HapDiv | None:
    return rb3_hapdiv_multi(opt, f, [seq])[0]


def _hapdiv_native(lib, opt: SwOpt, f: DenseFMIndex, seqs: list[np.ndarray]) -> list[HapDiv | None]:
    import ctypes
    import os

    from ..nt6 import NT6_TABLE

    k = len(seqs[0])
    W = len(seqs)
    buf = np.ascontiguousarray(NT6_TABLE[np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])])
    opt10 = _opt_arr(opt)
    out = np.zeros((W, 10), dtype=np.int64)
    P = ctypes.c_void_p
    lib.rb3t_hapdiv_batch(
        P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data), P(f.acc.ctypes.data),
        int(f.n), P(opt10.ctypes.data), P(buf.ctypes.data), W, k, min(os.cpu_count() or 1, W), P(out.ctypes.data),
        _pline_arg(f),
    )
    res: list[HapDiv | None] = []
    for w in range(W):
        if out[w, 0] >= opt.min_sc:
            a = HapDiv()
            a.n_al, a.max_ed = int(out[w, 1]), int(out[w, 2])
            a.n_hap = [int(x) for x in out[w, 3:10]]
            res.append(a)
        else:
            res.append(None)
    return res


def rb3_hapdiv_multi(opt: SwOpt, f: DenseFMIndex, seqs: list[np.ndarray]) -> list[HapDiv | None]:
    """Batch hapdiv windows of equal length: all window DPs run lock-step so
    their extends share vectorized ranks (sw_core_multi); with the native DP
    core available the whole batch runs threaded in C++ instead."""
    if not seqs:
        return []
    lib = _native_sw_lib()
    if lib is not None and all(len(s) == len(seqs[0]) for s in seqs):
        return _hapdiv_native(lib, opt, f, seqs)
    gs = [dawg_gen_linear(s) for s in seqs]
    outs = sw_core_multi(opt, f, gs)
    res: list[HapDiv | None] = []
    for (rows, best_pos, best_score), g, seq in zip(outs, gs, seqs):
        if best_score >= opt.min_sc:
            _, anno = sw_backtrack(opt, f, g, seq, rows, best_pos, True)
            res.append(anno)
        else:
            res.append(None)
    return res
