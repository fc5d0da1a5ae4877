"""CLI glue for sw/hapdiv — output formats byte-matching search.c."""

from __future__ import annotations

import sys


from ..nt6 import char2nt6, revcomp
from ..seqio import iter_flat_batches, read_seqs


def _iter_named(fn: str, is_line: bool):
    """(name, nt6 array) records via the vectorized flat reader when the
    input qualifies, else the streaming parser."""
    fb = iter_flat_batches(fn, is_line, 1 << 28)
    if fb is not None:
        for names, flat, offs in fb:
            for i in range(len(names)):
                yield names[i], flat[offs[i] : offs[i + 1]]
    else:
        for rec in read_seqs(fn, is_line):
            yield rec.name, char2nt6(rec.seq)
from .bwasw import RB3_SWF_E2E, RB3_SWF_HAPDIV, RB3_SWF_KEEP_RS, SwOpt, rb3_hapdiv_multi, rb3_sw

_CIG = "MIDNSHP=X"
_NT = "$ACGTN"


def _opt_from_dict(d: dict) -> SwOpt:
    o = SwOpt()
    o.n_best = d["n_best"]
    o.min_sc = d["min_sc"]
    o.match = d["match"]
    o.mis = d["mis"]
    o.gap_open = d["gap_open"]
    o.gap_ext = d["gap_ext"]
    o.end_len = d["end_len"]
    o.min_mem_len = d["min_mem_len"]
    o.e2e_drop = d["e2e_drop"]
    o.r2cache_size = d["r2cache_size"]
    o.max_pos = d["max_pos"]
    if d["e2e"]:
        o.flag |= RB3_SWF_E2E
    if d["keep_rs"]:
        o.flag |= RB3_SWF_KEEP_RS
    return o


def _pos_stranded(sid, pos_entry, rlen):
    psid, ppos = pos_entry
    clen = int(sid.lens[psid >> 1])
    if (psid & 1) == 0:
        st, en = ppos, ppos + rlen
    else:
        st, en = clen - (ppos + rlen), clen - ppos
    return clen, st, en


def write_paf(out, f, h, name: str, qlen: int, keep_rs: bool) -> None:
    line = [f"{name}\t{qlen}\t{h.qoff[0]}\t{h.qoff[0] + h.qlen}"]
    if h.n_pos > 0:
        psid, ppos = h.pos[0]
        if f.sid is not None:
            clen, st, en = _pos_stranded(f.sid, h.pos[0], h.rlen)
            line.append(f"\t{'+-'[psid & 1]}\t{f.sid.names[psid >> 1]}\t{clen}\t{st}\t{en}")
        else:
            line.append(f"\t+\t{psid}\t*\t{ppos}\t{ppos + h.rlen}")
    else:
        line.append(f"\t*\t*\t{h.rlen}\t*\t*")
    line.append(f"\t{h.mlen}\t{h.blen}\t0")
    line.append(f"\tAS:i:{h.score}\tqh:i:{h.n_qoff}\trh:i:{h.hi - h.lo}\tcg:Z:")
    line.append("".join(f"{c >> 4}{_CIG[c & 0xF]}" for c in h.cigar))
    line.append(f"\tcs:Z:{h.cs}")
    if keep_rs:
        line.append("\trs:Z:" + "".join(_NT[c] for c in h.rseq))
    if h.n_pos > 1:
        tag = "ap" if f.sid is not None else "aq"
        line.append(f"\t{tag[0]}{tag[1]}:Z:")
        for pe in h.pos[1:]:
            psid, ppos = pe
            if f.sid is not None:
                _, st, _ = _pos_stranded(f.sid, pe, h.rlen)
                line.append(f"{f.sid.names[psid >> 1]},{'+-'[psid & 1]},{st};")
            else:
                line.append(f"{psid},{ppos};")
    out.write("".join(line) + "\n")


def write_all_hits(out, name: str, qlen: int, hits, strand: str, max_all_out: int) -> None:
    if max_all_out <= 0:
        max_all_out = 1 << 62
    tot = sum(h.hi - h.lo for h in hits)
    n_out = 0
    for h in hits:
        n_out += h.hi - h.lo
        if n_out >= max_all_out:
            break
    out.write(f"QS\t{name}\t{qlen}\t{len(hits)}\t{strand}\t{n_out}\t{tot}\n")
    n_out = 0
    for h in hits:
        out.write(f"QH\t{h.hi - h.lo}\t{h.score}\t{h.blen - h.mlen}\t{h.cs}\n")
        n_out += h.hi - h.lo
        if n_out >= max_all_out:
            break
    out.write("//\n")


def _emit_sw(out, f, sw_opts, name, q, hits, minus_hits) -> None:
    if sw_opts["write_all"]:
        write_all_hits(out, name, len(q), hits, "+", sw_opts["max_all_out"])
        if sw_opts["both_dir"]:
            write_all_hits(out, name, len(q), minus_hits, "-", sw_opts["max_all_out"])
    else:
        if hits:
            for h in hits:
                write_paf(out, f, h, name, len(q), sw_opts["keep_rs"])
        elif sw_opts["write_unmap"]:
            out.write(f"{name}\t{len(q)}\t*\t*\t*\t*\t*\t*\t*\t0\t0\t0\n")


def _mesh_from_spec(spec):
    """--mesh=DPxIDX for sw/hapdiv: windows/reads run data-parallel over the
    dp axis with tables replicated (use --mesh=N or Nx1; an idx axis only
    replicates work here, unlike mem's table-sharded extend)."""
    if not spec:
        return None
    from ..parallel.mesh import make_mesh

    dd, _, ii = spec.lower().partition("x")
    return make_mesh(int(dd), int(ii) if ii else 1)


def _warn_mesh_unused(mesh_spec, engine, dev_cache):
    """--mesh is honored only when THIS process builds a device engine; warn
    instead of silently dropping the user's sharding request (outputs stay
    byte-correct either way)."""
    if not mesh_spec:
        return
    if engine not in ("jax", "hybrid"):
        sys.stderr.write(f"[W::rb3jax] --mesh={mesh_spec} ignored with --engine={engine} (host engine)\n")
    elif dev_cache is not None:
        sys.stderr.write(f"[W::rb3jax] --mesh={mesh_spec} ignored: the resident server's cached engine answers (restart `rb3jax serve` with the mesh to shard it)\n")


def run_sw_cli(f, files, is_line, sw_opts, engine: str = "auto", dev_cache=None, mesh_spec=None) -> int:
    from . import bwasw as _bw

    if mesh_spec and engine == "auto":
        engine = "jax"  # --mesh only means anything on the device engine
    _warn_mesh_unused(mesh_spec, engine, dev_cache)
    opt = _opt_from_dict(sw_opts)
    out = sys.stdout
    if sw_opts["write_all"]:
        out.write("CC\tQS  queryName  queryLen  numHap\n")
        out.write("CC\tQH  refCount   score     editDist   cs   strand   nOut   totAln\n")
        out.write("CC\n")
    both = sw_opts["write_all"] and sw_opts["both_dir"]
    dev_engine = None
    hybrid_pool = None
    dev_share = 0.0
    if engine in ("jax", "hybrid"):
        if dev_cache is not None and hasattr(dev_cache, "sw_engine_for"):
            dev_engine = dev_cache.sw_engine_for(opt)  # resident server cache
        else:
            from .sw_jax import SwDeviceEngine

            dev_engine = SwDeviceEngine(f, opt, mesh=_mesh_from_spec(mesh_spec))
        if engine == "hybrid":
            import os as _os

            from concurrent.futures import ThreadPoolExecutor as _TPE

            hybrid_pool = _TPE(1)
            # the device share starts tiny and adapts to the measured rates
            dev_share = float(_os.environ.get("RB3JAX_SW_SPLIT", "0.01"))
    use_batch = _bw.native_sw_available() or dev_engine is not None
    BATCH = 4096  # threads idle during the serial PAF emit between native
    # calls; bigger batches amortize it (4.9 -> 4.7 s on 10k x 150 bp)
    seq_id = 0
    _rates = {"dev": None, "nat": None}

    def _sw_batch(qs):
        if dev_engine is None:
            return _bw.rb3_sw_batch(opt, f, qs)
        if hybrid_pool is None:
            return dev_engine.run(qs)
        # device + native concurrently on disjoint read slices, adaptive
        # split (same scheme as hapdiv --engine=hybrid)
        import time as _t

        nonlocal dev_share
        nd = int(len(qs) * dev_share)
        fut = hybrid_pool.submit(lambda: (_t.perf_counter(), dev_engine.run(qs[:nd]), _t.perf_counter())) if nd else None
        t0 = _t.perf_counter()
        nat = _bw.rb3_sw_batch(opt, f, qs[nd:])
        t1 = _t.perf_counter()
        if len(qs) > nd:
            _rates["nat"] = (len(qs) - nd) / max(t1 - t0, 1e-6)
        if fut is not None:
            d0, dev, d1 = fut.result()
            _rates["dev"] = nd / max(d1 - d0, 1e-6)
        else:
            dev = []
        if _rates["dev"] and _rates["nat"]:
            dev_share = min(0.5, max(0.002, _rates["dev"] / (_rates["dev"] + _rates["nat"])))
        return list(dev) + list(nat)

    def compute(batch):
        qs = [q for _, q in batch]
        if both:
            allq = qs + [revcomp(q) for q in qs]
            allh = _sw_batch(allq)
            return allh[: len(qs)], allh[len(qs) :]
        return _sw_batch(qs), [None] * len(qs)

    def emit(batch, fwd, rev):
        for (name, q), hits, mh in zip(batch, fwd, rev):
            _emit_sw(out, f, sw_opts, name, q, hits, mh)

    # pipeline like mem/hapdiv: the native DP (GIL-released) of batch i+1
    # overlaps batch i's PAF emit
    from concurrent.futures import ThreadPoolExecutor

    _ex = ThreadPoolExecutor(1)
    inflight: list = []

    def flush(batch):
        inflight.append((batch, _ex.submit(compute, batch)))
        while len(inflight) > 1:
            b0, fut = inflight.pop(0)
            emit(b0, *fut.result())

    batch: list = []
    for fn in files:
        from ..cli import seq_openable

        if not seq_openable(fn):
            # search.c:571-575: report and stop processing further files
            print(f"ERROR: failed to load the sequence file '{fn}'", file=sys.stderr)
            break
        for name0, q in _iter_named(fn, is_line):
            seq_id += 1
            name = name0 if name0 else f"seq{seq_id}"
            if _bw.dbg_flag & _bw.DBG_QNAME:
                sys.stderr.write(f"Q\t{name}\t0\n")
            if use_batch:
                batch.append((name, q))
                if len(batch) >= BATCH:
                    flush(batch)
                    batch = []
            else:
                hits = rb3_sw(opt, f, q)
                mh = rb3_sw(opt, f, revcomp(q)) if both else None
                _emit_sw(out, f, sw_opts, name, q, hits, mh)
    if batch:
        flush(batch)
    while inflight:
        b0, fut = inflight.pop(0)
        emit(b0, *fut.result())
    _ex.shutdown()
    if hybrid_pool is not None:
        hybrid_pool.shutdown()
    return 0


def run_hapdiv_cli(f, files, is_line, sw_opts, k, w, engine: str = "auto", dev_cache=None, mesh_spec=None) -> int:
    if mesh_spec and engine == "auto":
        engine = "jax"
    _warn_mesh_unused(mesh_spec, engine, dev_cache)
    opt = _opt_from_dict(sw_opts)
    opt.flag |= RB3_SWF_E2E | RB3_SWF_HAPDIV
    out = sys.stdout
    seq_id = 0
    from .bwasw import HapDiv, native_sw_available

    # Windows are batched ACROSS reads into one native DP call: short reads
    # contribute only 1-2 windows each, and a per-read call would pay ctypes
    # + thread-pool spawn 100k times (measured ~5x the reference wall on
    # 100k x 150 bp).  Window results are run-length merged per sequence
    # (search.c:327-353); batching cannot change any output row.
    CAP = 16384 if native_sw_available() else 64
    dev_engine = None
    hybrid_pool = None
    dev_share = 0.0
    if engine in ("jax", "hybrid"):
        if dev_cache is not None and hasattr(dev_cache, "hapdiv_engine_for"):
            dev_engine = dev_cache.hapdiv_engine_for(opt)  # resident server cache
        else:
            from .hapdiv_jax import HapdivDeviceEngine

            dev_engine = HapdivDeviceEngine(f, opt, mesh=_mesh_from_spec(mesh_spec))
        CAP = dev_engine.lanes
        if engine == "hybrid":
            # device and native host engines run CONCURRENTLY on disjoint
            # window slices: the native DP releases the GIL on its threads
            # while the device chews its share.  The split ratio adapts to
            # the measured rates.
            import os as _os

            from concurrent.futures import ThreadPoolExecutor as _TPE

            hybrid_pool = _TPE(1)
            dev_share = float(_os.environ.get("RB3JAX_HAPDIV_SPLIT", "0.05"))
            CAP = 4 * dev_engine.lanes

    _rates = {"dev": None, "nat": None}

    def _compute(batch_wins):
        if dev_engine is None:
            return rb3_hapdiv_multi(opt, f, batch_wins)
        if hybrid_pool is None:
            return dev_engine.run(batch_wins)
        import time as _t

        nonlocal dev_share
        nd = int(len(batch_wins) * dev_share)
        dev_part = batch_wins[:nd]
        fut = hybrid_pool.submit(lambda: (_t.perf_counter(), dev_engine.run(dev_part), _t.perf_counter())) if dev_part else None
        t0 = _t.perf_counter()
        nat = rb3_hapdiv_multi(opt, f, batch_wins[nd:])
        t1 = _t.perf_counter()
        if len(batch_wins) > nd:
            _rates["nat"] = (len(batch_wins) - nd) / max(t1 - t0, 1e-6)
        if fut is not None:
            d0, dev, d1 = fut.result()
            _rates["dev"] = nd / max(d1 - d0, 1e-6)
        else:
            dev = []
        if _rates["dev"] and _rates["nat"]:
            dev_share = min(0.5, max(0.02, _rates["dev"] / (_rates["dev"] + _rates["nat"])))
        return list(dev) + list(nat)
    pend: list[tuple[str, list[int]]] = []
    wins: list = []
    from concurrent.futures import ThreadPoolExecutor

    # pipeline: the native DP releases the GIL, so the previous super-batch's
    # emit and the next one's window staging overlap its compute
    _ex = ThreadPoolExecutor(1)
    _inflight: list = []  # [(pend, future)]

    def _emit(done_pend, rs):
        pos = 0
        for name, offs in done_pend:
            results = []
            for j in offs:
                r = rs[pos]
                pos += 1
                if r is None:
                    r = HapDiv()
                results.append((j, (r.n_al, r.max_ed, tuple(r.n_hap))))
            # merge identical consecutive windows
            i0 = 0
            for i1 in range(1, len(results) + 1):
                if i1 == len(results) or results[i1][1] != results[i0][1]:
                    off0 = results[i0][0]
                    off_last = results[i1 - 1][0]
                    n_al, max_ed, n_hap = results[i0][1]
                    row = f"{name}\t{off0}\t{off_last + k}\t{n_al}\t{max_ed}\t" + "\t".join(str(x) for x in n_hap)
                    out.write(row + "\n")
                    i0 = i1

    def flush():
        nonlocal pend, wins
        if not pend:
            return
        _inflight.append((pend, _ex.submit(_compute, wins)))
        pend, wins = [], []
        while len(_inflight) > 1:  # emit everything but the batch in flight
            done_pend, fut = _inflight.pop(0)
            _emit(done_pend, fut.result())

    for fn in files:
        from ..cli import seq_openable

        if not seq_openable(fn):
            print(f"ERROR: failed to load the sequence file '{fn}'", file=sys.stderr)
            break
        for name0, q in _iter_named(fn, is_line):
            seq_id += 1
            name = name0 if name0 else f"seq{seq_id}"
            if len(q) < k:
                continue
            offs = list(range(0, len(q) - k + 1, w))
            pend.append((name, offs))
            wins.extend(q[j : j + k] for j in offs)
            if len(wins) >= CAP:
                flush()
    flush()
    while _inflight:
        done_pend, fut = _inflight.pop(0)
        _emit(done_pend, fut.result())
    _ex.shutdown()
    if hybrid_pool is not None:
        hybrid_pool.shutdown()
    return 0
