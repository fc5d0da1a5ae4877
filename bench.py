#!/usr/bin/env python
"""Benchmark: batched SMEM search throughput on a synthetic mtb-like pangenome
index, vs the reference ropebwt3 binary on all host cores.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Workload (BASELINE.json config 3 analog): N_GENOMES mutated copies of a
GENOME_LEN random genome, indexed double-strand; N_READS 150 bp reads with 1%
errors; `mem -l31` SMEM finding.  Needs an accelerator: with none it exits
non-zero.  vs_baseline is measured against the reference binary (built from
its source checkout when present) running with all host cores (wall-clock),
cached in .bench/.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

T0 = time.time()
# Wall-clock budget for the WHOLE bench process (round-4 lesson: the driver
# killed the un-budgeted scale curve at the 8G stage and the official record
# became rc=124/parsed=null — one slow stage must never forfeit the
# scoreboard).  The headline record prints as soon as the 64M measurements
# land; each later stage re-prints an enriched record, and stages that don't
# fit the remaining budget are skipped with a log line.
DEADLINE = float(os.environ.get("RB3JAX_BENCH_DEADLINE", "600"))

_LATEST: dict | None = None
_PRINTED = False


def remaining() -> float:
    return DEADLINE - (time.time() - T0)


def emit(rec: dict) -> None:
    """Record the current result snapshot.  stdout stays SILENT until exit:
    the driver contract is ONE JSON line, so the line prints exactly once —
    at normal completion, or from the SIGTERM handler if the driver times
    us out mid-stage (the handler runs even while the main thread waits on
    a compile).  Each stage only upgrades the
    snapshot, so whatever moment the run ends, the line is current."""
    global _LATEST
    _LATEST = rec
    log(f"record updated: {json.dumps(rec)[:160]} ...")


def _flush_record() -> bool:
    global _PRINTED
    if _LATEST is not None and not _PRINTED:
        _PRINTED = True
        print(json.dumps(_LATEST), flush=True)
    return _PRINTED


def _on_term(signum, frame):
    # driver timeout: print the newest record snapshot as the one line
    ok = _flush_record()
    sys.stderr.write(f"[bench] signal {signum}: exiting with the latest record ({'ok' if ok else 'none yet'})\n")
    os._exit(0 if ok else 1)


signal.signal(signal.SIGTERM, _on_term)

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, ".bench")
REF_SRC = "/root/reference"
REF_BIN_DIR = "/tmp/rb3_ref_bin"
REF_BIN = os.path.join(REF_BIN_DIR, "ropebwt3")

N_GENOMES = 16
GENOME_LEN = 2_000_000
DIVERGENCE = 0.01
N_READS = 100_000
READ_LEN = 150
READ_ERR = 0.01
MIN_LEN = 31
SEED = 20260817


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def ensure_ref_bin():
    if os.path.exists(REF_BIN):
        return REF_BIN
    if not os.path.isdir(REF_SRC):
        return None
    try:
        shutil.copytree(REF_SRC, REF_BIN_DIR, dirs_exist_ok=True)
        subprocess.run(["make", "-j4"], cwd=REF_BIN_DIR, check=True, capture_output=True)
        return REF_BIN
    except Exception as e:
        log(f"reference build failed: {e}")
        return None


def ensure_corpus():
    os.makedirs(BENCH, exist_ok=True)
    fa = os.path.join(BENCH, "genomes.fa")
    reads_fa = os.path.join(BENCH, "reads.fa")
    reads_npy = os.path.join(BENCH, "reads.npy")
    if os.path.exists(fa) and os.path.exists(reads_npy):
        return fa, reads_fa, np.load(reads_npy)
    log("generating corpus ...")
    rng = np.random.default_rng(SEED)
    base = rng.integers(1, 5, GENOME_LEN).astype(np.uint8)
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    with open(fa, "w") as f:
        for i in range(N_GENOMES):
            s = base.copy()
            mut = rng.random(GENOME_LEN) < DIVERGENCE
            s[mut] = rng.integers(1, 5, int(mut.sum()))
            f.write(f">g{i}\n")
            f.write(alpha[s].tobytes().decode())
            f.write("\n")
    starts = rng.integers(0, GENOME_LEN - READ_LEN, N_READS)
    reads = base[starts[:, None] + np.arange(READ_LEN)]
    err = rng.random(reads.shape) < READ_ERR
    reads = np.where(err, rng.integers(1, 5, reads.shape), reads).astype(np.uint8)
    np.save(reads_npy, reads)
    with open(reads_fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n")
            f.write(alpha[r].tobytes().decode())
            f.write("\n")
    return fa, reads_fa, reads


def ensure_index(fa):
    fmd = os.path.join(BENCH, "idx.fmd")
    if not os.path.exists(fmd):
        ref = ensure_ref_bin()
        log("building index ...")
        if ref:
            subprocess.run([ref, "build", "-t4", "-do", fmd, fa], check=True, capture_output=True)
        else:
            subprocess.run([sys.executable, "-m", "ropebwt3_jax", "build", "-do", fmd, fa], check=True)
    return fmd


def ensure_dense(fmd):
    """Load through the production sidecar path (`<idx>.dense`, v2 = 2 MiB
    aligned + hugepage-mapped): the bench measures the same table backing
    the CLI runs with.  First call decodes the FMD and writes the sidecar."""
    from ropebwt3_jax.cli import load_index

    return load_index(fmd)


def _run_timed(cmd, **kw):
    """Run `cmd`; return (wall_s, cpu_util) where cpu_util is the child's
    CPU time over wall over cores — the contamination detector: a reference
    timed while other work ran gets starved and its utilization collapses
    (round-3 lesson: a contaminated cache read 2.8x too slow and burned an
    hour; caches are now refused unless recorded near-full-utilization)."""
    import resource

    ncpu = os.cpu_count() or 4
    r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.time()
    subprocess.run(cmd, **kw)
    wall = time.time() - t0
    r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
    return wall, cpu / wall / ncpu if wall > 0 else 0.0


MIN_REF_UTIL = 0.70  # -t4 mem/sw/hapdiv pipelines run ~95-100% per core solo


def _trusted(cache):
    """Load a reference-timing cache only if it certifies a clean recording."""
    if not os.path.exists(cache):
        return None
    j = json.load(open(cache))
    if j.get("cpu_util", 0.0) < MIN_REF_UTIL:
        log(f"refusing untrusted reference cache {cache} (cpu_util={j.get('cpu_util')}); re-timing")
        return None
    return j


def ref_baseline(fmd, reads_fa):
    """Reference wall-clock on this machine, all cores; cached (the cache is
    refused and re-timed if it was recorded under CPU contention)."""
    cache = os.path.join(BENCH, "ref_timing.json")
    j = _trusted(cache)
    if j:
        return j
    ref = ensure_ref_bin()
    if not ref:
        return None
    ncpu = os.cpu_count() or 4
    log(f"timing reference mem -t{ncpu} (best-of-2, solo) ...")
    wall, util = float("inf"), 0.0
    for _ in range(2):
        w, u = _run_timed([ref, "mem", f"-t{ncpu}", f"-l{MIN_LEN}", fmd, reads_fa], check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        if w < wall:
            wall, util = w, u
    d = {"wall_s": wall, "threads": ncpu, "reads_per_s": N_READS / wall, "mbp_per_s": N_READS * READ_LEN / wall / 1e6, "cpu_util": round(util, 3)}
    json.dump(d, open(cache, "w"))
    if util < MIN_REF_UTIL:
        log(f"WARNING: reference timing recorded at cpu_util={util:.2f} (<{MIN_REF_UTIL}): machine busy; this cache will be re-timed next run")
    return d


def device_info() -> dict:
    """The accelerator this bench measures, probed in a child process so
    this process only starts its backend once it means to use it.  Exits
    when JAX finds no accelerator: a CPU number is never reported as a
    device number."""
    r = subprocess.run(
        [sys.executable, "-c", "import jax, json; d = jax.devices(); "
         "print(json.dumps({'platform': d[0].platform, 'kind': d[0].device_kind, 'count': len(d)}))"],
        capture_output=True, text=True,
    )
    info = json.loads(r.stdout.strip().splitlines()[-1]) if r.returncode == 0 and r.stdout.strip() else None
    if info is None or info["platform"] == "cpu":
        log(f"no accelerator (probe rc={r.returncode}: {r.stderr.strip()[-300:]}); nothing to measure")
        sys.exit(2)
    return info


def measure_index(f, reads, passes=3, occ="dense"):
    """Device packed-kernel + native + measured-hybrid throughput on dense
    index `f` (same kernel shapes as main).  Returns a dict of walls.
    occ="rb" uses the run-aware compressed device rows (ops/runblock.py,
    the beyond-HBM capacity format; ~0.16 B/sym at 8 Gsym vs 0.75 dense)."""
    import threading

    import jax
    import jax.numpy as jnp

    from ropebwt3_jax.ops.rank import DeviceIndex
    from ropebwt3_jax.ops.smem import smem_tg_batch

    if occ == "rb":
        from ropebwt3_jax.ops import runblock

        idx = runblock.from_dense(f)
    else:
        idx = DeviceIndex.from_dense(f)
    LANES, LBUF, RCAP, M = 2048, 4096, 32, 64
    NPL = LBUF // (READ_LEN + 1)
    per = LANES * NPL
    # uniform-stride packing (round 3): equal-length reads need no per-slot
    # seg records — off = seg*(READ_LEN+1) inside the kernel (+25% at 64M)
    stride_u = jax.device_put(jnp.full((LANES,), READ_LEN + 1, jnp.int32))
    qlen = jnp.zeros(LANES, jnp.int32)

    def stage(rds):
        chunks = []
        for c0 in range(0, len(rds), per):
            got = rds[c0 : c0 + per]
            block = np.zeros((LANES, LBUF), np.uint8)
            ns = np.zeros(LANES, np.int32)
            for t, rd in enumerate(got):
                lane, slot = t % LANES, t // LANES
                block[lane, slot * (READ_LEN + 1) : slot * (READ_LEN + 1) + READ_LEN] = rd
                ns[lane] = max(ns[lane], slot + 1)
            chunks.append((jax.device_put(block), jax.device_put(jnp.asarray(ns))))
        jax.block_until_ready([c[0] for c in chunks])
        return chunks

    def run(ch):
        rlen = jnp.where(ch[1] > 0, jnp.int32(READ_LEN), jnp.int32(0))
        return smem_tg_batch(
            idx, ch[0], qlen, min_occ=1, min_len=MIN_LEN, max_mems=M,
            max_iters=RCAP * LBUF + 64, unroll=2,
            uniform_segments=(stride_u, rlen, ch[1]),
        )

    chunks = stage(reads)
    np.asarray(run(chunks[0])[1])  # warmup/compile
    wall, tot_mems = float("inf"), 0
    for p in range(passes):
        t0 = time.time()
        tm = 0
        for ch in chunks:
            mems, n_mem, _ = run(ch)
            tm += int(np.asarray(n_mem).sum())
        dt = time.time() - t0
        if dt < wall:
            wall, tot_mems = dt, tm
    out = {"device_wall": wall, "mems": tot_mems}

    # native engine on the same workload, then the measured hybrid: device
    # and native chew disjoint read slices CONCURRENTLY (the production
    # `mem --engine=hybrid` split); device share follows the solo rates,
    # rounded to whole staged chunks
    try:
        from ropebwt3_jax.ops.smem_native import smem_tg_flat_native

        flat = np.ascontiguousarray(reads.reshape(-1))
        offs = np.arange(len(reads) + 1, dtype=np.int64) * READ_LEN
        # contamination guard on OUR side too (r4 lesson: the official 2.4G
        # native sample was starved 43% low by concurrent work; the ref
        # timings had a cpu_util trust check but ours didn't): the threaded
        # engine solo runs ~full-core — if even the best pass measured below
        # 70% utilization, retry up to 2 extra passes and record the best.
        ncpu = os.cpu_count() or 4
        nwall, nutil, attempts = float("inf"), 0.0, 0
        while attempts < 4:
            c0, t0 = time.process_time(), time.time()
            smem_tg_flat_native(f, flat, offs, 1, MIN_LEN)
            w = time.time() - t0
            u = (time.process_time() - c0) / w / ncpu if w > 0 else 0.0
            attempts += 1
            if w < nwall:
                nwall, nutil = w, u
            if attempts >= 2 and nutil >= 0.70:
                break
            if attempts >= 2:
                log(f"native sample cpu_util={nutil:.2f} (<0.70): machine busy, retrying")
        out["native_wall"] = nwall
        out["native_cpu_util"] = round(nutil, 3)

        share = (1 / wall) / (1 / wall + 1 / nwall)
        nd = int(len(reads) * share)  # partial last chunk stages fine
        chunks_h = stage(reads[:nd])
        sub = np.ascontiguousarray(flat[nd * READ_LEN :])
        offs_h = np.arange(len(reads) - nd + 1, dtype=np.int64) * READ_LEN

        def dev_part():
            for ch in chunks_h:
                np.asarray(run(ch)[1])

        hwall = float("inf")
        for _ in range(2):
            th = threading.Thread(target=dev_part)
            t0 = time.time()
            th.start()
            if len(sub):
                smem_tg_flat_native(f, sub, offs_h, 1, MIN_LEN)
            th.join()
            hwall = min(hwall, time.time() - t0)
        out["hybrid_wall"] = hwall
        out["hybrid_dev_share"] = round(nd / len(reads), 3)
    except Exception as e:
        log(f"native/hybrid measurement skipped: {e}")
    return out


def _ref_scale_timing(scale: str, label: str) -> dict | None:
    """Trusted reference `mem` timing for a scale dir (re-times solo if the
    cache is missing/contaminated and the budget allows)."""
    d = os.path.join(BENCH, scale)
    rnpy = os.path.join(d, "reads.npy")
    rt = os.path.join(d, "ref_timing.json")
    j = _trusted(rt)
    if j is not None:
        return j
    rb = ensure_ref_bin()
    s_fmd, s_fa = os.path.join(d, "idx.fmd"), os.path.join(d, "reads.fa")
    if not (rb and os.path.exists(s_fmd) and os.path.exists(s_fa)):
        return None
    if remaining() < 60:
        log(f"skipping {label}: ref re-time doesn't fit the budget ({remaining():.0f}s left)")
        return None
    ncpu = os.cpu_count() or 4
    log(f"re-timing reference at {label} (best-of-2, solo) ...")
    wall, util = float("inf"), 0.0
    for _ in range(2):
        w, u = _run_timed([rb, "mem", f"-t{ncpu}", f"-l{MIN_LEN}", s_fmd, s_fa], check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        if w < wall:
            wall, util = w, u
    nr = len(np.load(rnpy, mmap_mode="r"))
    j = {"wall_s": wall, "threads": ncpu, "reads_per_s": nr / wall, "cpu_util": round(util, 3)}
    json.dump(j, open(rt, "w"))
    return j


def scale_stage(scale: str, label: str) -> dict | None:
    """One scale measurement (640M / 1.34G / 2.4G-int64 / 8G); returns the
    record entry or None.  big8g serves through the run-aware compressed rows
    (occ=rb, 0.16 B/sym): the dense rows' 6 GB device transfer does not fit a
    budgeted stage, and rb is the production capacity mode at that size."""
    d = os.path.join(BENCH, scale)
    rnpy = os.path.join(d, "reads.npy")
    if not (os.path.exists(os.path.join(d, "idx.fmd")) and os.path.exists(rnpy)):
        return None
    ref = _ref_scale_timing(scale, label)
    if ref is None:
        return None
    f = ensure_dense(os.path.join(d, "idx.fmd"))
    reads_s = np.load(rnpy)
    occ = "rb" if scale == "big8g" else "dense"
    log(f"scale {label}: n={f.n:,} (occ={occ}) ...")
    res = measure_index(f, reads_s, occ=occ)
    n = len(reads_s)
    ours = n / res["device_wall"]
    ent = {
        "ours_reads_per_s": round(ours, 1),
        "ref_t4_reads_per_s": round(ref["reads_per_s"], 1),
        "ratio": round(ours / ref["reads_per_s"], 3),
    }
    if occ != "dense":
        ent["occ"] = occ
    if "native_wall" in res:
        ent["native_reads_per_s"] = round(n / res["native_wall"], 1)
    if "hybrid_wall" in res:
        ent["hybrid_reads_per_s"] = round(n / res["hybrid_wall"], 1)
        ent["hybrid_ratio"] = round(n / res["hybrid_wall"] / ref["reads_per_s"], 3)
    log(f"scale {label}: device {ours:,.0f} | native {ent.get('native_reads_per_s', 0):,.0f} | hybrid {ent.get('hybrid_reads_per_s', 0):,.0f} vs ref {ref['reads_per_s']:,.0f} ({ent['ratio']}x device, {ent.get('hybrid_ratio', 0)}x hybrid)")
    return ent


def align_stage(scale: str, label: str) -> dict | None:
    """BWA-SW + hapdiv at one scale (BASELINE configs 4/5): e2e CLI wall of
    `sw -N25 --no-ssa` and `hapdiv -a101` on 10k corpus reads vs the
    reference -t4.  Outputs byte-compared; reference timings cached."""
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    ref = ensure_ref_bin()
    N_SW = 10000  # engine-dominated (2k reads were fixed-cost-bound; round 4)
    d = os.path.join(BENCH, scale)
    fmd = os.path.join(d, "idx.fmd")
    rnpy = os.path.join(d, "reads.npy")
    if not (os.path.exists(fmd) and os.path.exists(rnpy) and ref):
        return None
    sub_fa = os.path.join(d, "reads_sw10k.fa")
    if not os.path.exists(sub_fa):
        rd = np.load(rnpy)[:N_SW]
        with open(sub_fa, "w") as fh:
            for i, r in enumerate(rd):
                fh.write(f">r{i}\n" + alpha[r].tobytes().decode() + "\n")
    res = {}
    for cmd, args_r in (("sw", ["sw", "-t4", "-N25", "--no-ssa"]), ("hapdiv", ["hapdiv", "-t4", "-a101"])):
        if remaining() < 45:
            log(f"skipping align {label} {cmd}: {remaining():.0f}s left")
            break
        cache = os.path.join(d, f"ref_{cmd}10k.json")
        rj = _trusted(cache)
        if rj is None:
            import resource

            r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
            t0 = time.time()
            rr = subprocess.run([ref] + args_r + [fmd, sub_fa], capture_output=True)
            wall = time.time() - t0
            r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
            util = ((r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)) / wall / (os.cpu_count() or 4)
            rj = {"wall_s": wall, "cpu_util": round(util, 3)}
            json.dump(rj, open(cache, "w"))
            with open(os.path.join(d, f"ref_{cmd}10k.out"), "wb") as fh:
                fh.write(rr.stdout)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        wall = float("inf")
        ours_out = b""
        for _ in range(2):
            t0 = time.time()
            orun = subprocess.run(
                [sys.executable, "-m", "ropebwt3_jax"] + args_r + ["--engine=native", fmd, sub_fa],
                capture_output=True, env=env,
            )
            wall = min(wall, time.time() - t0)
            ours_out = orun.stdout
        refout = os.path.join(d, f"ref_{cmd}10k.out")
        equal = os.path.exists(refout) and open(refout, "rb").read() == ours_out
        unit = N_SW / wall
        res[cmd] = {
            "ours_per_s": round(unit, 1), "ref_t4_per_s": round(N_SW / rj["wall_s"], 1),
            "ratio": round(rj["wall_s"] / wall, 3), "byte_equal": bool(equal),
        }
        log(f"align {label} {cmd}: ours {wall:.2f}s vs ref {rj['wall_s']:.2f}s ({res[cmd]['ratio']}x, byte_equal={equal})")
    return res or None


def main():
    dev = device_info()
    fa, reads_fa, reads = ensure_corpus()
    fmd = ensure_index(fa)
    ref = ref_baseline(fmd, reads_fa)
    f = ensure_dense(fmd)
    log(f"index: n={f.n:,} symbols")
    log(f"measuring on {dev['platform']} ({dev['kind']} x{dev['count']}): device kernel, native engine, measured hybrid split ...")
    res = measure_index(f, reads)
    dev_rps = N_READS / res["device_wall"]
    nat_rps = N_READS / res["native_wall"] if "native_wall" in res else None
    hyb_rps = N_READS / res["hybrid_wall"] if "hybrid_wall" in res else None
    log(f"device kernel: {res['device_wall']:.2f}s = {dev_rps:,.0f} reads/s ({res['mems']} MEMs)")
    if nat_rps:
        log(f"native engine: {res['native_wall']:.2f}s = {nat_rps:,.0f} reads/s")
    if hyb_rps:
        log(f"hybrid (dev share {res['hybrid_dev_share']}): {res['hybrid_wall']:.2f}s = {hyb_rps:,.0f} reads/s")
    if ref:
        log(f"reference (-t{ref['threads']}): {ref['wall_s']:.2f}s = {ref['reads_per_s']:,.0f} reads/s")
    # headline = the best measured single-machine throughput: the device and
    # the host cores work CONCURRENTLY on disjoint read slices
    # (`mem --engine=hybrid`, golden-tested) when that beats the device alone
    best = max(x for x in (dev_rps, hyb_rps) if x)
    engine_used = "hybrid" if hyb_rps and hyb_rps >= dev_rps else "device"
    vs = best / ref["reads_per_s"] if ref else float("nan")
    rec = {
        "metric": "smem_mem31_reads_per_s", "value": round(best, 1), "unit": "reads/s",
        "vs_baseline": round(vs, 3) if vs == vs else None, "engine": engine_used,
        "device": dev, "device_reads_per_s": round(dev_rps, 1),
    }
    if nat_rps:
        rec["native_reads_per_s"] = round(nat_rps, 1)
    if hyb_rps:
        rec["hybrid_reads_per_s"] = round(hyb_rps, 1)
        rec["hybrid_dev_share"] = res["hybrid_dev_share"]
    # the headline record lands NOW — every later stage only enriches it
    # (round-4 lesson: the record must never depend on the slowest stage)
    emit(rec)
    if os.environ.get("RB3JAX_BENCH_FAST") == "1":
        return

    if ref:
        rec["scale"] = {"64M": {
            "ours_reads_per_s": rec["device_reads_per_s"],
            "ref_t4_reads_per_s": round(ref["reads_per_s"], 1),
            "ratio": round(dev_rps / ref["reads_per_s"], 3),
        }}
        if nat_rps:
            rec["scale"]["64M"]["native_reads_per_s"] = rec["native_reads_per_s"]
        if hyb_rps:
            rec["scale"]["64M"]["hybrid_reads_per_s"] = rec["hybrid_reads_per_s"]
            rec["scale"]["64M"]["hybrid_ratio"] = round(hyb_rps / ref["reads_per_s"], 3)

    # scale stages in priority order (1.34G is the must-have second point),
    # each guarded by a wall-clock estimate: `factor` rescales the first
    # guess by how long the previous stage really took
    base_est = {"mtb13": 120.0, "s640": 60.0, "big2g": 240.0, "big8g": 240.0}
    factor = 1.0
    for scale, label in (("mtb13", "1338M"), ("s640", "640M"), ("big2g", "2400M"), ("big8g", "8001M")):
        est = base_est[scale] * factor
        if remaining() < est:
            log(f"skipping scale {label}: est {est:.0f}s > {remaining():.0f}s left")
            continue
        t0 = time.time()
        try:
            ent = scale_stage(scale, label)
        except Exception as e:  # one stage must never kill the record
            log(f"scale {label} failed: {e}")
            continue
        took = time.time() - t0
        factor = min(3.0, max(0.3, took / base_est[scale]))
        if ent:
            rec.setdefault("scale", {})[label] = ent
            emit(rec)

    for scale, label in (("mtb13", "1338M"), ("big2g", "2400M")):
        if remaining() < 45:
            log(f"skipping align {label}: {remaining():.0f}s left")
            break
        try:
            ent = align_stage(scale, label)
        except Exception as e:
            log(f"align {label} failed: {e}")
            continue
        if ent:
            rec.setdefault("align_scale", {})[label] = ent
            emit(rec)
    log(f"done in {time.time() - T0:.0f}s (deadline {DEADLINE:.0f}s)")


if __name__ == "__main__":
    try:
        main()
    finally:
        _flush_record()
