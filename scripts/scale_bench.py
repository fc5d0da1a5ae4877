#!/usr/bin/env python
"""Scale curve for the SMEM kernel: 64M / 640M / 1.3G(mtb152-like) / 2.4G.

BASELINE config 3 is mtb152-scale (~1.3 G symbols); the curve adds 640M and
a >2^31 (int64) point.  Each scale gets: corpus + reads sampled from it, an
FMD built by OUR CLI, a dense-table cache, a reference `mem -t4` baseline,
and a device kernel run that records wall AND loop iterations (so
per-iteration cost is separable from workload iteration-count
differences).

Usage (scales: s640 | mtb13 | big2g | big8g):
  python scripts/scale_bench.py gen     <scale>   # corpus+reads
  python scripts/scale_bench.py build   <scale>   # our FMD + dense cache
  python scripts/scale_bench.py sidecar <scale>   # .dense/.pl/.rb.npz prebuild
  python scripts/scale_bench.py ref     <scale>   # reference timing (run solo)
  python scripts/scale_bench.py device  <scale>   # device kernel timing
  python scripts/scale_bench.py golden  <scale>   # byte-compare mem (big2g/big8g
                                                  # are the int64 golden gates)

Stages are idempotent (cached artifacts under .bench/<scale>/).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BENCH = os.path.join(ROOT, ".bench")

import bench as B  # noqa: E402  (needs ROOT on sys.path)

SCALES = {
    # 64 x 5 Mbp, 1% divergence -> 640,000,128 double-strand symbols
    # (-m120m everywhere: 320M batches hit the host SA-IS cliff — round 4;
    # the merge path is batch-size-insensitive since the one-pass native
    # dense-table builder, and FMD bytes are batching-invariant)
    "s640": dict(n_genomes=64, glen=5_000_000, seed=20260819, batch="120m"),
    # mtb152-like (BASELINE config 3): 152 x 4.4 Mbp -> 1,337,600,304 symbols
    "mtb13": dict(n_genomes=152, glen=4_400_000, seed=20260820, batch="120m"),
    # >2^31: 24 x 50 Mbp -> 2,400,000,048 symbols (gen_big2g.py recipe)
    "big2g": dict(n_genomes=24, glen=50_000_000, seed=20260818, batch="120m"),
    # beyond-dense capacity corpus: 400 x 10 Mbp at 0.3%
    # divergence -> 8,000,800,000 symbols; the low divergence gives the
    # run-aware compressed device rows pangenome-like run lengths
    "big8g": dict(n_genomes=400, glen=10_000_000, seed=20260821, divergence=0.003, batch="120m", no_npz=True),
}
N_READS = 100_000
READ_LEN = 150
READ_ERR = 0.01
DIVERGENCE = 0.01
MIN_LEN = 31


def log(m):
    print(f"[scale] {m}", file=sys.stderr, flush=True)


def d(scale):
    p = os.path.join(BENCH, scale)
    os.makedirs(p, exist_ok=True)
    return p


def gen(scale):
    cfg = SCALES[scale]
    out = d(scale)
    fa, reads_fa = os.path.join(out, "genomes.fa"), os.path.join(out, "reads.fa")
    reads_npy = os.path.join(out, "reads.npy")
    if os.path.exists(fa) and os.path.exists(reads_npy):
        log(f"{scale}: corpus cached")
        return
    rng = np.random.default_rng(cfg["seed"])
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    base = rng.integers(1, 5, cfg["glen"]).astype(np.uint8)
    n_sym = 2 * cfg["n_genomes"] * (cfg["glen"] + 1)
    log(f"{scale}: {cfg['n_genomes']} x {cfg['glen']/1e6:.1f} Mbp -> {n_sym:,} symbols")
    div = cfg.get("divergence", DIVERGENCE)
    with open(fa, "w", buffering=1 << 22) as f:
        for i in range(cfg["n_genomes"]):
            s = base.copy()
            mut = rng.random(cfg["glen"]) < div
            s[mut] = rng.integers(1, 5, int(mut.sum()))
            f.write(f">g{i}\n")
            f.write(alpha[s].tobytes().decode())
            f.write("\n")
    starts = rng.integers(0, cfg["glen"] - READ_LEN, N_READS)
    reads = base[starts[:, None] + np.arange(READ_LEN)]
    err = rng.random(reads.shape) < READ_ERR
    reads = np.where(err, rng.integers(1, 5, reads.shape), reads).astype(np.uint8)
    np.save(reads_npy, reads)
    with open(reads_fa, "w", buffering=1 << 22) as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{alpha[r].tobytes().decode()}\n")
    log(f"{scale}: corpus done")


def scrub_env():
    e = dict(os.environ)
    e["JAX_PLATFORMS"] = "cpu"
    return e


def build(scale):
    out = d(scale)
    fmd = os.path.join(out, "idx.fmd")
    if not os.path.exists(fmd):
        t0 = time.time()
        # default 120m: 320M single batches hit this host's SA-IS cliff
        # (round 4) — a future SCALES entry without "batch" must not re-hit it
        batch = SCALES[scale].get("batch", "120m")
        log(f"{scale}: building FMD (our CLI, host path, -m{batch} batches) ...")
        # multi-batch merge path: large SINGLE batches crawl on the host
        # SA-IS (cache-miss bound; this host hits a cliff past ~240M), and
        # merge work is roughly batch-size-insensitive — the per-scale batch
        # keeps SA-IS under its knee
        subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "build", f"-m{batch}", "-do", fmd, os.path.join(out, "genomes.fa")],
            check=True, env=scrub_env(), cwd=ROOT,
        )
        log(f"{scale}: build {time.time()-t0:.1f}s")
    npz = os.path.join(out, "dense.npz")
    if SCALES[scale].get("no_npz"):
        return  # the v2 sidecar (hugepage-mapped) supersedes the npz cache
    if not os.path.exists(npz):
        log(f"{scale}: dense decode ...")
        t0 = time.time()
        from ropebwt3_jax.formats import fmd as fmdc
        from ropebwt3_jax.index.dense import DenseFMIndex

        _, syms, lens = fmdc.read_fmd(fmd)
        f = DenseFMIndex.from_runs(syms, lens)
        np.savez(npz, bwt=f.bwt, n=f.n, acc=f.acc, occ_block=f.occ_block, occ_super=f.occ_super)
        log(f"{scale}: dense {time.time()-t0:.1f}s")


def sidecar(scale):
    """Prebuild every query-time sidecar for a scale so bench-time loads are
    mmap-warm (otherwise the first bench pays GB-scale table construction
    per scale): `.dense` (v2 hugepage layout),
    `.dense.pl` (pline rank records), `.dense.rb.npz` (compressed rb rows)."""
    from ropebwt3_jax.cli import load_index
    from ropebwt3_jax.ops import runblock
    from ropebwt3_jax.ops.smem_native import pline_table

    fmd = os.path.join(d(scale), "idx.fmd")
    t0 = time.time()
    f = load_index(fmd)  # builds/refreshes <idx>.dense
    log(f"{scale}: dense sidecar {time.time()-t0:.1f}s")
    t0 = time.time()
    pline_table(f)  # builds/refreshes <idx>.dense.pl
    log(f"{scale}: pline sidecar {time.time()-t0:.1f}s")
    t0 = time.time()
    runblock.from_dense_np(f)  # builds/refreshes <idx>.dense.rb.npz
    log(f"{scale}: rb sidecar {time.time()-t0:.1f}s")


def load_dense(scale):
    from ropebwt3_jax.index.dense import DenseFMIndex

    z = np.load(os.path.join(d(scale), "dense.npz"))
    return DenseFMIndex(bwt=z["bwt"], n=int(z["n"]), acc=z["acc"], occ_block=z["occ_block"], occ_super=z["occ_super"])


def ensure_ref_bin():
    import bench as B

    return B.ensure_ref_bin()


def ref(scale):
    out = d(scale)
    cache = os.path.join(out, "ref_timing.json")
    j = B._trusted(cache)
    if j is not None:
        log(f"{scale}: ref cached {open(cache).read()}")
        return j
    rb = ensure_ref_bin()
    ncpu = os.cpu_count() or 4
    log(f"{scale}: timing reference mem -t{ncpu} (best-of-2, solo) ...")
    wall, util = float("inf"), 0.0
    for _ in range(2):
        w, u = B._run_timed(
            [rb, "mem", f"-t{ncpu}", f"-l{MIN_LEN}", os.path.join(out, "idx.fmd"), os.path.join(out, "reads.fa")],
            check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        if w < wall:
            wall, util = w, u
    r = {"wall_s": wall, "threads": ncpu, "reads_per_s": N_READS / wall, "cpu_util": round(util, 3)}
    json.dump(r, open(cache, "w"))
    log(f"{scale}: reference {wall:.2f}s = {r['reads_per_s']:,.0f} reads/s (util {util:.2f})")
    return r


def device(scale, passes=3):
    """Packed device kernel, identical shapes to bench.py; reports wall, iters."""
    out = d(scale)
    f = load_dense(scale)
    log(f"{scale}: n={f.n:,} (idx dtype {'int64' if f.n >= (1<<31)-(1<<20) else 'int32'})")
    reads = np.load(os.path.join(out, "reads.npy"))

    import jax
    import jax.numpy as jnp

    from ropebwt3_jax.ops.rank import DeviceIndex
    from ropebwt3_jax.ops.smem import smem_tg_batch

    idx = DeviceIndex.from_dense(f)
    del f
    LANES, LBUF, RCAP, M = 2048, 4096, 32, 64
    NPL = LBUF // (READ_LEN + 1)
    per = LANES * NPL
    so = np.zeros((LANES, RCAP), np.int32)
    sl = np.zeros((LANES, RCAP), np.int32)
    for r_ in range(NPL):
        so[:, r_] = r_ * (READ_LEN + 1)
        sl[:, r_] = READ_LEN
    chunks = []
    for c0 in range(0, N_READS, per):
        got = reads[c0 : c0 + per]
        block = np.zeros((LANES, LBUF), np.uint8)
        ns = np.zeros(LANES, np.int32)
        for t, rd in enumerate(got):
            lane, slot = t % LANES, t // LANES
            block[lane, slot * (READ_LEN + 1) : slot * (READ_LEN + 1) + READ_LEN] = rd
            ns[lane] = max(ns[lane], slot + 1)
        chunks.append((jax.device_put(block), jax.device_put(jnp.asarray(ns))))
    seg_off = jax.device_put(jnp.asarray(so))
    seg_len = jax.device_put(jnp.asarray(sl))
    qlen = jnp.zeros(LANES, jnp.int32)
    jax.block_until_ready([c[0] for c in chunks])

    def run(ch):
        return smem_tg_batch(
            idx, ch[0], qlen, min_occ=1, min_len=MIN_LEN, max_mems=M,
            max_iters=RCAP * LBUF + 64, unroll=2,
            segments=(seg_off, seg_len, ch[1]),
        )

    log(f"{scale}: warmup/compile ({jax.devices()[0].platform}) ...")
    t0 = time.time()
    np.asarray(run(chunks[0])[1])
    log(f"{scale}: warmup {time.time()-t0:.1f}s")
    best, iters_tot, mems_tot = float("inf"), 0, 0
    for p in range(passes):
        t0 = time.time()
        tm, ti = 0, 0
        for ch in chunks:
            mems, n_mem, it = run(ch)
            tm += int(np.asarray(n_mem).sum())
            ti += int(np.asarray(it))
        dt = time.time() - t0
        log(f"{scale}: pass {p}: {dt:.2f}s, iters={ti} ({dt/ti*1e6:.1f} us/iter)")
        if dt < best:
            best, iters_tot, mems_tot = dt, ti, tm
    r = {
        "n": int(np.asarray(idx.acc[-1])), "wall_s": best, "reads_per_s": N_READS / best,
        "iters": iters_tot, "us_per_iter": best / iters_tot * 1e6, "mems": mems_tot,
    }
    json.dump(r, open(os.path.join(out, "device_timing.json"), "w"))
    log(f"{scale}: ours {best:.2f}s = {r['reads_per_s']:,.0f} reads/s, {r['us_per_iter']:.1f} us/iter, {mems_tot} MEMs")
    return r


def golden(scale):
    """Byte-compare our `mem` vs the reference on OUR index at this scale."""
    out = d(scale)
    rb = ensure_ref_bin()
    fmd = os.path.join(out, "idx.fmd")
    reads_fa = os.path.join(out, "reads.fa")
    import hashlib

    t0 = time.time()
    r1 = subprocess.run([rb, "mem", "-t4", f"-l{MIN_LEN}", fmd, reads_fa], check=True, capture_output=True)
    t_ref = time.time() - t0
    t0 = time.time()
    r2 = subprocess.run(
        [sys.executable, "-m", "ropebwt3_jax", "mem", f"-l{MIN_LEN}", fmd, reads_fa],
        check=True, capture_output=True, env=scrub_env(), cwd=ROOT,
    )
    t_ours = time.time() - t0
    h1, h2 = hashlib.sha256(r1.stdout).hexdigest(), hashlib.sha256(r2.stdout).hexdigest()
    log(f"{scale}: golden mem ref={t_ref:.1f}s ours={t_ours:.1f}s match={h1 == h2}")
    if h1 != h2:
        open(os.path.join(out, "ref_mem.bed"), "wb").write(r1.stdout)
        open(os.path.join(out, "ours_mem.bed"), "wb").write(r2.stdout)
        raise SystemExit(f"{scale}: MISMATCH (dumped to {out})")


if __name__ == "__main__":
    stage, scale = sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "s640"
    {"gen": gen, "build": build, "sidecar": sidecar, "ref": ref, "device": device, "golden": golden}[stage](scale)
