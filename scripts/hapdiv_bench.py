#!/usr/bin/env python
"""Device-hapdiv throughput vs the native host engine on the bench corpus.

Usage: python scripts/hapdiv_bench.py [n_windows] [lanes] [engine: jax|native|both]
Windows = first 101 bp of each bench read (k=101 w=50 on 150 bp reads yields
exactly one window per read, matching `hapdiv` CLI tiling).
"""

import os, sys, time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
import numpy as np

import bench as B
from ropebwt3_jax.align.bwasw import SwOpt, RB3_SWF_E2E, RB3_SWF_HAPDIV, rb3_hapdiv_multi

N = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
LANES = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
ENGINE = sys.argv[3] if len(sys.argv) > 3 else "both"
K = 101

fa, _, reads = B.ensure_corpus()
fmd = B.ensure_index(fa)
f = B.ensure_dense(fmd)
wins = [reads[i, :K].copy() for i in range(N)]

opt = SwOpt()
opt.flag = RB3_SWF_E2E | RB3_SWF_HAPDIV
opt.end_len = 1

res_nat = None
if ENGINE in ("native", "both", "oracle"):
    t0 = time.time()
    res_nat = rb3_hapdiv_multi(opt, f, wins)
    dt = time.time() - t0
    print(f"[native -t4] {N} windows: {dt:.2f}s = {N/dt:,.0f} win/s", flush=True)

if ENGINE in ("jax", "both", "oracle"):
    from ropebwt3_jax.align.hapdiv_jax import HapdivDeviceEngine

    eng = HapdivDeviceEngine(f, opt, lanes=LANES)
    t0 = time.time()
    warm = eng.run(wins[:LANES])
    print(f"[jax] warmup (compile + first batch): {time.time()-t0:.1f}s", flush=True)
    if ENGINE == "oracle" and res_nat is not None:
        # cohort upper bound: sort windows by the ORACLE difficulty (native
        # n_al) so each device chunk is difficulty-homogeneous; if even this
        # doesn't speed the lock-step engine, predictor-based cohorts are
        # dead (the per-node fixed cost, not the closure tail, dominates)
        order = sorted(range(N), key=lambda i: 0 if res_nat[i] is None else res_nat[i].n_al)
        wins_o = [wins[i] for i in order]
        t0 = time.time()
        eng.run(wins_o)
        dt = time.time() - t0
        print(f"[jax-oracle-cohorts] {N} windows: {dt:.2f}s = {N/dt:,.0f} win/s", flush=True)
    t0 = time.time()
    res_jax = eng.run(wins)
    dt = time.time() - t0
    nbad = sum(
        1 for i in range(0, N, LANES)
    )  # bad windows already host-redone inside run(); count via a second pass flag? report timing only
    print(f"[jax] {N} windows: {dt:.2f}s = {N/dt:,.0f} win/s (lanes={LANES})", flush=True)
    if res_nat is not None:
        mism = 0
        for i, (a, b) in enumerate(zip(res_nat, res_jax)):
            ta = (0, 0, (0,) * 7) if a is None else (a.n_al, a.max_ed, tuple(a.n_hap))
            tb = (b.n_al, b.max_ed, tuple(b.n_hap))
            if ta != tb:
                mism += 1
                if mism <= 3:
                    print(f"  MISMATCH win {i}: native={ta} jax={tb}", flush=True)
        print(f"[check] mismatches: {mism}/{N}", flush=True)
