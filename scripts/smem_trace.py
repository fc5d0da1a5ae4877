#!/usr/bin/env python
"""Trace the device SMEM engine: FSM steps and while-loop trips per dispatch
and time per step, from a jax.profiler trace of a warm `mem` run.

    python scripts/smem_trace.py <idx.fmd> <reads.fa> <out_dir> [-lMIN_LEN]

Runs BatchedSmemTG (the `mem --engine=jax` engine) over the reads three
times: once to compile, once timed with the profiler off, once under the
profiler.  Every kernel dispatch returns its FSM step count (one while-loop
trip runs `unroll` steps), so steps come from the program itself.  Device
busy time is the union of the device's stream events in the trace; the
device window is the span from its first event to its last.  The idle share
is taken inside that window, and the traced wall outside it (host staging of
the first dispatch, unpacking of the last, engine start) is reported apart.
A run's wall time covers host staging and unpacking too (the engine
overlaps them with the kernel of the neighbouring dispatch), so only the
device window measures the loop.  Prints a summary and writes it, with the
per-line event counts of the device planes, to <out_dir>/summary.json.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_ns(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    tot, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s
    return tot


def reduce_trace(path: str) -> dict:
    """Device planes of one .xplane.pb: busy time (union of the stream
    lines' events, or of all lines when none is named as a stream), the
    window they span, and per-line event counts and top kernels by time."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    out: dict = {"devices": []}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        streams = [n for n in lines if n.lower().startswith("stream")] or list(lines)
        iv = [(e.start_ns, e.start_ns + e.duration_ns) for n in streams for e in lines[n]]
        by_name: dict = {}
        for n in streams:
            for e in lines[n]:
                k = by_name.setdefault(e.name, [0, 0.0])
                k[0] += 1
                k[1] += e.duration_ns
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out["devices"].append({
            "plane": plane.name,
            "lines": {n: len(v) for n, v in lines.items()},
            "busy_s": busy_ns(iv) / 1e9,
            "span_s": (max(e for _, e in iv) - min(s for s, _ in iv)) / 1e9 if iv else 0.0,
            "events": len(iv),
            "top": [{"name": k[:120], "count": c, "total_s": t / 1e9} for k, (c, t) in top],
        })
    return out


def main() -> int:
    idx_path, reads_fa, out_dir = sys.argv[1:4]
    min_len = 19
    for a in sys.argv[4:]:
        if a.startswith("-l"):
            min_len = int(a[2:])
    import jax
    import numpy as np

    from ropebwt3_jax.cli import load_index
    from ropebwt3_jax.nt6 import char2nt6
    from ropebwt3_jax.ops import smem as smem_mod
    from ropebwt3_jax.seqio import read_seqs

    f = load_index(idx_path)
    reads = [char2nt6(r.seq) for r in read_seqs(reads_fa)]
    eng = smem_mod.BatchedSmemTG(f, min_occ=1, min_len=min_len)
    steps: list = []
    kernel = smem_mod.smem_tg_batch

    def counted(*a, **kw):
        out = kernel(*a, **kw)
        steps.append(out[2])
        return out

    smem_mod.smem_tg_batch = counted
    eng.run(reads)  # compile
    steps.clear()
    t0 = time.perf_counter()
    eng.run(reads)
    wall = time.perf_counter() - t0
    n_steps = [int(np.asarray(t)) for t in steps]
    steps.clear()
    os.makedirs(out_dir, exist_ok=True)
    with jax.profiler.trace(out_dir):
        t0 = time.perf_counter()
        eng.run(reads)
        wall_traced = time.perf_counter() - t0
    traced_steps = sum(int(np.asarray(t)) for t in steps)
    xp = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*", "*.xplane.pb")), key=os.path.getmtime)
    red = reduce_trace(xp[-1]) if xp else {"devices": []}
    dev = red["devices"][0] if red["devices"] else {"busy_s": float("nan"), "span_s": float("nan"), "events": 0}
    tot = sum(n_steps)
    trips = sum(-(-n // eng.unroll) for n in n_steps)
    span = dev["span_s"]
    s = {
        "device": jax.devices()[0].device_kind,
        "reads": len(reads),
        "dispatches": len(n_steps),
        "steps_per_dispatch": n_steps,
        "steps": tot,
        "unroll": eng.unroll,
        "loop_trips": trips,
        "wall_s": wall,
        "wall_per_step_us": wall / max(tot, 1) * 1e6,
        "traced_wall_s": wall_traced,
        "traced_steps": traced_steps,
        "device_busy_s": dev["busy_s"],
        "device_span_s": span,
        "host_outside_span_s": wall_traced - span,
        "device_busy_per_step_us": dev["busy_s"] / max(traced_steps, 1) * 1e6,
        "device_span_per_trip_us": span / max(trips, 1) * 1e6,
        "device_idle_share": 1 - dev["busy_s"] / span if span > 0 else None,
        "device_events_per_step": dev["events"] / max(traced_steps, 1),
        "trace": red,
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as fh:
        json.dump(s, fh, indent=1)
    print(f"{s['device']}: {s['reads']:,} reads, {s['dispatches']} dispatches, FSM steps per dispatch {n_steps} "
          f"({s['loop_trips']} while-loop trips of {eng.unroll} steps)")
    print(f"warm wall {wall:.3f} s = {s['wall_per_step_us']:.2f} us per step, host staging and unpacking included (profiler off)")
    print(f"traced: wall {wall_traced:.3f} s, device window {span:.3f} s = {s['device_span_per_trip_us']:.2f} us per trip, "
          f"host outside the window {s['host_outside_span_s']:.3f} s")
    idle = s["device_idle_share"]
    print(f"device busy {dev['busy_s']:.3f} s = {s['device_busy_per_step_us']:.2f} us per step, idle share in the window "
          f"{'not measured' if idle is None else f'{idle:.3f}'}, {s['device_events_per_step']:.1f} device events per step")
    for t in dev.get("top", [])[:6]:
        print(f"  {t['total_s']:.3f} s  x{t['count']}  {t['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
