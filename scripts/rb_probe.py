#!/usr/bin/env python
"""Fixed-workload decode probe for the occ row formats.

Inside the SMEM FSM a rank costs whatever the trip count around it costs,
so this probe times the DECODE ALONE under an identical workload for every
arm: T scan steps of Q rank1a calls whose positions advance with a
decode-INDEPENDENT LCG (so all arms visit the same position sequence),
while the decoded counts fold into a checksum carried to the output so XLA
cannot drop the decode.  Steps stay independent, so this measures decode
THROUGHPUT, not the FSM-level serialized cost.  The checksum is the same for
every correct arm (the six counts partition the positions below k).

Usage: python scripts/rb_probe.py <scale> [arms...]
Arms: dense rb rbS256 rbS1024
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

Q = 4096  # lanes per step
T = 256  # scan steps


def probe(idx, n):
    import jax
    import jax.numpy as jnp

    from ropebwt3_jax.ops.rank import rank1a as rank_fn

    dt = idx.idx_dtype
    a = np.int64(1103515245) if dt == jnp.int64 else np.int32(1103515)
    c = np.int64(12345) if dt == jnp.int64 else np.int32(12345)

    # idx rides as an ARGUMENT (closure-captured tables embed as program
    # constants and slow compilation — cf. __graft_entry__.entry)
    @jax.jit
    def run(ix, ks0):
        def step(carry, _):
            ks, acc = carry
            counts = rank_fn(ix, ks)
            acc = acc + jnp.sum(counts, axis=-1).astype(acc.dtype)
            ks = (ks * a + c) % jnp.asarray(n, dt)
            ks = jnp.where(ks < 0, ks + n, ks)
            return (ks, acc), None

        (ks, acc), _ = jax.lax.scan(step, (ks0, jnp.zeros_like(ks0)), None, length=T)
        return acc

    rng = np.random.default_rng(7)
    ks0 = jax.device_put(jnp.asarray(rng.integers(0, n, Q).astype(np.int64 if dt == jnp.int64 else np.int32)))
    run0 = lambda k: run(idx, k)
    t0 = time.time()
    chk = int(np.asarray(run0(ks0)).sum())
    comp = time.time() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        np.asarray(run0(ks0))
        best = min(best, time.time() - t0)
    ranks = Q * T
    return best, best / ranks * 1e9, comp, chk


def main():
    scale = sys.argv[1] if len(sys.argv) > 1 else "mtb13"
    arms = sys.argv[2:] or ["dense", "rb", "rbS256", "rbS1024"]
    d = os.path.join(ROOT, ".bench", scale)
    from ropebwt3_jax.cli import load_index
    from ropebwt3_jax.ops import runblock
    from ropebwt3_jax.ops.rank import DeviceIndex

    f = load_index(os.path.join(d, "idx.fmd"))
    import jax

    print(f"[rb_probe] {scale}: n={f.n:,} platform={jax.devices()[0].platform}", file=sys.stderr, flush=True)
    res: dict = {"scale": scale, "n": f.n, "Q": Q, "T": T}
    for arm in arms:
        if arm == "dense":
            idx = DeviceIndex.from_dense(f)
        elif arm == "rb":
            idx = runblock.from_dense(f)
        elif arm.startswith("rbS"):
            idx = runblock.from_dense(f, S=int(arm[3:]))
        else:
            raise SystemExit(f"unknown arm {arm}")
        wall, ns, comp, chk = probe(idx, f.n)
        res[arm] = {"wall_s": round(wall, 4), "ns_per_rank": round(ns, 2), "compile_s": round(comp, 1), "chk": chk}
        print(f"[rb_probe] {arm}: {wall:.3f}s = {ns:.1f} ns/rank (compile {comp:.0f}s)", file=sys.stderr, flush=True)
        del idx
    json.dump(res, open(os.path.join(d, "rb_probe.json"), "w"))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
