#!/usr/bin/env python
"""A/B harness for the native SA-IS batch BWT builder (native/sais.cpp).

Builds the nt6 double-strand concatenation of the bench corpus (same input
the CLI `build` feeds rb3t_gsa_bwt) and times the native call.  Run with
JAX_PLATFORMS=cpu (host-only work).

Usage: python scripts/sais_bench.py [n_mbp] [passes]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_MBP = float(sys.argv[1]) if len(sys.argv) > 1 else 64
PASSES = int(sys.argv[2]) if len(sys.argv) > 2 else 3


def corpus(n_symbols: int) -> np.ndarray:
    """16 mutated 2M genomes, fwd+rc, NUL-separated — same shape as bench.py."""
    rng = np.random.default_rng(20260817)
    n_g = max(2, int(round(n_symbols / 2 / 2_000_000)))
    glen = n_symbols // (2 * n_g) - 1
    base = rng.integers(1, 5, glen).astype(np.uint8)
    parts = []
    for _ in range(n_g):
        s = base.copy()
        mut = rng.random(glen) < 0.01
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        z = np.zeros(1, np.uint8)
        parts.append(np.concatenate([s, z]))
        rc = (5 - s[::-1]).astype(np.uint8)
        parts.append(np.concatenate([rc, z]))
    return np.concatenate(parts)


def main():
    seq = corpus(int(N_MBP * 1e6))
    print(f"[sais_bench] n={len(seq):,} symbols, {np.count_nonzero(seq == 0)} seqs", file=sys.stderr)
    from ropebwt3_jax.native import get_sais_lib

    lib = get_sais_lib()
    assert lib is not None
    out = np.empty_like(seq)
    best = float("inf")
    for p in range(PASSES):
        t0 = time.time()
        r = lib.rb3t_gsa_bwt(seq.ctypes.data, len(seq), out.ctypes.data)
        dt = time.time() - t0
        assert r == 0
        best = min(best, dt)
        print(f"[sais_bench] pass {p}: {dt:.2f} s", file=sys.stderr)
    print(f"best {best:.2f} s  ({len(seq) / best / 1e6:.1f} Msym/s)  bwt-sum={int(out.astype(np.int64).sum())}")


if __name__ == "__main__":
    main()
