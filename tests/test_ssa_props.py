"""SSA property tests: generation vs brute force, multi-locate vs single."""

import numpy as np
import pytest

from ropebwt3_jax.construct.sa import gsa_bwt
from ropebwt3_jax.formats.ssa import read_ssa_bytes, write_ssa_bytes
from ropebwt3_jax.index.dense import DenseFMIndex
from ropebwt3_jax.ssa_ops import ssa_gen, ssa_lookup1, ssa_multi


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(7)
    seqs = [rng.integers(1, 5, int(rng.integers(30, 120))).astype(np.uint8) for _ in range(9)]
    parts = []
    for s in seqs:
        parts += [s, np.zeros(1, np.uint8)]
    f = DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts), backend="numpy"))
    return f, seqs


def test_ssa_lookup1_matches_bruteforce(tiny):
    f, seqs = tiny
    sa = ssa_gen(f, ssa_shift=3)
    # brute-force: walk each sequence's LF loop, recording each row's suffix
    # offset; ssa_lookup1 must agree everywhere
    for sid in range(len(seqs)):
        k = sid  # sentinel row of sequence sid
        L = len(seqs[sid])
        pos = L
        for _ in range(L):
            c, nk = f.lf(np.array(k))
            k = int(nk)
            pos -= 1
            got_pos, got_sid = ssa_lookup1(f, sa, k)
            assert (got_sid, got_pos) == (sid, pos), (sid, k)


def test_ssa_multi_matches_single(tiny):
    f, _ = tiny
    sa = ssa_gen(f, ssa_shift=3)
    rng = np.random.default_rng(1)
    for _ in range(30):
        lo = int(rng.integers(0, f.n - 2))
        hi = int(rng.integers(lo + 1, min(f.n, lo + 25)))
        got = ssa_multi(f, sa, lo, hi, hi - lo)
        want = []
        for k in range(lo, hi):
            pos, sid = ssa_lookup1(f, sa, k)
            want.append((sid, pos))
        assert sorted(got) == sorted(want), (lo, hi)


def test_ssa_multi_batch_matches_py(tiny):
    """Native interleaved batched locate == Python spec, including cap
    truncation order and degenerate intervals (exercises the G=16 state-
    machine refill with > 64 requests on one thread and > 64 threaded)."""
    from ropebwt3_jax.ssa_ops import ssa_multi_batch, ssa_multi_py

    f, _ = tiny
    sa = ssa_gen(f, ssa_shift=3)
    rng = np.random.default_rng(5)
    n0 = int(f.acc[1])  # valid domain: lo >= acc[1] (see ssa_multi_py)
    reqs = [(n0, n0, 5), (n0 + 3, n0 + 4, 5), (n0, int(f.n), 0), (n0, int(f.n), 7)]
    for _ in range(200):
        lo = int(rng.integers(n0, f.n - 1))
        hi = int(rng.integers(lo, min(f.n, lo + 40)))
        reqs.append((lo, hi, int(rng.integers(0, 12))))
    for n_threads in (1, 3):
        got = ssa_multi_batch(f, sa, reqs, n_threads=n_threads)
        if got is None:
            pytest.skip("native library unavailable")
        want = [ssa_multi_py(f, sa, *r) for r in reqs]
        assert got == want


def test_ssa_roundtrip(tiny):
    f, _ = tiny
    sa = ssa_gen(f, ssa_shift=4)
    sa2 = read_ssa_bytes(write_ssa_bytes(sa))
    assert sa2.ss == sa.ss and sa2.ms == sa.ms and sa2.m == sa.m
    assert np.array_equal(sa2.r2i, sa.r2i) and np.array_equal(sa2.ssa, sa.ssa)


def test_ssa_gen_device_matches_host(tiny):
    from ropebwt3_jax.ssa_ops import ssa_gen_device

    f, _ = tiny
    a = ssa_gen(f, 4)
    b = ssa_gen_device(f, 4)
    assert write_ssa_bytes(a) == write_ssa_bytes(b)
