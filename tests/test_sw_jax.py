"""Device sw scoring (align/sw_jax.py) vs the host engine, hit-for-hit.

The host rb3_sw path is golden vs the reference binary (tests/test_bwasw.py),
so matching it transitively matches the reference.  Runs on the CPU backend
like the rest of the suite."""

import numpy as np
import pytest

from ropebwt3_jax.align.bwasw import RB3_SWF_E2E, SwOpt, rb3_sw
from ropebwt3_jax.formats import fmd
from ropebwt3_jax.index.dense import DenseFMIndex


@pytest.fixture(scope="module")
def dense_index(ref_index):
    _, syms, lens = fmd.read_fmd(str(ref_index))
    f = DenseFMIndex.from_runs(syms, lens)
    from ropebwt3_jax.ssa_ops import ssa_gen

    f.ssa = ssa_gen(f, 4)
    return f


def _reads(corpus, rng, n=20):
    tab = np.zeros(256, np.uint8)
    for i, ch in enumerate(b"$ACGTN"):
        tab[ch] = i
    base = None
    for line in open(corpus / "genomes.fa"):
        if not line.startswith(">"):
            base = tab[np.frombuffer(line.strip().encode(), np.uint8)]
            break
    out = []
    for i in range(n):
        L = [150, 90, 45][i % 3]
        st = int(rng.integers(0, len(base) - L))
        r = base[st : st + L].copy()
        mut = rng.random(L) < [0.02, 0.05, 0.0][i % 3]
        r[mut] = rng.integers(1, 5, int(mut.sum()))
        if i % 6 == 0:
            r[4:6] = 5  # N bases
        if i % 8 == 0:
            r = np.tile(r[: L // 3], 3)[:L]  # repeats: DAWG node merges
        if i % 5 == 2:
            r = np.delete(r, slice(20, 24))  # deletion: exercises F closure
        out.append(r)
    return out


def _sig(hits):
    return [
        (h.score, h.lo, h.hi, tuple(h.cigar), h.cs, tuple(h.qoff), tuple(map(tuple, h.pos)))
        for h in hits
    ]


@pytest.mark.parametrize("e2e,max_pos,mml", [(False, 0, 0), (False, 3, 17), (True, 2, 0)])
def test_device_sw_matches_host(dense_index, corpus, e2e, max_pos, mml):
    from ropebwt3_jax.align.sw_jax import SwDeviceEngine

    rng = np.random.default_rng(hash((e2e, max_pos, mml)) % 2**32)
    reads = _reads(corpus, rng)
    opt = SwOpt()
    opt.max_pos = max_pos
    opt.min_mem_len = mml
    if e2e:
        opt.flag |= RB3_SWF_E2E
        opt.end_len = 1
    host = [rb3_sw(opt, dense_index, q) for q in reads]
    eng = SwDeviceEngine(dense_index, opt, lanes=16)
    dev = eng.run(reads)
    for i, (a, b) in enumerate(zip(host, dev)):
        assert _sig(a) == _sig(b), (i, _sig(a)[:2], _sig(b)[:2])


@pytest.mark.parametrize("n_best", [8, 16, 40])
def test_device_sw_nbest_geometry(dense_index, corpus, n_best):
    """Non-default -N on device (round 3: khashl geometry parameterized via
    nb_params, 32..256-bucket tables) stays exact vs the host engine."""
    from ropebwt3_jax.align.sw_jax import SwDeviceEngine

    rng = np.random.default_rng(n_best)
    reads = _reads(corpus, rng, n=6)
    opt = SwOpt()
    opt.n_best = n_best
    host = [rb3_sw(opt, dense_index, q) for q in reads]
    eng = SwDeviceEngine(dense_index, opt, lanes=8)
    assert eng.supported
    dev = eng.run(reads)
    for i, (a, b) in enumerate(zip(host, dev)):
        assert _sig(a) == _sig(b), (i, n_best)


def test_device_sw_int64_index(dense_index, corpus, monkeypatch):
    """int64 indexes (round 3: the n < 2^31 gate widened to 2^32 with
    unsigned key-half unpacking) run device sw exactly.  Shrink the megablock
    so the toy index exercises the int64 multi-megablock occf layout."""
    import jax.numpy as jnp

    from ropebwt3_jax.align import sw_jax as swj
    from ropebwt3_jax.ops import rank as rank_mod

    monkeypatch.setattr(rank_mod, "MEGA_BLOCK_SHIFT", 6)
    rng = np.random.default_rng(64)
    reads = _reads(corpus, rng, n=6)
    opt = SwOpt()
    host = [rb3_sw(opt, dense_index, q) for q in reads]
    eng = swj.SwDeviceEngine(dense_index, opt, lanes=8)
    assert eng.supported
    eng.idx = rank_mod.DeviceIndex.from_dense(dense_index, idx_dtype=jnp.int64)
    assert eng.idx.occ_super.shape[0] > 1
    dev = eng.run(reads)
    for i, (a, b) in enumerate(zip(host, dev)):
        assert _sig(a) == _sig(b), i


@pytest.mark.parametrize("n_best", [50, 100])
def test_unsupported_opts_fall_back(dense_index, corpus, n_best):
    """An out-of-range -N routes every read to the host engine (still exact).

    50 is the regression case: 48 < N <= 64 passed the old gate but the
    F-closure stack pad shape (W, SCAP-N) went negative (fuzz seed 9000)."""
    from ropebwt3_jax.align.sw_jax import SwDeviceEngine

    rng = np.random.default_rng(3)
    reads = _reads(corpus, rng, n=4)
    opt = SwOpt()
    opt.n_best = n_best
    host = [rb3_sw(opt, dense_index, q) for q in reads]
    eng = SwDeviceEngine(dense_index, opt)
    assert not eng.supported
    dev = eng.run(reads)
    for a, b in zip(host, dev):
        assert _sig(a) == _sig(b)
