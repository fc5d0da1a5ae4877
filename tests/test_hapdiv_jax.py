"""Device hapdiv (align/hapdiv_jax.py) vs the host engine, bit-for-bit.

The host rb3_hapdiv/sw_core_multi path is golden vs the reference binary
(tests/test_bwasw.py, test_cli_golden.py), so matching it transitively
matches the reference.  Runs on the CPU backend like the rest of the suite."""

import numpy as np
import pytest

from ropebwt3_jax.align.bwasw import SwOpt, RB3_SWF_E2E, RB3_SWF_HAPDIV, rb3_hapdiv_multi
from ropebwt3_jax.formats import fmd
from ropebwt3_jax.index.dense import DenseFMIndex


@pytest.fixture(scope="module")
def dense_index(ref_index):
    _, syms, lens = fmd.read_fmd(str(ref_index))
    return DenseFMIndex.from_runs(syms, lens)


def _windows(rng, base, n, k, err):
    out = np.zeros((n, k), np.uint8)
    for i in range(n):
        st = int(rng.integers(0, len(base) - k))
        w = base[st : st + k].copy()
        mut = rng.random(k) < err
        w[mut] = rng.integers(1, 5, int(mut.sum()))
        out[i] = w
    return out

def _hapdiv_opt(k):
    opt = SwOpt()
    opt.flag = RB3_SWF_E2E | RB3_SWF_HAPDIV
    opt.end_len = 1
    return opt


@pytest.mark.parametrize("n_best", [10, 16, 17, 40])
def test_device_nbest_geometry_matches_host(dense_index, corpus, n_best):
    """Non-default -N values (round 3: khashl bucket geometry parameterized
    via nb_params — 64/128/256-bucket tables with matching Fibonacci shifts)
    stay bit-exact vs the host engine."""
    import jax.numpy as jnp

    from ropebwt3_jax.align.hapdiv_jax import hapdiv_device, nb_params
    from ropebwt3_jax.ops.rank import DeviceIndex

    assert nb_params(16)[1] == 64 and nb_params(17)[1] == 128 and nb_params(40)[1] == 256
    rng = np.random.default_rng(n_best)
    tab = np.zeros(256, np.uint8)
    for i, ch in enumerate(b"$ACGTN"):
        tab[ch] = i
    base = None
    for line in open(corpus / "genomes.fa"):
        if not line.startswith(">"):
            base = tab[np.frombuffer(line.strip().encode(), np.uint8)]
            break
    W, k = 32, 101
    wins = _windows(rng, base, W, k, 0.04)
    opt = _hapdiv_opt(k)
    opt.n_best = n_best
    host = rb3_hapdiv_multi(opt, dense_index, [wins[i] for i in range(W)])
    idx = DeviceIndex.from_dense(dense_index)
    n_al, max_ed, n_hap, bad = hapdiv_device(idx, jnp.asarray(wins.astype(np.int32)), k, n_best=n_best)
    n_al, max_ed, n_hap, bad = map(np.asarray, (n_al, max_ed, n_hap, bad))
    assert int(bad.sum()) <= W // 3
    for i in range(W):
        if bad[i]:
            continue
        h = host[i]
        if h is None:
            assert n_al[i] == 0
            continue
        assert n_al[i] == h.n_al and max_ed[i] == h.max_ed, (i, n_best)
        assert n_hap[i].tolist() == list(h.n_hap), (i, n_best)


@pytest.mark.parametrize("err,k", [(0.01, 101), (0.06, 101), (0.02, 51)])
def test_device_matches_host(dense_index, corpus, err, k):
    import jax.numpy as jnp

    from ropebwt3_jax.align.hapdiv_jax import hapdiv_device
    from ropebwt3_jax.ops.rank import DeviceIndex

    rng = np.random.default_rng(hash((err, k)) % 2**32)
    tab = np.zeros(256, np.uint8)
    for i, ch in enumerate(b"$ACGTN"):
        tab[ch] = i
    base = None
    for line in open(corpus / "genomes.fa"):
        if not line.startswith(">"):
            base = tab[np.frombuffer(line.strip().encode(), np.uint8)]
            break
    W = 48
    wins = _windows(rng, base, W, k, err)
    # a few windows with N bases (nt6 symbol 5) for the c==5 path
    wins[0, 10:13] = 5
    wins[1, :2] = 5

    opt = _hapdiv_opt(k)
    host = rb3_hapdiv_multi(opt, dense_index, [wins[i] for i in range(W)])

    idx = DeviceIndex.from_dense(dense_index)
    n_al, max_ed, n_hap, bad = hapdiv_device(idx, jnp.asarray(wins.astype(np.int32)), k)
    n_al, max_ed, n_hap, bad = map(np.asarray, (n_al, max_ed, n_hap, bad))

    n_bad = int(bad.sum())
    assert n_bad <= W // 4, f"too many host-fallback windows: {n_bad}/{W}"
    for i in range(W):
        if bad[i]:
            continue
        h = host[i]
        if h is None:
            assert n_al[i] == 0, (i, n_al[i])
            continue
        assert n_al[i] == h.n_al, (i, n_al[i], h.n_al)
        assert max_ed[i] == h.max_ed, (i, max_ed[i], h.max_ed)
        assert n_hap[i].tolist() == list(h.n_hap), (i, n_hap[i].tolist(), h.n_hap)


@pytest.mark.parametrize("n_best", [50, 100])
def test_oversized_nbest_falls_back(dense_index, corpus, n_best):
    """N above the F-closure stack cap routes to the host engine (exact).

    50 is the regression case: 48 < N <= 64 passed the old gate but the
    stack pad shape (W, SCAP-N) went negative (fuzz seed 9000)."""
    from ropebwt3_jax.align.hapdiv_jax import HapdivDeviceEngine

    k = 31
    rng = np.random.default_rng(50)
    tab = np.zeros(256, np.uint8)
    for i, ch in enumerate(b"$ACGTN"):
        tab[ch] = i
    base = None
    for line in open(corpus / "genomes.fa"):
        if not line.startswith(">"):
            base = tab[np.frombuffer(line.strip().encode(), np.uint8)]
            break
    wins = _windows(rng, base, 6, k, 0.02)
    opt = _hapdiv_opt(k)
    opt.n_best = n_best
    host = rb3_hapdiv_multi(opt, dense_index, [wins[i] for i in range(6)])
    eng = HapdivDeviceEngine(dense_index, opt)
    assert not eng.supported
    dev = eng.run([wins[i] for i in range(6)])
    for h, d in zip(host, dev):
        if h is None:
            assert d.n_al == 0
        else:
            assert (d.n_al, d.max_ed, tuple(d.n_hap)) == (h.n_al, h.max_ed, tuple(h.n_hap))


@pytest.mark.parametrize(
    "n_best",
    # 33 (NB=256) trips a multi-minute XLA:CPU compile cliff — slow-gated;
    # 2/8/25 cover the same geometries incl. wraparound in seconds
    [2, 8, 25, pytest.param(33, marks=pytest.mark.slow)],
)
def test_bucket_scan_matches_sequential(n_best):
    """The bitmask khashl replay (bucket_scan) is bit-identical to the scalar
    first-empty-cyclic-probe insert across table geometries (NB = 8..256),
    including deep collision cascades and wraparound probes."""
    import jax.numpy as jnp
    from ropebwt3_jax.align.hapdiv_jax import bucket_scan, nb_params

    _, NB, MAXC = nb_params(n_best)
    W, UCAP = 64, MAXC - 1
    rng = np.random.default_rng(NB)
    u_home = rng.integers(0, NB, (W, UCAP)).astype(np.int32)
    u_home[: W // 4] = rng.integers(max(NB - 3, 0), NB, (W // 4, UCAP))  # wrap
    u_home[W // 4 : W // 2] = rng.integers(0, min(3, NB), (W // 4, UCAP))
    u_count = rng.integers(0, UCAP + 1, W).astype(np.int32)
    bad = rng.random(W) < 0.2

    want = np.zeros((W, UCAP), np.int32)
    for w in range(W):
        if bad[w]:
            continue
        used = np.zeros(NB, bool)
        for u in range(int(u_count[w])):
            h = int(u_home[w, u])
            for d in range(NB):
                b = (h + d) % NB
                if not used[b]:
                    used[b] = True
                    want[w, u] = b
                    break

    for unroll in (1, 8):
        got = np.asarray(bucket_scan(
            jnp.asarray(u_home), jnp.asarray(u_count), jnp.asarray(bad), NB, UCAP, unroll=unroll
        ))
        mask = (np.arange(UCAP)[None, :] < u_count[:, None]) & ~bad[:, None]
        assert (np.where(mask, got, 0) == np.where(mask, want, 0)).all(), (NB, unroll)
