"""Property tests: dense rank/extend vs naive scans."""

import numpy as np
import pytest

from ropebwt3_jax.index.dense import DenseFMIndex


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(0)
    bwt = rng.integers(0, 6, 5000).astype(np.uint8)
    return DenseFMIndex.from_bwt(bwt), bwt


def test_rank_vs_naive(small_index):
    f, bwt = small_index
    rng = np.random.default_rng(1)
    ks = np.concatenate([rng.integers(0, f.n + 1, 300), [0, f.n, 1, 63, 64, 65, 65535, 65536, 65537]])
    ks = ks[ks <= f.n]
    got = f.rank1a(ks)
    for k, row in zip(ks, got):
        naive = np.bincount(bwt[:k], minlength=6)
        assert np.array_equal(row, naive), k


def test_acc(small_index):
    f, bwt = small_index
    assert np.array_equal(f.acc[1:], np.cumsum(np.bincount(bwt, minlength=6)))


def test_lf_walk_total(small_index):
    f, bwt = small_index
    # LF is a bijection on [0, n)
    _, lfv = f.lf(np.arange(f.n))
    assert len(np.unique(lfv)) == f.n


def test_extend_sizes_consistent(small_index):
    f, _ = small_index
    ik = np.array([0, 0, f.n], dtype=np.int64)
    ok = f.extend(ik, True)
    assert ok[:, 2].sum() == f.n
    ok2 = f.extend(ik, False)
    assert np.array_equal(np.sort(ok[:, 2]), np.sort(ok2[:, 2]))


def test_rank1a_fast_matches_numpy(small_index):
    f, _ = small_index
    rng = np.random.default_rng(7)
    pos = rng.integers(0, f.n + 1, 5000)  # above the native-path threshold
    assert np.array_equal(f.rank1a_fast(pos), f.rank1a(pos))
