"""Multi-string BWT construction via suffix sorting.

Semantics match the reference batch builder (sais-ss.c:50-56 over
libsais_gsa): input is a concatenation of nt6 sequences each terminated by a
0 separator (the final byte is a separator); suffixes are compared under the
generalized suffix array order in which each separator is distinct, ordered by
its position, and smaller than every other symbol.  The BWT is then
B[i] = T[SA[i] - 1] (wrapping at 0, which contributes the final separator).

The production path is native SA-IS (native/sais.cpp).  The spec here is
prefix-doubling rank-sort (O(n log n) rounds of key sorts) in numpy; its
device twin (construct/sa_jax.py) runs the same rounds as XLA sorts when
asked for with backend="jax".
"""

from __future__ import annotations

import numpy as np


def _initial_ranks(seq: np.ndarray) -> np.ndarray:
    """Rank symbols so that separator at position p gets a unique rank by
    position order, below all regular symbols."""
    seq = np.asarray(seq, dtype=np.int64)
    is_sep = seq == 0
    m = int(is_sep.sum())
    sep_order = np.cumsum(is_sep) - 1  # index among separators
    return np.where(is_sep, sep_order, m - 1 + seq)


def suffix_array_doubling(keys: np.ndarray) -> np.ndarray:
    """Suffix array of `keys` (int64, all suffixes distinct eventually) via
    prefix doubling with numpy lexsort."""
    n = len(keys)
    rank = np.unique(keys, return_inverse=True)[1].astype(np.int64)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        sa = np.lexsort((rank2, rank))
        key_r, key_r2 = rank[sa], rank2[sa]
        neq = np.empty(n, dtype=np.int64)
        neq[0] = 0
        neq[1:] = (key_r[1:] != key_r[:-1]) | (key_r2[1:] != key_r2[:-1])
        nr = np.cumsum(neq)
        if nr[-1] == n - 1:
            return sa
        rank = np.empty(n, dtype=np.int64)
        rank[sa] = nr
        k *= 2


def gsa_bwt(seq: np.ndarray, backend: str = "auto") -> np.ndarray:
    """Compute the multi-string BWT of a 0-separated nt6 concatenation.

    The input must end with a separator. Returns uint8 BWT of the same length.
    """
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = len(seq)
    if n == 0:
        return seq.copy()
    assert seq[-1] == 0, "batch must end with a separator"
    # Preferred host path: native SA-IS (linear time, the analog of the
    # reference's libsais batch step, sais-ss.c:50-56)
    if backend in ("auto", "native"):
        from ..native import get_sais_lib

        lib = get_sais_lib()
        if lib is not None:
            out = np.empty(n, dtype=np.uint8)
            rc = lib.rb3t_gsa_bwt(seq.ctypes.data, n, out.ctypes.data)
            if rc == 0:
                return out
        if backend == "native":
            raise RuntimeError("native SA-IS unavailable")
    if backend == "jax":  # device prefix doubling, only when asked for
        from .sa_jax import gsa_bwt_jax

        return gsa_bwt_jax(seq)
    keys = _initial_ranks(seq)
    sa = suffix_array_doubling(keys)
    prev = np.where(sa == 0, n - 1, sa - 1)
    return seq[prev]
