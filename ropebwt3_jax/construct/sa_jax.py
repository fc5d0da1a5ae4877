"""Device-side generalized-suffix-array BWT via prefix doubling.

Each round is one stable multi-key `lax.sort` over the whole batch plus a
segmented rank rebuild — large, regular, device-wide ops that XLA tiles well
and that shard over a mesh axis for multi-chip builds.  O(n log n) total sort
work instead of libsais's sequential SA-IS; whether a device sort makes that
pay against the native SA-IS is an open measurement, so `build` does not use
it (gsa_bwt(backend="jax") reaches it).

Rounds are host-driven (one scalar sync per round, ~log2(max_len) rounds).
"""

from __future__ import annotations

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _round(rank: jax.Array, k: jax.Array):
    n = rank.shape[0]
    dt = rank.dtype
    padded = jnp.concatenate([rank, jnp.full((n,), -1, dt)])
    rank2 = jax.lax.dynamic_slice(padded, (jnp.minimum(k, n),), (n,))
    iota = jnp.arange(n, dtype=dt)
    r_s, r2_s, sa = jax.lax.sort((rank, rank2, iota), dimension=0, is_stable=True, num_keys=2)
    neq = jnp.concatenate([jnp.zeros((1,), dt), ((r_s[1:] != r_s[:-1]) | (r2_s[1:] != r2_s[:-1])).astype(dt)])
    nr = jnp.cumsum(neq)
    # permutation inverse (new_rank[sa] = nr) as a 2-array sort rather than
    # a scatter
    _, new_rank = jax.lax.sort((sa, nr), dimension=0, is_stable=False, num_keys=1)
    return new_rank, sa, nr[-1]


@jax.jit
def _initial(seq: jax.Array):
    n = seq.shape[0]
    dt = jnp.int32 if n < (1 << 31) - 1 else jnp.int64
    s = seq.astype(dt)
    is_sep = s == 0
    m = jnp.sum(is_sep, dtype=dt)
    sep_order = jnp.cumsum(is_sep.astype(dt)) - 1
    return jnp.where(is_sep, sep_order, m - 1 + s)


def gsa_bwt_jax(seq: np.ndarray) -> np.ndarray:
    """Multi-string BWT of a 0-separated nt6 batch, computed on device."""
    from .. import require_device

    require_device()
    n = len(seq)
    if n < 2:
        return np.asarray(seq, dtype=np.uint8)
    dseq = jnp.asarray(seq, dtype=jnp.uint8)
    rank = _initial(dseq)
    k = 1
    sa = None
    while True:
        rank, sa, maxr = _round(rank, jnp.asarray(k, rank.dtype))
        if int(maxr) == n - 1:
            break
        k *= 2
        if k > 2 * n:  # safety: cannot happen for valid input
            raise RuntimeError("prefix doubling failed to converge")
    prev = jnp.where(sa == 0, n - 1, sa - 1)
    bwt = jnp.take(dseq, prev)
    return np.asarray(jax.device_get(bwt))
