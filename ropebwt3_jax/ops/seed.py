"""Precomputed k-mer seed table for the SMEM-TG kernel.

The TG algorithm (fm-index.c:483-528) starts every window attempt from the
bi-interval of a single symbol and backward-extends one symbol per step.  The
first k-1 of those steps compute, deterministically, the bi-interval of the
window's last k symbols — so a table of all 4**k k-mer bi-intervals lets a
lane jump straight to step k.  Bit-exactness is preserved because the jump is
taken only when the table interval has size >= min_occ: a jump then lands in
exactly the state k sequential successful extends produce, while any window
whose k-suffix dies early falls back to the sequential path so the failure
position (which determines the restart point x) is found exactly as the
reference finds it.

The table is built on device: all 4**k keys run k-1 batched backward-extend
steps in lock-step (the same `ops.rank.extend` the kernel uses), chunked to
bound the (C, 6, 3) intermediate.  Cost is ~k * 4**k ranks.  Empty intervals propagate as size 0 with valid coordinates
(rank of an empty range), matching sequential extension.
"""

from __future__ import annotations

from functools import partial

from .. import _jax_setup as __jx

__jx()
import jax
import jax.numpy as jnp
import numpy as np

from .rank import DeviceIndex, extend, set_intv


@partial(jax.jit, static_argnames=("k",))
def _seed_chunk(idx: DeviceIndex, keys: jax.Array, k: int) -> jax.Array:
    """keys: (C,) int32 k-mer codes, big-endian base-4 over symbols-1.
    Returns (C, 3) bi-intervals of the corresponding k-mers."""
    # backward search: start from the last symbol, prepend towards the first
    sym_last = ((keys & 3) + 1).astype(jnp.int32)
    ik = set_intv(idx, sym_last)
    back = jnp.ones(keys.shape, bool)

    def step(t, ik):
        # symbol at text position k-2-t counting from the key's high digits
        shift = (2 * (t + 1)).astype(jnp.int32)
        c = ((jax.lax.shift_right_logical(keys, shift) & 3) + 1).astype(jnp.int32)
        ok_all = extend(idx, ik, back)  # (C, 6, 3)
        sel = (jax.lax.broadcasted_iota(jnp.int32, ok_all.shape[:2], 1) == c[:, None]).astype(ok_all.dtype)
        return jnp.sum(ok_all * sel[:, :, None], axis=1, dtype=ok_all.dtype)

    return jax.lax.fori_loop(0, k - 1, step, ik)


def build_seed_table(idx: DeviceIndex, k: int, max_chunk: int = 1 << 22) -> jax.Array:
    """(4**k, 3) idx-dtype table; row key = sum((sym_t - 1) * 4**(k-1-t))."""
    total = 4**k
    if total <= max_chunk:
        return _seed_chunk(idx, jnp.arange(total, dtype=jnp.int32), k)
    parts = []
    for c0 in range(0, total, max_chunk):
        keys = jnp.arange(c0, c0 + max_chunk, dtype=jnp.int32)
        parts.append(_seed_chunk(idx, keys, k))
    return jnp.concatenate(parts, axis=0)


def seed_keys(q: jax.Array, qlen: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Per-position k-mer codes over the query batch.

    q: (Q, L) int32 nt6; returns (keys (Q, L) int32, valid (Q, L) bool) where
    keys[l, p] encodes q[l, p:p+k] and valid requires every symbol in 1..4
    and p + k <= qlen[l]."""
    Q, L = q.shape
    keys = jnp.zeros((Q, L), jnp.int32)
    valid = jnp.ones((Q, L), bool)
    zpad = jnp.zeros((Q, k), jnp.int32)
    qp = jnp.concatenate([q, zpad], axis=1)
    for t in range(k):
        sym = jax.lax.dynamic_slice_in_dim(qp, t, L, axis=1)
        keys = keys * 4 + (sym - 1)
        valid = valid & (sym >= 1) & (sym <= 4)
    pos = jax.lax.broadcasted_iota(jnp.int32, (Q, L), 1)
    valid = valid & (pos + k <= qlen[:, None])
    return keys, valid
