"""Device hapdiv: lock-step BWA-SW DP over linear DAWGs.

Re-expresses sw_core (bwa-sw.c:329-526) in anno/e2e mode as a batched JAX
computation: W windows run the SAME node sequence in lock-step — per node one
batched bidirectional extend over all (W, N) row cells, a sorted-segment
candidate merge, khashl bucket assignment, and F-closure rounds whose extends
batch across windows.  Counts per window (n_al, max_ed, n_hap[0..6]) match
the host engine bit-for-bit (align/bwasw.py sw_core_multi is the executable
spec; that in turn is golden vs the reference binary).

Exactness notes (why this can be vectorized at all):

* klib bounded-heap selection (bwa-sw.c:432-443) reduces to the top-N of the
  packed keys (H << 32 | bucket): a bounded min-heap's final CONTENT is the
  N largest keys regardless of insertion order, and ks_heapsort emits them
  in descending key order.  Only the khashl BUCKET INDEX therefore needs
  exact emulation (it is the tie-break for equal scores), not the heap.
* khashl bucket assignment is replayed per node for the unique keys in
  first-occurrence order; with a fixed 128-bucket table (kh_resize(n_best*4),
  bwa-sw.c:353) the linear probe of a NEW key is "first empty slot from the
  Fibonacci home bucket" — a vectorized masked argmin.  A window that would
  trigger khashl's mid-node resize (count >= 96) is flagged `bad` and rerun
  on the exact host engine.
* sw_update_candset merges (bwa-sw.c:265-284) are running maxes; first-
  attainment slots give the From fields.  The single order-sensitive corner
  (an E-type candidate raising H above earlier H-type candidates of the SAME
  (lo,hi) key, which leaves H_from_pos at an intermediate value) is detected
  and `bad`-flagged instead of simulated.
* The F-closure (bwa-sw.c:445-483) is a per-window DFS; its pops interleave
  as lock-step rounds (one batched extend per round), with each window's own
  heap-min/pending-min sequence tracked exactly — same scheme as the host
  sw_core_multi, which is equivalence-tested against the scalar reference.

Windows flagged `bad` (candset resize, stack/fpar overflow, the H_from_pos
corner, >4095 scores) are recomputed by the caller on the host engine, so the
combined result is always exact.
"""

from __future__ import annotations

from functools import partial

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rank import DeviceIndex, extend as rank_extend

N_BEST = 25  # opt.n_best default; static in this kernel
NB = 128  # khashl buckets after kh_resize(n_best*4) -> bits=7
NB_BITS = 7
MAXC = 96  # khashl max_count(128): resize (-> bad flag) at count >= 96
SCAP = 48  # F-closure stack capacity per window (overflow -> bad)
FCAP = 64  # fpar entries per node per window (overflow -> bad)
UNSET = np.int32(0x3FFFFFF)  # SW_F_UNSET
FROM_H, FROM_E, FROM_F = 0, 1, 2
FROM_OPEN, FROM_EXT = 0, 1
BIGI = np.int32(0x7FFFFFFF)
KEY_EMPTY = np.int64(-1)
KEY_HUGE = np.int64(0x7FFFFFFFFFFFFFFF)

import os as _os


def _splitmix(x):
    """kh_hash_uint64 (khashl-km.h): splitmix64 finalizer truncated to u32."""
    x = x.astype(jnp.uint64)
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x & np.uint64(0xFFFFFFFF)).astype(jnp.int64)


def _home_bucket(key, nb_bits: int = NB_BITS):
    """Fibonacci bucket map __kh_h2b(hash, bits) of sw_cell_hash.

    nb_bits follows kh_resize(n_best*4): bits = ceil(log2(4*n_best))
    (khashl-km.h:135-147) — parameterized so non-default -N values keep the
    exact reference bucket/probe order (round-3: gate widened from the baked
    n_best range to any N whose table fits)."""
    lo = (key >> np.int64(32)) & np.int64(0xFFFFFFFF)
    hi = key & np.int64(0xFFFFFFFF)
    h = (_splitmix(lo) + _splitmix(hi)) & np.int64(0xFFFFFFFF)
    return (((h * np.int64(2654435769)) & np.int64(0xFFFFFFFF)) >> np.int64(32 - nb_bits)).astype(jnp.int32)


def nb_params(n_best: int) -> tuple[int, int, int]:
    """(nb_bits, nb, maxc) for kh_resize(n_best*4): bucket count is the
    power of two >= 4*n_best; max_count = 75% load (khashl-km.h:77-78).
    A node whose unique-candidate count reaches maxc would make the
    reference REHASH mid-put (different subsequent probe order) — such
    windows are flagged `bad` and rerun on the host."""
    nb_bits = max(2, (4 * int(n_best) - 1).bit_length())
    nb = 1 << nb_bits
    return nb_bits, nb, (nb >> 1) + (nb >> 2)


def _seg_scan_max(head, vals):
    """Segmented inclusive running-max along axis=1; segments start at head."""
    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, jnp.maximum(va, vb))

    _, out = jax.lax.associative_scan(comb, (head, vals), axis=1)
    return out


def _seg_scan_min(head, vals):
    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, jnp.minimum(va, vb))

    _, out = jax.lax.associative_scan(comb, (head, vals), axis=1)
    return out


def _seg_broadcast_from_tail(head, vals):
    """Copy each segment's LAST value to all its elements (reverse fill)."""
    # tail of segment s = element before the next head (or the end)
    tail = jnp.concatenate([head[:, 1:], jnp.ones_like(head[:, :1])], axis=1)

    def comb(a, b):
        # value at the LATEST flagged element of the combined range
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va)

    rt = (jnp.flip(tail, 1), jnp.flip(vals, 1))
    _, out = jax.lax.associative_scan(comb, rt, axis=1)
    return jnp.flip(out, 1)


def _ftake(arr2d, col):
    """arr2d[w, col[w]] as a flat 1-D take (the axis-0 gather lowering)."""
    W, S = arr2d.shape
    base = jnp.arange(W, dtype=jnp.int32) * np.int32(S)
    return jnp.take(arr2d.reshape(-1), base + col.astype(jnp.int32))


def _ftake2(arr2d, cols):
    """arr2d[w, cols[w, j]] (cols (W, J)) as one flat take."""
    W, S = arr2d.shape
    base = (jnp.arange(W, dtype=jnp.int32) * np.int32(S))[:, None]
    return jnp.take(arr2d.reshape(-1), base + cols.astype(jnp.int32))


def _ctz32(x):
    """Count trailing zeros of a uint32 vector (32 for x == 0): elementwise
    isolate-lowest-set-bit + population_count — no reduce, so it fuses."""
    t = x & (~x + jnp.uint32(1))
    return jax.lax.population_count(t - jnp.uint32(1)).astype(jnp.int32)


# unroll=8 hits an XLA compile cliff (~12x compile time, CPU probe); 4 is
# flat-cost and still fuses 4 placements per launch
_KH_UNROLL = int(_os.environ.get("RB3JAX_KHASHL_UNROLL", "4"))


def bucket_scan(u_home, u_count, bad, NB: int, UCAP: int, unroll: int = _KH_UNROLL):
    """khashl linear-probe replay (first empty slot cyclically from the home
    bucket, khashl-km.h) with the occupancy held as a BITMASK in uint32
    words.  The (W, NB) argmin formulation paid ~3 kernel launches per placed
    key (the argmin reduce splits the fusion); here every
    placement is pure elementwise math — empties at-or-after the home via a
    shifted mask, first set bit via ctz, wraparound via the complement mask —
    so XLA fuses `unroll` placements into ~one launch.

    Returns u_bucket (W, UCAP) int32; exact vs the sequential replay
    (tests/test_hapdiv_jax.py::test_bucket_scan_matches_sequential)."""
    W = u_home.shape[0]
    nw = max(1, NB // 32)  # NB is a power of two (nb_params)
    full = jnp.uint32(0xFFFFFFFF if NB >= 32 else (1 << NB) - 1)

    def body(used, xs):
        u, home = xs
        act = (u < u_count) & ~bad
        q = home >> 5
        r = (home & np.int32(31)).astype(jnp.uint32)
        idx = jnp.full((W,), np.int32(32 * nw), jnp.int32)  # none found
        idxB = jnp.full((W,), np.int32(32 * nw), jnp.int32)
        for k in range(nw - 1, -1, -1):
            E = ~used[k] & full
            # bits of word k at-or-after the home bit (cyclic split mask)
            ge = jnp.where(
                q < k, full, jnp.where(q > k, jnp.uint32(0), (full << r) & full)
            )
            A = E & ge
            B = E & ~ge
            cA = _ctz32(A)
            cB = _ctz32(B)
            idx = jnp.where(cA < 32, np.int32(32 * k) + cA, idx)
            idxB = jnp.where(cB < 32, np.int32(32 * k) + cB, idxB)
        b = jnp.where(idx < np.int32(32 * nw), idx, idxB)
        b = jnp.minimum(b, np.int32(NB - 1))  # never hit: table load < 3/4
        word = b >> 5
        bit = (b & np.int32(31)).astype(jnp.uint32)
        used = tuple(
            jnp.where(act & (word == k), used[k] | (jnp.uint32(1) << bit), used[k])
            for k in range(nw)
        )
        return used, b

    used0 = tuple(jnp.zeros((W,), jnp.uint32) for _ in range(nw))
    _, bT = jax.lax.scan(
        body, used0,
        (jnp.arange(UCAP, dtype=jnp.int32), u_home.T[:UCAP]),
        unroll=min(unroll, UCAP),
    )
    return bT.T


def _pick(arr2d, col):
    """arr2d[w, col[w]] via a one-hot masked reduce.  Gather-free: flat takes
    cost ~9 ns/ELEMENT on this runtime (one (W,) pick = ~37 us at W=4096,
    measured as the dominant cost of the closure/bucket loops — round-3
    ablation sweep), while the equivalent one-hot reduce over a narrow row
    (NB<=128 / SCAP=48 wide) is a handful of fused element ops."""
    oh = jax.lax.broadcasted_iota(jnp.int32, arr2d.shape, 1) == col[:, None]
    return jnp.sum(jnp.where(oh, arr2d, jnp.zeros((), arr2d.dtype)), axis=1, dtype=arr2d.dtype)


def _pick2(arr2d, cols):
    """arr2d[w, cols[w, j]] via a one-hot reduce over (W, J, S) — use only
    when J*S is small (the flat-take twin _ftake2 costs 9 ns/element)."""
    oh = cols[:, :, None] == jax.lax.broadcasted_iota(
        jnp.int32, (arr2d.shape[0], cols.shape[1], arr2d.shape[1]), 2
    )
    return jnp.sum(jnp.where(oh, arr2d[:, None, :], jnp.zeros((), arr2d.dtype)), axis=2, dtype=arr2d.dtype)


def _onehot_set(arr2d, col, val, mask):
    """arr2d with arr2d[w, col[w]] = val[w] where mask[w] (one-hot select
    instead of a scatter)."""
    S = arr2d.shape[1]
    sel = (jax.lax.broadcasted_iota(jnp.int32, arr2d.shape, 1) == col[:, None]) & mask[:, None]
    v = val[:, None] if val.ndim == 1 else val
    return jnp.where(sel, v.astype(arr2d.dtype), arr2d)


# score/len word packing (tsc): H(12) E(12) F(12) rlen(9) qlen(9) Hfrom(2)
# Efrom(1) Ffrom(1) Foffset(1) = 59 bits
_SH_E, _SH_F, _SH_RL, _SH_QL, _SH_HF, _SH_EF, _SH_FF, _SH_FO = 12, 24, 36, 45, 54, 56, 57, 58
_M12, _M9 = np.int64(0xFFF), np.int64(0x1FF)


def _pack_sc(H, E, F, rlen, qlen, Hfrom, Efrom, Ffrom, Foffset):
    return (
        H.astype(jnp.int64)
        | E.astype(jnp.int64) << _SH_E
        | F.astype(jnp.int64) << _SH_F
        | rlen.astype(jnp.int64) << _SH_RL
        | qlen.astype(jnp.int64) << _SH_QL
        | Hfrom.astype(jnp.int64) << _SH_HF
        | Efrom.astype(jnp.int64) << _SH_EF
        | Ffrom.astype(jnp.int64) << _SH_FF
        | Foffset.astype(jnp.int64) << _SH_FO
    )


def _unpack_sc(w):
    H = (w & _M12).astype(jnp.int32)
    E = ((w >> _SH_E) & _M12).astype(jnp.int32)
    F = ((w >> _SH_F) & _M12).astype(jnp.int32)
    rlen = ((w >> _SH_RL) & _M9).astype(jnp.int32)
    qlen = ((w >> _SH_QL) & _M9).astype(jnp.int32)
    Hfrom = ((w >> _SH_HF) & np.int64(3)).astype(jnp.int32)
    Efrom = ((w >> _SH_EF) & np.int64(1)).astype(jnp.int32)
    Ffrom = ((w >> _SH_FF) & np.int64(1)).astype(jnp.int32)
    Foffset = ((w >> _SH_FO) & np.int64(1)).astype(jnp.int32)
    return H, E, F, rlen, qlen, Hfrom, Efrom, Ffrom, Foffset


# position word (tpos): Hpos(16) Epos(16) Foff(26); 0xFFFF = UINT32_MAX pos
_PNONE = np.int32(0xFFFF)


def _pack_pos(Hpos, Epos, Foff):
    return (
        (Hpos.astype(jnp.int64) & np.int64(0xFFFF))
        | (Epos.astype(jnp.int64) & np.int64(0xFFFF)) << 16
        | (Foff.astype(jnp.int64) & np.int64(0x3FFFFFF)) << 32
    )


def _unpack_pos(w):
    Hpos = (w & np.int64(0xFFFF)).astype(jnp.int32)
    Epos = ((w >> 16) & np.int64(0xFFFF)).astype(jnp.int32)
    Foff = ((w >> 32) & np.int64(0x3FFFFFF)).astype(jnp.int32)
    return Hpos, Epos, Foff


class HapdivDeviceEngine:
    """CLI driver: equal-length window batches through hapdiv_device with
    exact host fallback for flagged windows (and for option/scale corners the
    kernel's packed words cannot represent)."""

    def __init__(self, f, opt, lanes: int = 4096, mesh=None):
        from .bwasw import RB3_SWF_E2E, RB3_SWF_HAPDIV
        from .. import require_device

        require_device()

        self.f = f
        self.opt = opt
        self.lanes = lanes
        # windows run data-parallel over the mesh's `dp` axis (tables
        # replicated): the DP is independent per window, so GSPMD partitions
        # it from the input sharding alone — validated in dryrun_multichip
        self.mesh = mesh
        self.idx = None  # lazy: building device tables costs seconds
        # packed-word limits: scores 12 bits, rlen/qlen 9 bits, F_from_off
        # archive field 5 bits, key packing lo/hi < 2^32.  The khashl bucket
        # table is parameterized on n_best (nb_params: kh_resize(n_best*4)
        # geometry + matching Fibonacci shift), so any practical -N keeps the
        # exact reference probe order — round 3 widened the former 17..31
        # gate (which was baked at 128 buckets).
        self.supported = (
            f.n < (1 << 32)
            # upper bound: the F-closure stack holds SCAP slots and is seeded
            # with up to n_best cells (N > SCAP would make the (W, SCAP-N)
            # pad shape negative — caught by the differential fuzzer)
            and 2 <= opt.n_best <= min(64, SCAP)
            and opt.e2e_drop < 0
            and (opt.flag & (RB3_SWF_E2E | RB3_SWF_HAPDIV)) == (RB3_SWF_E2E | RB3_SWF_HAPDIV)
        )

    def _stage(self, a: np.ndarray):
        if self.mesh is None:
            return jnp.asarray(a)
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(a, NamedSharding(self.mesh, P("dp", *([None] * (a.ndim - 1)))))

    def run(self, wins: list[np.ndarray]) -> list:
        """Returns a list of HapDiv (never None; a no-alignment window is the
        all-zero HapDiv, which emits identically to the host's None)."""
        from .bwasw import HapDiv, rb3_hapdiv_multi

        if not wins:
            return []
        K = len(wins[0])
        if not (self.supported and K <= 509 and all(len(w) == K for w in wins)):
            return [r if r is not None else HapDiv() for r in rb3_hapdiv_multi(self.opt, self.f, wins)]
        if self.idx is None:
            self.idx = DeviceIndex.from_dense(self.f)
            if self.mesh is not None:
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P

                self.idx = jax.device_put(self.idx, NamedSharding(self.mesh, P()))
        o = self.opt
        arr = np.zeros((len(wins), K), np.int32)
        for i, w in enumerate(wins):
            arr[i] = w
        out: list = [None] * len(wins)
        bad_idx: list[int] = []
        # small batches compile at a smaller power-of-two lane bucket
        lanes = min(self.lanes, max(64, 1 << (len(wins) - 1).bit_length()))
        if self.mesh is not None:  # lane count must tile over the dp axis
            dp = self.mesh.shape["dp"]
            lanes = -(-lanes // dp) * dp
        for c0 in range(0, len(wins), lanes):
            chunk = arr[c0 : c0 + lanes]
            wn = len(chunk)
            if wn < lanes:  # pad: all-$ windows produce empty rows
                chunk = np.concatenate([chunk, np.zeros((lanes - wn, K), np.int32)])
            n_al, max_ed, n_hap, bad = hapdiv_device(
                self.idx, self._stage(chunk), K, n_best=o.n_best, min_sc=o.min_sc,
                end_len=o.end_len, match=o.match, mis=o.mis, gap_open=o.gap_open,
                gap_ext=o.gap_ext,
            )
            from ..parallel.launch import to_host

            # to_host: np.asarray single-process; allgather when the mesh
            # spans multiple jax.distributed processes
            n_al, max_ed, n_hap, bad = (to_host(n_al), to_host(max_ed), to_host(n_hap), to_host(bad))
            for i in range(wn):
                if bad[i]:
                    bad_idx.append(c0 + i)
                else:
                    r = HapDiv()
                    r.n_al, r.max_ed, r.n_hap = int(n_al[i]), int(max_ed[i]), [int(x) for x in n_hap[i]]
                    out[c0 + i] = r
        if bad_idx:
            redo = rb3_hapdiv_multi(self.opt, self.f, [wins[i] for i in bad_idx])
            for i, r in zip(bad_idx, redo):
                out[i] = r if r is not None else HapDiv()
        return out


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7, 8, 9))
def hapdiv_device(idx: DeviceIndex, seqs, K: int, n_best: int = N_BEST, min_sc: int = 30,
                  end_len: int = 1, match: int = 1, mis: int = 3, gap_open: int = 5, gap_ext: int = 2):
    """hapdiv anno DP for W windows of length K (seqs (W, K) int32 nt6).

    Returns (n_al (W,), max_ed (W,), n_hap (W, 7) int64, bad (W,) bool).
    `bad` windows must be recomputed on the host engine (see module doc).
    Cites: rb3_hapdiv (bwa-sw.c:562-568), sw_core (bwa-sw.c:329-526),
    sw_backtrack anno mode (bwa-sw.c:218-259)."""
    W = seqs.shape[0]
    N = n_best
    S = N * 6  # candidate slots per node: per row cell 5 H-cands + 1 E-cand
    # khashl table geometry follows kh_resize(n_best*4) so non-default -N
    # keeps the exact bucket/probe order (shadows the module defaults)
    NB_BITS_, NB, MAXC = nb_params(n_best)
    dt = idx.idx_dtype
    acc = idx.acc

    # node symbols: node i consumes seq[K-1-(i-1)] (dawg_gen_linear,
    # dawg.c:230-250 — backward extension over the reversed query)
    syms = jnp.flip(seqs.astype(jnp.int32), axis=1).T  # (K, W)

    iota_n = jax.lax.broadcasted_iota(jnp.int32, (W, N), 1)
    iota_nb = jax.lax.broadcasted_iota(jnp.int32, (W, NB), 1)
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (W, S), 1)

    # ---- root row ---------------------------------------------------------
    row = dict(
        lo=jnp.zeros((W, N), dt),
        hi=jnp.where(iota_n == 0, jnp.asarray(acc[6], dt), jnp.zeros((), dt)),
        lorc=jnp.zeros((W, N), dt),
        H=jnp.zeros((W, N), jnp.int32),
        E=jnp.zeros((W, N), jnp.int32),
        F=jnp.zeros((W, N), jnp.int32),
        rlen=jnp.zeros((W, N), jnp.int32),
        qlen=jnp.zeros((W, N), jnp.int32),
        Hfrom=jnp.zeros((W, N), jnp.int32),
        Efrom=jnp.zeros((W, N), jnp.int32),
        Ffrom=jnp.zeros((W, N), jnp.int32),
        Foffset=jnp.zeros((W, N), jnp.int32),
        Hpos=jnp.zeros((W, N), jnp.int32),
        Epos=jnp.zeros((W, N), jnp.int32),
        Foff=jnp.full((W, N), UNSET, jnp.int32),
        valid=iota_n == 0,
    )
    bad0 = jnp.zeros((W,), bool)

    def node_body(carry, xs):
        row, bad = carry
        node_i, c_node = xs  # node index i (scalar), node symbols (W,)
        pos_base = (node_i - 1) * np.int32(N)  # H_from_pos of a prev-row cell

        n_prev = jnp.sum(row["valid"], axis=1).astype(jnp.int32)
        # w.last_p = last batch-visited prev cell (bwa-sw.c keeps the pointer
        # dangling across cells); gates the F-closure via qlen >= end_len
        lastp_qlen = _pick(row["qlen"], jnp.maximum(n_prev - 1, 0))
        gate_f = (lastp_qlen >= np.int32(end_len)) & (n_prev > 0)

        # ---- one batched extend of the whole prev row ---------------------
        ik = jnp.stack(
            [row["lo"], row["lorc"], jnp.where(row["valid"], row["hi"] - row["lo"], jnp.zeros((), dt))],
            axis=-1,
        )
        ok = rank_extend(idx, ik.reshape(W * N, 3), jnp.ones((W * N,), bool)).reshape(W, N, 6, 3)

        # ---- candidate slots (reference insert order: cell k, c=1..5, E) --
        pH, pE = row["H"], row["E"]
        c_n = c_node[:, None]  # (W,1)
        cand = {}
        sym = (iota_s % 6 + 1)  # 1..5 H-cands, 6 => E-slot
        is_e = sym == 6
        sym_c = jnp.minimum(sym, 5)

        def rep6(a):
            # candidate slot s = (k, c): per-cell values repeat along c —
            # pure reshape/broadcast, NOT a gather (element gathers measured
            # 9 ns/elem on this chip, scripts/op_probe.py)
            return jnp.broadcast_to(a[:, :, None], (W, N, 6)).reshape(W, S)

        # ok slots (k, c=1..5) come from a reshape; the E slot (unused ok
        # fields) duplicates c=5
        ok15 = ok[:, :, 1:6, :]  # (W, N, 5, 3)
        ok16 = jnp.concatenate([ok15, ok15[:, :, 4:5, :]], axis=2)  # (W,N,6,3)
        e_lo = ok16[..., 0].reshape(W, S)
        e_rc = ok16[..., 1].reshape(W, S)
        e_sz = ok16[..., 2].reshape(W, S)
        pHk = rep6(pH)
        pEk = rep6(pE)
        pqlen = rep6(row["qlen"])
        prlen = rep6(row["rlen"])
        pvalid = rep6(row["valid"].astype(jnp.int32)) == 1
        sc = jnp.where((sym_c == c_n) & (sym_c != 5), np.int32(match), np.int32(-mis))
        h_pass = (
            pvalid
            & ~is_e
            & (e_sz > 0)
            & (pHk + sc > 0)
            & ((sym_c == c_n) | (pqlen >= np.int32(end_len)))
        )
        # stale lo_rc for the E-slot: lo_rc of the cell's LAST passing H-cand
        # (bwa-sw.c:418 quirk — only lo/hi are set on the E path)
        hp_full = (h_pass & ~is_e).reshape(W, N, 6)
        hp_i = jnp.where(hp_full, jax.lax.broadcasted_iota(jnp.int32, (W, N, 6), 2) + 1, 0)
        last_c = jnp.max(hp_i, axis=2)  # (W,N) 0 => none; value = c (1..5)
        oh_last = (
            jax.lax.broadcasted_iota(jnp.int32, (W, N, 5), 2) + 1 == last_c[:, :, None]
        ).astype(dt)
        stale_rc = jnp.sum(ok15[..., 1] * oh_last, axis=2, dtype=dt)  # (W,N)
        stale_rc_s = rep6(stale_rc)
        e_open = pHk - np.int32(gap_open) > pEk
        e_val = jnp.where(e_open, pHk - np.int32(gap_open), pEk) - np.int32(gap_ext)
        e_from = jnp.where(e_open, np.int32(FROM_OPEN), np.int32(FROM_EXT))
        e_pass = pvalid & is_e & (e_val > 0) & (pqlen >= np.int32(end_len))
        p_lo = rep6(row["lo"])
        p_hi = rep6(row["hi"])
        cand["valid"] = h_pass | e_pass
        lo_s = jnp.where(is_e, p_lo, e_lo)
        hi_s = jnp.where(is_e, p_hi, e_lo + e_sz)
        cand["key"] = jnp.where(
            cand["valid"],
            (lo_s.astype(jnp.int64) << 32) | hi_s.astype(jnp.int64),
            KEY_HUGE,
        )
        cand["lorc"] = jnp.where(is_e, stale_rc_s, e_rc)
        cand["H"] = jnp.where(is_e, e_val, pHk + sc)
        cand["E"] = jnp.where(is_e, e_val, np.int32(0))
        cand["rlen"] = jnp.where(is_e, prlen, prlen + 1)
        cand["qlen"] = pqlen + 1
        cand["Hfrom"] = jnp.where(is_e, np.int32(FROM_E), np.int32(FROM_H))
        cand["Efrom"] = jnp.where(is_e, e_from, np.int32(0))
        kcol = iota_s // 6  # source row cell of slot s
        cand["Hpos"] = jnp.where(is_e, np.int32(-1), pos_base + kcol)
        cand["Epos"] = jnp.where(is_e, pos_base + kcol, np.int32(-1))
        bad = bad | jnp.any(cand["valid"] & (cand["H"] > 4095), axis=1)  # tsc pack cap

        # ---- phase A: sorted-segment dedup + running-max merge -------------
        # ONE variadic stable sort carries every candidate field alongside the
        # key (element gathers cost ~9 ns/elem on this chip — applying an
        # argsort permutation to 10 field arrays was ~50 ms/node;
        # scripts/op_probe.py), then ONE forward segmented scan computes all
        # running maxes WITH the first-attainment From fields riding in the
        # monoid, and ONE backward scan broadcasts each segment's final values
        # back to its head.
        spos = jax.lax.broadcasted_iota(jnp.int32, (W, S), 1)
        cvalid = cand["valid"]
        scw0 = _pack_sc(
            jnp.where(cvalid, cand["H"], 0), jnp.where(cvalid, cand["E"], 0),
            jnp.zeros((W, S), jnp.int32), jnp.where(cvalid, cand["rlen"], 0),
            jnp.where(cvalid, cand["qlen"], 0), cand["Hfrom"], cand["Efrom"],
            jnp.zeros((W, S), jnp.int32), jnp.zeros((W, S), jnp.int32),
        )
        posw0 = _pack_pos(
            jnp.where(cand["Hpos"] < 0, _PNONE, cand["Hpos"]),
            jnp.where(cand["Epos"] < 0, _PNONE, cand["Epos"]),
            jnp.full((W, S), UNSET, jnp.int32),
        )
        key_s, slot_s, scw_s, posw_s, lorc_s = jax.lax.sort(
            (cand["key"], spos, scw0, posw0, cand["lorc"]),
            dimension=1, is_stable=True, num_keys=1,
        )
        valid_s = key_s != KEY_HUGE
        head = jnp.concatenate(
            [jnp.ones((W, 1), bool), key_s[:, 1:] != key_s[:, :-1]], axis=1
        )
        H_s, E_s, _, rl_s, ql_s, Hfrom_s, Efrom_s, _, _ = _unpack_sc(scw_s)
        Hpos_s, Epos_s, _ = _unpack_pos(posw_s)

        # forward segmented scan: first-attainment argmax monoid — on a
        # strict increase the element's From fields replace the carry; ties
        # keep the left (earlier) tuple, reproducing sw_update_candset's
        # strict `<` merges (bwa-sw.c:265-284)
        def fcomb(a, b):
            fa = a["f"]
            fb = b["f"]
            o = {"f": fa | fb}
            upH = b["mH"] > a["mH"]
            for k in ("mH", "hf", "hp"):
                o[k] = jnp.where(fb, b[k], jnp.where(upH, b[k], a[k]))
            o["hstart"] = jnp.where(fb, b["hstart"], jnp.where(upH, False, a["hstart"]))
            upE = b["mE"] > a["mE"]
            for k in ("mE", "ef", "ep"):
                o[k] = jnp.where(fb, b[k], jnp.where(upE, b[k], a[k]))
            o["mrl"] = jnp.where(fb, b["mrl"], jnp.maximum(a["mrl"], b["mrl"]))
            o["mql"] = jnp.where(fb, b["mql"], jnp.maximum(a["mql"], b["mql"]))
            # value-at-segment-head fields: keep the left's unless b resets
            for k in ("hp_head", "slot_head", "lorc_head", "key_head"):
                o[k] = jnp.where(fb, b[k], a[k])
            return o

        elems = dict(
            f=head, mH=H_s, hf=Hfrom_s, hp=Hpos_s, hstart=jnp.ones((W, S), bool),
            mE=E_s, ef=Efrom_s, ep=Epos_s, mrl=rl_s, mql=ql_s,
            hp_head=Hpos_s, slot_head=slot_s, lorc_head=lorc_s, key_head=key_s,
        )
        fw = jax.lax.associative_scan(fcomb, elems, axis=1)

        # backward: broadcast each segment's TAIL aggregate to all elements
        tail = jnp.concatenate([head[:, 1:], jnp.ones((W, 1), bool)], axis=1)

        def bcomb(a, b):
            o = {"f": a["f"] | b["f"]}
            for k in a:
                if k != "f":
                    o[k] = jnp.where(b["f"], b[k], a[k])
            return o

        bw_in = {k: jnp.flip(v, 1) for k, v in fw.items() if k not in ("hp_head", "slot_head", "lorc_head", "key_head")}
        bw_in["f"] = jnp.flip(tail, 1)
        bw = {k: jnp.flip(v, 1) for k, v in jax.lax.associative_scan(bcomb, bw_in, axis=1).items()}

        # H_from_pos rule: first attainment at the segment head -> head's own
        # value (absent-insert copies all fields); H-type -> its value;
        # E-type past the head needs the event chain -> bad-flag (module doc)
        ambiguous = (~bw["hstart"]) & (bw["hf"] == np.int32(FROM_E))
        bad = bad | jnp.any(head & valid_s & ambiguous, axis=1)
        gHpos = jnp.where(bw["hstart"], fw["hp_head"], bw["hp"])

        # compact uniques in FIRST-OCCURRENCE order (khashl insert order):
        # one more variadic sort over the head rows
        u_scw = _pack_sc(
            bw["mH"], bw["mE"], jnp.zeros((W, S), jnp.int32), bw["mrl"], bw["mql"],
            bw["hf"], bw["ef"], jnp.zeros((W, S), jnp.int32), jnp.zeros((W, S), jnp.int32),
        )
        u_posw = _pack_pos(gHpos, bw["ep"], jnp.full((W, S), UNSET, jnp.int32))
        ukey_src = jnp.where(head & valid_s, fw["slot_head"], BIGI)
        ukey_sorted, u_key, u_sc, u_pos, u_lorc = jax.lax.sort(
            (ukey_src, jnp.where(head & valid_s, key_s, KEY_EMPTY), u_scw, u_posw, lorc_s),
            dimension=1, is_stable=True, num_keys=1,
        )
        u_valid = ukey_sorted != BIGI
        u_count = jnp.sum(u_valid, axis=1).astype(jnp.int32)
        bad = bad | (u_count >= np.int32(MAXC))  # khashl would resize mid-node

        # ---- bucket assignment: replay khashl inserts (first-occurrence) --
        # lax.scan with the per-u home fed as xs and the bucket emitted as ys.
        # The former while_loop's per-iteration element gathers (_ftake of the
        # home and the buckets carry) and the (W, S) COLUMN
        # dynamic_update_slice made the probe loop the bulk of the kernel.
        # The scan body is 4 lean (W, NB) ops with no
        # gather and no carry-side bucket writes; iteration count is the
        # static u cap (count >= MAXC is bad-flagged, so u < MAXC-1 covers
        # every non-bad window — the data-dependent early exit bought less
        # than its fat body cost).
        u_home = _home_bucket(u_key, NB_BITS_)
        UCAP = min(S, MAXC - 1)
        u_bucket = bucket_scan(u_home, u_count, bad, NB, UCAP)
        if S > UCAP:
            u_bucket = jnp.concatenate([u_bucket, jnp.zeros((W, S - UCAP), jnp.int32)], axis=1)

        # ---- materialize the 128-bucket table -----------------------------
        # buckets are unique per window, so a one-hot (W, S, NB) reduction
        # yields each bucket's source row directly, and ONE row-gather pulls
        # all four field words (scatter-free; replaces a binary search whose
        # per-step element gathers cost ~5 ms each)
        bvalid = u_valid & ~bad[:, None]
        oh_b = (u_bucket[:, :, None] == iota_nb[:, None, :]) & bvalid[:, :, None]
        hitj = jnp.any(oh_b, axis=1)
        uiota = jax.lax.broadcasted_iota(jnp.int32, (W, S, 1), 1)
        srcu = jnp.sum(oh_b * uiota, axis=1)  # (W, NB)
        rows_u = jnp.stack(
            [u_key, u_sc, u_pos, u_lorc.astype(jnp.int64)], axis=-1
        ).reshape(W * S, 4)
        base_w = (jnp.arange(W, dtype=jnp.int32) * np.int32(S))[:, None]
        g = jnp.take(rows_u, base_w + srcu, axis=0)  # (W, NB, 4) row gather
        tkey = jnp.where(hitj, g[..., 0], KEY_EMPTY)
        tsc = jnp.where(hitj, g[..., 1], np.int64(0))
        tpos = jnp.where(hitj, g[..., 2], _pack_pos(jnp.full((W, NB), _PNONE), jnp.full((W, NB), _PNONE), jnp.full((W, NB), UNSET)))
        tlorc = jnp.where(hitj, g[..., 3].astype(dt), jnp.zeros((), dt))
        count = jnp.where(bad, 0, u_count)

        # ---- first selection: top-N by (H << 32 | bucket) ------------------
        def topn(tkey, tsc):
            tH = (tsc & _M12).astype(jnp.int64)
            x = jnp.where(tkey != KEY_EMPTY, (tH << 32) | iota_nb.astype(jnp.int64), np.int64(-1))
            xs = jnp.sort(x, axis=1, descending=True)[:, :N]
            return xs

        row_x = topn(tkey, tsc)

        # ---- F-closure ------------------------------------------------------
        # heap: the bounded min-heap's VALUE multiset as a sorted-ascending
        # (W, N) array (heap[0] == min); entries are (H<<32|id) keys
        heap = jnp.flip(row_x, 1)  # ascending; -1 = empty slot
        hlen = jnp.sum(row_x >= 0, axis=1).astype(jnp.int32)

        # initial stack: row cells (descending (H,bucket) order), pushed in
        # reverse so pops see the best cell first, filtered H > open+ext
        rb = (row_x & np.int64(0xFFFFFFFF)).astype(jnp.int32)  # bucket per row col
        r_valid0 = row_x >= 0
        rH0 = (row_x >> 32).astype(jnp.int32)
        elig = r_valid0 & (rH0 > np.int32(gap_open + gap_ext)) & gate_f[:, None] & ~bad[:, None]
        # stack slot of row col j = #eligible with col > j
        rev_csum = jnp.flip(jnp.cumsum(jnp.flip(elig.astype(jnp.int32), 1), axis=1), 1)
        slot_of_j = rev_csum - elig.astype(jnp.int32)
        st_perm = jnp.argsort(jnp.where(elig, slot_of_j, BIGI), axis=1, stable=True)
        st_bucket = _pick2(rb, st_perm)
        st_n = jnp.sum(elig, axis=1).astype(jnp.int32)

        def table_rows(tk, ts, tp, tl, bcol):
            """(key, sc, pos, lorc) words at buckets bcol — ONE row gather."""
            rows = jnp.stack([tk, ts, tp, tl.astype(jnp.int64)], axis=-1).reshape(W * NB, 4)
            bw_ = (jnp.arange(W, dtype=jnp.int32) * np.int32(NB))[:, None]
            return jnp.take(rows, bw_ + bcol, axis=0)  # (W, ncol, 4)

        def from_table(bcol):
            g = table_rows(tkey, tsc, tpos, tlorc, bcol)
            k = g[..., 0]
            H, E, F, rl, ql, *_ = _unpack_sc(g[..., 1])
            return dict(
                lo=(k >> 32).astype(dt), hi=(k & np.int64(0xFFFFFFFF)).astype(dt),
                lorc=g[..., 3].astype(dt), H=H, F=F, rlen=rl, qlen=ql,
            )

        stc = from_table(st_bucket)
        zpad = jnp.zeros((W, SCAP - N), jnp.int32)

        def padN(a, fill=0):
            return jnp.concatenate([a, jnp.full((W, SCAP - N), fill, a.dtype)], axis=1)

        stack = dict(
            lo=padN(stc["lo"]), hi=padN(stc["hi"]), lorc=padN(stc["lorc"]),
            H=padN(stc["H"]), F=padN(stc["F"]), rlen=padN(stc["rlen"]), qlen=padN(stc["qlen"]),
        )
        sp = st_n

        fpar = jnp.full((W, FCAP), KEY_EMPTY, jnp.int64)
        nfp = jnp.zeros((W,), jnp.int32)

        def cl_cond(st):
            sp = st["sp"]
            return jnp.any((sp > 0) & ~st["bad"]) & (st["rounds"] < np.int32(1024))

        iota_sc = jax.lax.broadcasted_iota(jnp.int32, (W, SCAP), 1)

        def cl_body(st):
            tkey, tsc, tpos, tlorc = st["tkey"], st["tsc"], st["tpos"], st["tlorc"]
            heap, hlen = st["heap"], st["hlen"]
            stack, sp = st["stack"], st["sp"]
            fpar, nfp, count, bad = st["fpar"], st["nfp"], st["count"], st["bad"]

            # ---- bulk pop-scan: minv only changes on a SUCCESSFUL pop, so
            # every entry above the topmost qualifying one is discarded at
            # once (each discarded pop compared against this same minv —
            # exactly the scalar skip loop, bwa-sw.c:449-460)
            minv = jnp.where(hlen < N, 0, (heap[:, 0] >> 32).astype(jnp.int32))
            live = (iota_sc < sp[:, None]) & ~bad[:, None]
            f_open_all = stack["H"] - np.int32(gap_open) > stack["F"]
            F2_all = jnp.where(f_open_all, stack["H"] - np.int32(gap_open), stack["F"]) - np.int32(gap_ext)
            qual = live & (F2_all > minv[:, None])
            chosen = jnp.max(jnp.where(qual, iota_sc, np.int32(-1)), axis=1)
            pend = chosen >= 0
            sp = jnp.where(bad, sp, jnp.maximum(chosen, 0))
            at = jnp.maximum(chosen, 0)
            z = {f: _pick(stack[f], at) for f in stack}
            pF2 = _pick(F2_all, at)
            pFfrom = jnp.where(_pick(f_open_all.astype(jnp.int32), at) == 1, np.int32(FROM_OPEN), np.int32(FROM_EXT))
            pmin = minv

            # ---- one batched extend over pending windows ----------------
            ikz = jnp.stack(
                [z["lo"].astype(dt), z["lorc"].astype(dt), jnp.where(pend, (z["hi"] - z["lo"]).astype(dt), jnp.zeros((), dt))],
                axis=-1,
            )
            okz = rank_extend(idx, ikz, jnp.ones((W,), bool))  # (W, 6, 3)

            rH = pF2
            zkey = (z["lo"].astype(jnp.int64) << 32) | z["hi"].astype(jnp.int64)
            # the 5 child keys are distinct (disjoint extended intervals), so
            # their 5 puts hit 5 distinct buckets: resolve sequentially on a
            # cheap occupancy overlay, buffer the merged words, then rewrite
            # each table array ONCE (the wide (W,128) i64 read+write per put
            # dominated the first cut of this kernel)
            occ_extra = jnp.zeros((W, NB), bool)
            wbuf = []  # (b, putm, nkey, nsc, npos, nlorc)
            pushes = []  # (slot, putm, field dict)
            for c in range(1, 6):
                csz = okz[:, c, 2]
                putm = pend & (csz > 0)
                lo_c = okz[:, c, 0]
                hi_c = lo_c + csz
                key_c = (lo_c.astype(jnp.int64) << 32) | hi_c.astype(jnp.int64)
                home = _home_bucket(key_c, NB_BITS_)
                d = (iota_nb - home[:, None]) & np.int32(NB - 1)
                elig_b = ((tkey == KEY_EMPTY) & ~occ_extra) | (tkey == key_c[:, None])
                b = jnp.argmin(jnp.where(elig_b, d, BIGI), axis=1).astype(jnp.int32)
                occ_extra = occ_extra | ((iota_nb == b[:, None]) & putm[:, None])
                cur_key = _pick(tkey, b)
                absent = cur_key == KEY_EMPTY
                bad = bad | (putm & (count >= np.int32(MAXC)))
                putm = putm & ~bad
                count = count + (putm & absent)
                cw = _pick(tsc, b)
                tH, tE, tF, trl, tql, tHf, tEf, tFf, tFo = _unpack_sc(cw)
                pw = _pick(tpos, b)
                tHp, tEp, tFoff = _unpack_pos(pw)
                # merge (sw_update_candset): F-candidate fields
                nH = jnp.where(absent, rH, jnp.maximum(tH, rH))
                nHf = jnp.where(absent | (tH < rH), np.int32(FROM_F), tHf)
                nHp = jnp.where(absent, _PNONE, tHp)  # F-cand Hpos=UINT32_MAX
                nE = jnp.where(absent, np.int32(0), tE)
                nEf = jnp.where(absent, np.int32(0), tEf)
                nEp = jnp.where(absent, _PNONE, tEp)
                chF = absent | (tF < rH)  # r.F == r.H for an F candidate
                nF = jnp.where(chF, rH, tF)
                nFf = jnp.where(chF, pFfrom, tFf)
                nrl = jnp.where(absent, z["rlen"] + 1, jnp.maximum(trl, z["rlen"] + 1))
                nql = jnp.where(absent, z["qlen"], jnp.maximum(tql, z["qlen"]))
                nFo = jnp.where(absent, np.int32(0), tFo)
                # F-change bookkeeping (bwa-sw.c:445-483)
                do_f = putm & chF
                bad = bad | (do_f & (nfp >= np.int32(FCAP)))
                do_f = do_f & ~bad
                nFoff = jnp.where(chF, nfp, tFoff)  # node-local fpar index
                fpar = _onehot_set(fpar, nfp, zkey, do_f)
                nfp = nfp + do_f
                # heap insert x = (rH << 32) | UINT32_MAX.  The heap is a
                # sorted-ascending array with -1 empties at the FRONT, so
                # grow == replace-min(-1): shift everything below x's sorted
                # position left by one and splice x in — a handful of selects
                # instead of a (W, N+1) i64 sort (those cost ~0.4 ms each and
                # run 5x per closure round)
                x = (rH.astype(jnp.int64) << 32) | np.int64(0xFFFFFFFF)
                grow = do_f & (hlen < N)
                repl = do_f & (hlen >= N) & (x > heap[:, 0])
                ins = grow | repl
                p = jnp.sum(heap < x[:, None], axis=1).astype(jnp.int32)  # #entries below x
                shifted = jnp.concatenate([heap[:, 1:], heap[:, -1:]], axis=1)
                cand_h = jnp.where(iota_n < p[:, None] - 1, shifted, jnp.where(iota_n == p[:, None] - 1, x[:, None], heap))
                heap = jnp.where(ins[:, None], cand_h, heap)
                hlen = hlen + grow
                # push q.copy() when r.H - gap_ext > pending_min
                push = do_f & (rH - np.int32(gap_ext) > pmin)
                bad = bad | (push & (sp >= np.int32(SCAP)))
                push = push & ~bad
                new_lorc = jnp.where(absent, okz[:, c, 1], _pick(tlorc, b))
                pushes.append((sp, push, dict(
                    lo=lo_c.astype(dt), hi=hi_c.astype(dt), lorc=new_lorc.astype(dt),
                    H=nH, F=nF, rlen=nrl, qlen=nql,
                )))
                sp = sp + push
                nkey = jnp.where(absent, key_c, cur_key)
                nsc = _pack_sc(nH, nE, nF, nrl, nql, nHf, nEf, nFf, nFo)
                npos = _pack_pos(nHp, nEp, nFoff)
                wbuf.append((b, putm, nkey, nsc, npos, new_lorc.astype(dt)))

            # merged writes: one read+write per array for all 5 puts
            def write5(arr, vals_at):
                out = arr
                for b, putm, *vals in wbuf:
                    sel = (iota_nb == b[:, None]) & putm[:, None]
                    out = jnp.where(sel, vals[vals_at][:, None].astype(arr.dtype), out)
                return out

            tkey = write5(tkey, 0)
            tsc = write5(tsc, 1)
            tpos = write5(tpos, 2)
            tlorc = write5(tlorc, 3)
            for f in stack:
                out = stack[f]
                for slot, push, pf in pushes:
                    sel = (iota_sc == slot[:, None]) & push[:, None]
                    out = jnp.where(sel, pf[f][:, None].astype(out.dtype), out)
                stack[f] = out

            return dict(
                tkey=tkey, tsc=tsc, tpos=tpos, tlorc=tlorc, heap=heap, hlen=hlen,
                stack=stack, sp=sp, fpar=fpar, nfp=nfp, count=count, bad=bad,
                rounds=st["rounds"] + 1,
            )

        st0 = dict(
            tkey=tkey, tsc=tsc, tpos=tpos, tlorc=tlorc, heap=heap, hlen=hlen,
            stack=stack, sp=sp, fpar=fpar, nfp=nfp, count=count, bad=bad,
            rounds=jnp.asarray(0, jnp.int32),
        )
        stf = jax.lax.while_loop(cl_cond, cl_body, st0)
        tkey, tsc, tpos, tlorc = stf["tkey"], stf["tsc"], stf["tpos"], stf["tlorc"]
        fpar, nfp = stf["fpar"], stf["nfp"]
        # round-cap leftovers are inexact -> host rerun
        bad = stf["bad"] | (stf["sp"] > 0)

        # ---- rebuild: final top-N by (H<<32|bucket) -------------------------
        row_x = topn(tkey, tsc)
        r_valid = row_x >= 0
        rbuck = (row_x & np.int64(0xFFFFFFFF)).astype(jnp.int32)
        gr = table_rows(tkey, tsc, tpos, tlorc, rbuck)
        rkey, rsc, rpos, rlorc = gr[..., 0], gr[..., 1], gr[..., 2], gr[..., 3].astype(dt)
        rH, rE, rF, rrl, rql, rHf, rEf, rFf, rFo = _unpack_sc(rsc)
        rHp, rEp, rFoff = _unpack_pos(rpos)

        # ---- sw_track_F: fpar index -> row column (bwa-sw.c:301-324) -------
        need = r_valid & (rF > 0) & (rFoff != UNSET)
        fkey = _pick2(fpar, jnp.where(need, jnp.minimum(rFoff, FCAP - 1), 0))
        mt = (rkey[:, None, :] == fkey[:, :, None]) & r_valid[:, None, :]  # (W, cell, col)
        hit = jnp.any(mt, axis=2)
        j2 = jnp.argmax(mt, axis=2).astype(jnp.int32)
        rFoff = jnp.where(need & hit, j2, UNSET)
        rFos = jnp.where(need & hit, np.int32(1), np.int32(0))

        new_row = dict(
            lo=jnp.where(r_valid, ((rkey >> 32) & np.int64(0xFFFFFFFF)).astype(dt), jnp.zeros((), dt)),
            hi=jnp.where(r_valid, (rkey & np.int64(0xFFFFFFFF)).astype(dt), jnp.zeros((), dt)),
            lorc=rlorc, H=jnp.where(r_valid, rH, 0), E=rE, F=rF, rlen=rrl, qlen=rql,
            Hfrom=rHf, Efrom=rEf, Ffrom=rFf, Foffset=rFos,
            Hpos=jnp.where(rHp == _PNONE, np.int32(-1), rHp),
            Epos=jnp.where(rEp == _PNONE, np.int32(-1), rEp),
            Foff=rFoff, valid=r_valid,
        )

        # ---- archive for the anno backtrack --------------------------------
        refc = jnp.zeros((W, N), jnp.int32)
        for c in range(1, 7):
            refc = refc + (jnp.asarray(acc[c], dt) <= new_row["lo"]).astype(jnp.int32)
        word0 = (
            rHf | rEf << 2 | rFf << 3 | rFos << 4 | refc << 5
            | jnp.where(rFos == 1, jnp.minimum(rFoff, np.int32(31)), np.int32(31)) << 8
        )
        word1 = (
            jnp.where(new_row["Hpos"] < 0, _PNONE, new_row["Hpos"])
            | jnp.where(new_row["Epos"] < 0, _PNONE, new_row["Epos"]) << 16
        )
        return (new_row, bad), (word0, word1)

    xs = (jnp.arange(1, K + 1, dtype=jnp.int32), syms)
    (row, bad), (arch0, arch1) = jax.lax.scan(node_body, (row, bad0), xs)
    # arch: (K, W, N) int32 for nodes 1..K

    # ---- final row: containment dedup (sw_cell_dedup, bwa-sw.c:197-216) ----
    lo, hi, lorc, valid = row["lo"], row["hi"], row["lorc"], row["valid"]
    sz = hi - lo
    kept = jnp.zeros((W, N), bool)
    kept = kept.at[:, 0].set(valid[:, 0])
    flt = jnp.zeros((W, N), bool)
    for i in range(1, N):
        cont_rc = (lorc <= lorc[:, i : i + 1]) & (lorc + sz >= lorc[:, i : i + 1] + sz[:, i : i + 1])
        cont_fw = (lo <= lo[:, i : i + 1]) & (hi >= hi[:, i : i + 1])
        c_i = jnp.any(kept & (cont_rc | cont_fw), axis=1) & valid[:, i]
        flt = flt.at[:, i].set(c_i)
        kept = kept.at[:, i].set(valid[:, i] & ~c_i)

    H0 = row["H"][:, 0]
    sel = (
        valid & ~flt & (row["Hfrom"] == np.int32(FROM_H)) & (row["H"] >= np.int32(min_sc))
    )
    # e2e_drop default -1: no drop filter (search.c hapdiv path)
    n_al = jnp.sum(sel, axis=1).astype(jnp.int32)

    # ---- anno backtrack: ed per selected final cell (lock-step walkers) ----
    af0 = arch0.transpose(1, 0, 2).reshape(W, K * N)  # (W, K*N): node i-1 at (i-1)*N+col
    af1 = arch1.transpose(1, 0, 2).reshape(W, K * N)
    symsf = syms.T  # (W, K); node r symbol = symsf[:, r-1]

    # global pos = r*N + col with r in 0..K; archive index for r>=1 is
    # (r-1)*N + col; the walk ends at pos == 0 (the root cell)
    pos = jnp.where(sel, np.int32(K) * N + iota_n, np.int32(0))
    last = jnp.zeros((W, N), jnp.int32)
    ed = jnp.zeros((W, N), jnp.int32)
    alive = sel

    def bt_cond(st):
        return jnp.any(st[0] > 0) & (st[4] < np.int32(4 * K + 64))

    def bt_body(st):
        pos, last, ed, alive, steps = st
        act = alive & (pos > 0)
        r = pos // np.int32(N)
        col = pos % np.int32(N)
        ai = jnp.clip((r - 1) * np.int32(N) + col, 0, K * N - 1)
        W0 = _ftake2(af0, ai)
        W1 = _ftake2(af1, ai)
        x = W0 & np.int32(0xF)
        state = jnp.where(last == 0, x & 3, last)
        ext = jnp.where((state == 1) | (state == 2), (x >> (state + 1)) & 1, 0)
        c = (W0 >> 5) & 7
        node_c = _ftake2(symsf, jnp.clip(r - 1, 0, K - 1))
        is_h = state == np.int32(FROM_H)
        is_e = state == np.int32(FROM_E)
        is_f = state == np.int32(FROM_F)
        d_ed = jnp.where(is_h, (c != node_c).astype(jnp.int32), 1)
        Hp = W1 & np.int32(0xFFFF)
        Ep = (W1 >> 16) & np.int32(0xFFFF)
        Foffr = (W0 >> 8) & np.int32(0x1F)
        npos = jnp.where(is_h, Hp, jnp.where(is_e, Ep, r * np.int32(N) + Foffr))
        pos = jnp.where(act, npos, pos)
        ed = ed + jnp.where(act, d_ed, 0)
        last = jnp.where(act, jnp.where(((state == 1) | (state == 2)) & (ext == 1), state, 0), last)
        return pos, last, ed, alive, steps + 1

    pos, last, ed, alive, _ = jax.lax.while_loop(
        bt_cond, bt_body, (pos, last, ed, alive, jnp.asarray(0, jnp.int32))
    )
    bad = bad | jnp.any(sel & (pos > 0), axis=1)  # walk-cap leftovers

    max_ed = jnp.max(jnp.where(sel, ed, 0), axis=1)
    edc = jnp.minimum(ed, 6)
    weights = (hi - lo).astype(jnp.int64)
    n_hap = jnp.zeros((W, 7), jnp.int64)
    for e in range(7):
        n_hap = n_hap.at[:, e].set(jnp.sum(jnp.where(sel & (edc == e), weights, 0), axis=1))

    return n_al, max_ed, n_hap, bad
