"""Batched SMEM-TG on device — the flagship query kernel.

The Travis-Gagie long-MEM algorithm (fm-index.c:483-528, paper Algorithm 4) is
a per-read state machine over bidirectional-extend steps.  Here every read is
a *lane*: each global iteration performs one vectorized resolve (no memory
traffic) plus one batched extend (two rank gathers) for every active lane, in
lock-step under `lax.while_loop`.  Control flow is data-independent — phases
are integers selected with `where` — so XLA compiles a single fused loop body.
The FSM itself lives in ops/smem_fsm.py and is shared with the sharded
multi-chip path (parallel/).
"""

from __future__ import annotations

import os
from functools import partial

from .. import _jax_setup as __jx
__jx()
import jax
import jax.numpy as jnp
import numpy as np

from .. import require_device
from ..index.dense import DenseFMIndex
from .rank import DeviceIndex, extend, extend_c, set_intv
from .smem_fsm import smem_fsm, smem_fsm_dual
from .smem_ref import Mem


@partial(jax.jit, static_argnames=("min_occ", "min_len", "max_mems", "max_iters", "unroll", "seed_k", "carry_sp"))
def smem_tg_batch(
    idx: DeviceIndex,
    q: jax.Array,  # (Q, L) uint8, 0-padded
    qlen: jax.Array,  # (Q,) int32
    *,
    min_occ: int,
    min_len: int,
    max_mems: int,
    max_iters: int,
    unroll: int = 1,
    seed_tab: jax.Array | None = None,
    seed_k: int = 0,
    segments=None,
    carry_sp: bool = False,
    uniform_segments=None,
):
    """Returns (mems (Q, max_mems, 5|6) idx_dtype, n_mem (Q,) int32, iters)."""
    return smem_fsm(
        lambda ik, back: extend(idx, ik, back),
        lambda c: set_intv(idx, c),
        idx.comp,
        q.astype(jnp.int32),
        qlen,
        idx.idx_dtype,
        min_occ=min_occ,
        min_len=min_len,
        max_mems=max_mems,
        max_iters=max_iters,
        unroll=unroll,
        seed_tab=seed_tab,
        seed_k=seed_k,
        segments=segments,
        extend_one=lambda ik, c, back: extend_c(idx, ik, c, back),
        carry_sp=carry_sp,
        uniform_segments=uniform_segments,
    )


@partial(jax.jit, static_argnames=("min_occ", "min_len", "max_mems", "max_iters", "unroll"))
def smem_tg_batch_dual(
    idx: DeviceIndex,
    qa: jax.Array,
    ua,  # uniform_segments (stride, rlen, n_seg) of population A
    qb: jax.Array,
    ub,
    *,
    min_occ: int,
    min_len: int,
    max_mems: int,
    max_iters: int,
    unroll: int = 1,
):
    """Two uniform-packed populations in ONE while_loop (smem_fsm_dual): the
    per-trip fixed cost amortizes over both and their gathers are
    independent.  Bit-identical per population to smem_tg_batch.
    Returns ((mems_a, n_mem_a), (mems_b, n_mem_b), iters)."""
    Q = qa.shape[0]
    kw = dict(
        min_occ=min_occ, min_len=min_len, max_mems=max_mems,
        max_iters=max_iters, return_parts=True,
    )
    mk = lambda q, u: smem_fsm(
        lambda ik, back: extend(idx, ik, back),
        lambda c: set_intv(idx, c),
        idx.comp,
        q.astype(jnp.int32),
        jnp.zeros(q.shape[0], jnp.int32),
        idx.idx_dtype,
        uniform_segments=u,
        extend_one=lambda ik, c, back: extend_c(idx, ik, c, back),
        **kw,
    )
    return smem_fsm_dual(mk(qa, ua), mk(qb, ub), max_iters, unroll=unroll)


DENSE_BYTES_PER_SYM = 0.75  # fused dense occ rows (ops/rank.py)
DENSE_SHARE = 0.75  # most of the device memory limit the dense rows may take


def auto_occ(n: int, n_idx: int = 1, bytes_limit: int | None = None) -> str:
    """occ="auto": dense rows while they fit in DENSE_SHARE of one device's
    memory limit (per idx shard), else the compressed rb rows.  The limit is
    the device's own (`memory_stats()["bytes_limit"]`); a backend that
    reports none (the CPU backend) keeps dense."""
    if bytes_limit is None:
        stats = jax.devices()[0].memory_stats() or {}
        bytes_limit = stats.get("bytes_limit")
    if not bytes_limit:
        return "dense"
    return "rb" if n * DENSE_BYTES_PER_SYM / max(1, n_idx) > DENSE_SHARE * bytes_limit else "dense"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class BatchedSmemTG:
    """Host-side driver: pads reads into fixed-shape batches, runs the jitted
    kernel, unpacks Mem lists.  Lane count is fixed per length bucket (L is
    bucketed to powers of two) so each bucket compiles exactly once; large
    inputs stream through in chunks."""

    def __init__(
        self,
        f: DenseFMIndex,
        min_occ: int = 1,
        min_len: int = 19,
        max_mems: int | None = None,
        lanes: int = 8192,
        unroll: int | None = None,
        seed_k: int | None = None,
        pack: bool = True,
        mesh=None,
        occ: str = "auto",
    ):
        require_device()
        self.pack = pack
        self.mesh = mesh  # (dp, idx) jax Mesh: occ tables sharded over idx,
        # lanes over dp (parallel/); packed dispatches go through
        # smem_sharded_fn, everything else falls back to the host engine
        if occ == "auto":
            occ = os.environ.get("RB3JAX_DEVICE_OCC", "auto")
        if occ == "auto":
            # the memory limit applies PER idx shard: capacity scales with
            # the mesh axis
            n_idx = mesh.shape["idx"] if mesh is not None else 1
            occ = auto_occ(f.n, n_idx)
        if mesh is not None:
            from ..parallel.mesh import ShardedIndex

            self.sidx = ShardedIndex.from_dense(f, mesh, occ=occ)
            self._sharded_steps: dict = {}
            self.idx = None
        elif occ == "rb":
            # run-aware compressed rows (ops/runblock.py, ~0.04-0.3 B/sym):
            # the beyond-device-memory capacity path
            from .runblock import from_dense as _rb_from_dense

            self.idx = _rb_from_dense(f)
        else:
            # dense fused rows (0.75 B/sym): the speed path
            self.idx = DeviceIndex.from_dense(f)
        self._dense = f  # host-side fallback for per-read overflow reruns
        self.min_occ = int(min_occ)
        self.min_len = int(min_len)
        self.max_mems = max_mems
        self.lanes = lanes
        self.unroll = int(unroll) if unroll is not None else 2
        # k-mer seed table (ops/seed.py): cuts loop trips 10-15% but adds ~35
        # ops per trip; off by default
        self.seed_k = max(0, min(int(seed_k or 0), self.min_len - 1))
        self.seed_tab = None
        if self.seed_k >= 4 and isinstance(self.idx, DeviceIndex):
            from .seed import build_seed_table

            self.seed_tab = build_seed_table(self.idx, self.seed_k)
        else:
            self.seed_k = 0

    def _host_rerun_many(self, qs: list[np.ndarray]) -> list[list[Mem]]:
        """Recompute reads on the host (lane MEM-buffer overflow): one call
        into the threaded native engine when available, else the Python
        reference."""
        try:
            from .smem_native import native_smem_lib, smem_tg_batch_native

            if native_smem_lib() is not None:
                return smem_tg_batch_native(self._dense, qs, self.min_occ, self.min_len)
        except Exception:
            pass
        from . import smem_ref

        return [smem_ref.smem_tg(self._dense, q, self.min_occ, self.min_len) for q in qs]

    def _host_rerun(self, q: np.ndarray) -> list[Mem]:
        return self._host_rerun_many([q])[0]

    def _sharded_step(self, Q, Lbuf, Rcap, M, uniform=False):
        key = (Q, Lbuf, Rcap, M, uniform)
        if key not in self._sharded_steps:
            from ..parallel.smem_sharded import smem_sharded_fn

            self._sharded_steps[key] = smem_sharded_fn(
                self.sidx, min_occ=self.min_occ, min_len=self.min_len,
                max_mems=M, max_iters=Rcap * Lbuf + 64, packed=True, unroll=self.unroll,
                uniform=uniform,
            )
        return self._sharded_steps[key]

    def _run_chunk(self, queries: list[np.ndarray], L: int) -> list[list[Mem]]:
        Q = len(queries)
        # scale lanes down for long reads so q + mems stay within HBM budget;
        # cap the per-lane MEM buffer (overflowing reads rerun on host)
        lanes = max(256, min(self.lanes, self.lanes * 512 // max(512, L)))
        Qp = min(lanes, _round_up(Q, 256))
        out: list[list[Mem]] = []
        M = self.max_mems if self.max_mems else min(256, max(4, L - self.min_len + 1))
        for c0 in range(0, Q, Qp):
            chunk = queries[c0 : c0 + Qp]
            qarr = np.zeros((Qp, L), dtype=np.uint8)
            qlen = np.zeros(Qp, dtype=np.int32)
            for t, qq in enumerate(chunk):
                qarr[t, : len(qq)] = qq
                qlen[t] = len(qq)
            mems, n_mem, _ = smem_tg_batch(
                self.idx,
                jnp.asarray(qarr),
                jnp.asarray(qlen),
                min_occ=self.min_occ,
                min_len=self.min_len,
                max_mems=M,
                max_iters=4 * L + 64,
                unroll=self.unroll,
                seed_tab=self.seed_tab,
                seed_k=self.seed_k,
            )
            mems = np.asarray(mems[: len(chunk)])
            n_mem = np.asarray(n_mem[: len(chunk)])
            for t in range(len(chunk)):
                if n_mem[t] > M:  # buffer overflow: recompute this read on host
                    out.append(self._host_rerun(chunk[t]))
                else:
                    out.append([Mem(int(r[0]), int(r[1]), int(r[2]), int(r[3]), int(r[4])) for r in mems[t, : n_mem[t]]])
        return out

    PACK_LBUF = 4096  # short-read lane buffer (one compile shape): 27x150bp
    # reads per lane average out the per-lane iteration counts
    PACK_LBUF_LONG = 32768  # long-read lane buffer (covers HiFi-length reads)
    PACK_R = 32  # max reads per lane

    def _run_packed(self, queries: list[np.ndarray], results: list, idxs: list[int], Lbuf: int | None = None, M: int | None = None, q_lanes: int | None = None) -> None:
        """Pack several reads per lane: one (Q, R, Lbuf) program covers every
        read length up to Lbuf-1, and per-lane iteration counts average over
        the lane's reads, shrinking the max-over-lanes tail that sets the
        loop trip count.  `idxs` are ascending-length positions into
        `results`."""
        Lbuf = Lbuf or self.PACK_LBUF
        Rcap = self.PACK_R
        Q = int(os.environ.get("RB3JAX_PACK_Q", 0)) or q_lanes or max(256, self.lanes // 4)
        if self.mesh is not None:  # lanes shard evenly over the dp axis
            dp = self.mesh.shape["dp"]
            Q = (Q + dp - 1) // dp * dp
        if M is None:
            M = max(64, self.max_mems) if self.max_mems else 64
        idxs_np = np.asarray(idxs, dtype=np.int64)
        lens = np.fromiter((len(queries[i]) for i in idxs), np.int64, len(idxs))

        def stage(t):
            """Build one dispatch: deal ascending-length reads round-robin
            across lanes (loads stay near-equal); rounds stop at capacity
            (>= 1 zero separator each).  All staging is vectorized; buffer
            fills group reads of equal length (contiguous, since idxs are
            length-sorted).  Returns (next_t, descriptor)."""
            navail = len(idxs) - t
            rmax = min(Rcap, (navail + Q - 1) // Q)
            take0 = min(navail, rmax * Q)
            occ = np.zeros((rmax, Q), np.int64)
            occ.ravel()[:take0] = lens[t : t + take0] + 1
            loads = np.cumsum(occ, axis=0)
            ok = loads.max(axis=1) <= Lbuf
            r_acc = int(np.argmin(ok)) if not ok.all() else rmax
            assert r_acc > 0, "read longer than the packed lane buffer"
            take = min(navail, r_acc * Q)
            flat = np.arange(take, dtype=np.int64)
            lane_a, rnd_a = flat % Q, flat // Q
            offs = np.zeros((r_acc, Q), np.int64)
            offs[1:] = loads[: r_acc - 1]
            off_a = offs[rnd_a, lane_a]
            len_a = lens[t : t + take]
            rid_a = idxs_np[t : t + take]
            qarr = np.zeros((Q, Lbuf), np.uint8)
            b0 = 0
            while b0 < take:  # contiguous run of equal-length reads
                b1 = b0 + int(np.searchsorted(len_a[b0:], len_a[b0] + 1))
                ln = int(len_a[b0])
                if ln > 0:
                    block = np.stack([queries[r] for r in rid_a[b0:b1]])
                    qarr[lane_a[b0:b1, None], off_a[b0:b1, None] + np.arange(ln)] = block
                b0 = b1
            seg_off = np.zeros((Q, Rcap), np.int32)
            seg_len = np.zeros((Q, Rcap), np.int32)
            n_seg = np.zeros(Q, np.int32)
            seg_off[lane_a, rnd_a] = off_a
            seg_len[lane_a, rnd_a] = len_a
            np.maximum.at(n_seg, lane_a, (rnd_a + 1).astype(np.int32))
            # equal-length takes (the dominant short-read case) qualify for
            # the uniform-stride kernel: off = seg*(len+1) matches the cumsum
            # offsets exactly, so the trace is bit-identical to the general
            # packed kernel while dropping its per-iteration seg-record gather
            ulen = int(len_a[0]) if take and len_a.min() == len_a.max() and not os.environ.get("RB3JAX_NO_UNIFORM") else -1
            return t + take, dict(qarr=qarr, seg_off=seg_off, seg_len=seg_len, n_seg=n_seg, lane_a=lane_a, rnd_a=rnd_a, rid_a=rid_a, ulen=ulen)

        def dispatch(d):
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                uni = d["ulen"] >= 0 and self.seed_k == 0
                step = self._sharded_step(Q, Lbuf, Rcap, M, uniform=uni)
                sh2 = NamedSharding(self.mesh, P("dp", None))
                sh1 = NamedSharding(self.mesh, P("dp"))
                if uni:
                    stride = np.full(Q, d["ulen"] + 1, np.int32)
                    rlen = np.where(d["n_seg"] > 0, np.int32(d["ulen"]), np.int32(0))
                    a, b = jax.device_put(stride, sh1), jax.device_put(rlen, sh1)
                else:
                    a, b = jax.device_put(d["seg_off"], sh2), jax.device_put(d["seg_len"], sh2)
                mems, n_mem, _ = step(
                    jax.device_put(d["qarr"], sh2),
                    a,
                    b,
                    jax.device_put(d["n_seg"], sh1),
                )
            else:
                seg_args: dict = dict(segments=(jnp.asarray(d["seg_off"]), jnp.asarray(d["seg_len"]), jnp.asarray(d["n_seg"])))
                if d["ulen"] >= 0 and self.seed_k == 0:
                    stride = np.full(Q, d["ulen"] + 1, np.int32)
                    rlen = np.where(d["n_seg"] > 0, np.int32(d["ulen"]), np.int32(0))
                    seg_args = dict(uniform_segments=(jnp.asarray(stride), jnp.asarray(rlen), jnp.asarray(d["n_seg"])))
                mems, n_mem, _ = smem_tg_batch(
                    self.idx,
                    jnp.asarray(d["qarr"]),
                    jnp.zeros(Q, jnp.int32),
                    min_occ=self.min_occ,
                    min_len=self.min_len,
                    max_mems=M,
                    max_iters=Rcap * Lbuf + 64,
                    unroll=self.unroll,
                    seed_tab=self.seed_tab,
                    seed_k=self.seed_k,
                    **seg_args,
                )
            d["mems_dev"], d["n_mem_dev"] = mems, n_mem
            return d

        def sync_and_prefetch(d):
            # materialize n_mem (small) so one program is in flight at a
            # time, then start the bulk MEM buffer's device->host copy so it
            # overlaps the next dispatch
            from ..parallel.launch import to_host

            d["n_mem"] = to_host(d["n_mem_dev"])
            try:
                d["mems_dev"].copy_to_host_async()
            except Exception:
                pass

        def unpack(d):
            """Vectorized unpack: gather all valid rows at once, map (lane,
            seg) -> global read id, stable-sort by read id (preserving
            per-read emit order: lane-major then slot-ascending)."""
            from ..parallel.launch import to_host

            mems = to_host(d["mems_dev"])
            n_mem = d["n_mem"]
            lane_a, rnd_a, rid_a = d["lane_a"], d["rnd_a"], d["rid_a"]
            rid_of = np.full((Q, Rcap), -1, np.int64)
            rid_of[lane_a, rnd_a] = rid_a
            for ridx in rid_a:
                results[ridx] = []
            ok_lane = n_mem <= M
            nvalid = np.where(ok_lane, n_mem, 0)
            lanes_i, slots = np.nonzero(np.arange(M)[None, :] < nvalid[:, None])
            rows = mems[lanes_i, slots]
            rids = rid_of[lanes_i, rows[:, 5].astype(np.int64)]
            order = np.argsort(rids, kind="stable")
            row_l = rows[order, :5].tolist()
            rid_l = rids[order].tolist()
            for rid, r0 in zip(rid_l, row_l):
                results[rid].append(Mem(*r0))
            if not ok_lane.all():  # lane MEM-buffer overflow: batched host rerun
                bad = set(np.nonzero(~ok_lane)[0].tolist())
                rids = [int(rid_a[k]) for k, lane in enumerate(lane_a) if int(lane) in bad]
                for ridx, o in zip(rids, self._host_rerun_many([queries[r] for r in rids])):
                    results[ridx] = o

        # software pipeline: stage i+1 and unpack i-1 while kernel i runs
        # (exactly one program in flight at a time)
        t, cur = stage(0)
        cur = dispatch(cur)
        prev = None
        while True:
            nxt = None
            if t < len(idxs):
                t, nxt = stage(t)
            if prev is not None:
                unpack(prev)
            sync_and_prefetch(cur)
            prev = cur
            if nxt is None:
                break
            cur = dispatch(nxt)
        unpack(prev)

    def run(self, queries: list[np.ndarray]) -> list[list[Mem]]:
        if not queries:
            return []
        # bucket by padded length; keep original order on output
        order = sorted(range(len(queries)), key=lambda t: len(queries[t]))
        results: list[list[Mem] | None] = [None] * len(queries)
        if self.pack:
            short = [t for t in order if len(queries[t]) + 1 <= self.PACK_LBUF]
            longr = [t for t in order if self.PACK_LBUF < len(queries[t]) + 1 <= self.PACK_LBUF_LONG]
            order = [t for t in order if len(queries[t]) + 1 > self.PACK_LBUF_LONG]
            if short:
                self._run_packed(queries, results, short)
            if longr:
                # long reads carry many MEMs per lane: larger buffer, M=96
                # (the one-hot emit select scales with M x Q) and Q=256 lanes;
                # overflowing reads rerun on the native host engine in one
                # batch
                lr_m = max(96, self.max_mems) if self.max_mems else 96
                self._run_packed(queries, results, longr, Lbuf=self.PACK_LBUF_LONG, M=lr_m, q_lanes=256)
        buckets: dict[int, list[int]] = {}
        for t in order:
            L = max(64, 1 << (max(1, len(queries[t]) - 1)).bit_length())
            buckets.setdefault(L, []).append(t)
        for L, idxs in buckets.items():
            if self.mesh is not None:  # no unpacked sharded variant: host engine
                outs = self._host_rerun_many([queries[t] for t in idxs])
            else:
                outs = self._run_chunk([queries[t] for t in idxs], L)
            for t, o in zip(idxs, outs):
                results[t] = o
        return results  # type: ignore[return-value]
