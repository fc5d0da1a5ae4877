"""Batched JAX SMEM engine and sharded/multi-device paths vs the sequential
reference implementation."""

import numpy as np
import pytest

from ropebwt3_jax.formats import fmd
from ropebwt3_jax.index.dense import DenseFMIndex
from ropebwt3_jax.nt6 import char2nt6
from ropebwt3_jax.ops import smem_ref
from ropebwt3_jax.seqio import read_seqs


@pytest.fixture(scope="module")
def dense_index(ref_index):
    _, syms, lens = fmd.decode_runs(open(ref_index, "rb").read())
    return DenseFMIndex.from_runs(syms, lens)


@pytest.fixture(scope="module")
def reads(corpus):
    return [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]


def test_batched_smem_matches_ref(dense_index, reads):
    from ropebwt3_jax.ops.smem import BatchedSmemTG

    eng = BatchedSmemTG(dense_index, min_occ=1, min_len=21)
    got = eng.run(reads)
    for q, g in zip(reads, got):
        assert g == smem_ref.smem_tg(dense_index, q, 1, 21)


def test_batched_smem_mixed_lengths(dense_index, reads):
    from ropebwt3_jax.ops.smem import BatchedSmemTG

    mixed = [r[: 40 + 13 * (i % 9)] for i, r in enumerate(reads)]
    eng = BatchedSmemTG(dense_index, min_occ=1, min_len=17)
    got = eng.run(mixed)
    for q, g in zip(mixed, got):
        assert g == smem_ref.smem_tg(dense_index, q, 1, 17)


def test_batched_smem_long_reads(dense_index):
    """HiFi-length reads: lane scaling + capped MEM buffers + overflow rerun."""
    import numpy as np

    from ropebwt3_jax.ops.smem import BatchedSmemTG

    g, _ = dense_index.retrieve(0)
    rng = np.random.default_rng(9)
    reads = []
    for _ in range(6):
        ln = int(rng.integers(3000, 6000))
        st = int(rng.integers(0, len(g) - ln))
        r = g[st : st + ln].copy()
        mut = rng.random(ln) < 0.05
        r[mut] = rng.integers(1, 5, int(mut.sum()))
        reads.append(r)
    eng = BatchedSmemTG(dense_index, min_occ=1, min_len=25, max_mems=8)  # force overflows
    got = eng.run(reads)
    for q, gm in zip(reads, got):
        assert gm == smem_ref.smem_tg(dense_index, q, 1, 25)


def test_jax_rank_matches_numpy(dense_index):
    import jax.numpy as jnp

    from ropebwt3_jax.ops.rank import DeviceIndex, rank1a

    idx = DeviceIndex.from_dense(dense_index)
    rng = np.random.default_rng(0)
    ks = rng.integers(0, dense_index.n + 1, 500)
    got = np.asarray(rank1a(idx, jnp.asarray(ks, jnp.int32)))
    assert np.array_equal(got, dense_index.rank1a(ks))


def test_sharded_smem(dense_index, reads):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ropebwt3_jax.parallel.mesh import ShardedIndex, make_mesh
    from ropebwt3_jax.parallel.smem_sharded import smem_sharded_fn

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(2, 4)
    sidx = ShardedIndex.from_dense(dense_index, mesh)
    Q, L = 16, 256
    qarr = np.zeros((Q, L), np.uint8)
    qlen = np.zeros(Q, np.int32)
    for t in range(Q):
        r = reads[t]
        qarr[t, : len(r)] = r
        qlen[t] = len(r)
    step = smem_sharded_fn(sidx, min_occ=1, min_len=21, max_mems=64, max_iters=4 * L + 64)
    qd = jax.device_put(qarr, NamedSharding(mesh, P("dp", None)))
    qld = jax.device_put(qlen, NamedSharding(mesh, P("dp")))
    mems, n_mem, _ = step(qd, qld)
    mems, n_mem = np.asarray(mems), np.asarray(n_mem)
    for t in range(Q):
        want = smem_ref.smem_tg(dense_index, reads[t], 1, 21)
        got = [tuple(int(v) for v in row) for row in mems[t, : n_mem[t]]]
        assert got == [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in want]


def test_packed_lanes_match_ref(dense_index, reads):
    """Multi-read lane packing (with per-lane MEM-buffer overflow reruns and
    sub-min_len reads) must match the sequential reference exactly."""
    import numpy as np

    from ropebwt3_jax.ops.smem import BatchedSmemTG

    g, _ = dense_index.retrieve(2)
    rng = np.random.default_rng(31)
    mixed = []
    for i in range(60):
        ln = int(rng.integers(5, 900))  # includes sub-min_len reads
        st = int(rng.integers(0, max(1, len(g) - ln)))
        r = g[st : st + ln].copy()
        mut = rng.random(ln) < 0.03
        r[mut] = rng.integers(1, 6, int(mut.sum()))
        mixed.append(r)
    mixed += [r[:97] for r in reads[:40]]
    # reads straddling the short/long packed-class boundary (Lbuf=2048)
    for ln in (2046, 2047, 2048, 2049, 2100):
        st = int(rng.integers(0, len(g) - ln))
        mixed.append(g[st : st + ln].copy())
    eng = BatchedSmemTG(dense_index, min_occ=1, min_len=13, lanes=256)  # tiny lanes, heavy packing + overflows
    got = eng.run(mixed)
    for q, gm in zip(mixed, got):
        assert gm == smem_ref.smem_tg(dense_index, q, 1, 13)


@pytest.mark.slow  # compile-heavy A/B of an off-by-default feature
def test_seed_table_and_unroll_match_base(dense_index, reads):
    """The k-mer seed-table jump and loop unrolling are pure iteration savers:
    MEM output must be bit-identical to the plain FSM for every (k, unroll)."""
    import jax.numpy as jnp
    import numpy as np

    from ropebwt3_jax.ops.rank import DeviceIndex
    from ropebwt3_jax.ops.seed import build_seed_table
    from ropebwt3_jax.ops.smem import smem_tg_batch

    idx = DeviceIndex.from_dense(dense_index)
    Q, L = 128, 256
    qarr = np.zeros((Q, L), np.uint8)
    qlen = np.zeros(Q, np.int32)
    for t in range(Q):
        r = reads[t % len(reads)]
        qarr[t, : len(r)] = r
        qlen[t] = len(r)
    for min_occ, min_len in ((1, 21), (3, 13)):
        args = dict(min_occ=min_occ, min_len=min_len, max_mems=16, max_iters=4 * L + 64)
        m1, n1, _ = smem_tg_batch(idx, jnp.asarray(qarr), jnp.asarray(qlen), **args)
        for k in (5, min(12, min_len - 1)):
            tab = build_seed_table(idx, k)
            for unroll in (1, 4):
                m2, n2, _ = smem_tg_batch(idx, jnp.asarray(qarr), jnp.asarray(qlen), seed_tab=tab, seed_k=k, unroll=unroll, **args)
                assert np.array_equal(np.asarray(n1), np.asarray(n2)), (min_len, k, unroll)
                assert np.array_equal(np.asarray(m1), np.asarray(m2)), (min_len, k, unroll)


def test_sharded_int64_megablock(dense_index, reads, monkeypatch):
    """Sharded int64 indexes use the fused rows + replicated megablock bases;
    shrink the megablock so the toy index spans several, run the sharded SMEM
    step, and compare with the sequential reference."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ropebwt3_jax.ops import rank as rank_mod
    from ropebwt3_jax.parallel.mesh import ShardedIndex, make_mesh
    from ropebwt3_jax.parallel.smem_sharded import smem_sharded_fn

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    monkeypatch.setattr(rank_mod, "MEGA_BLOCK_SHIFT", 6)
    mesh = make_mesh(2, 4)
    sidx = ShardedIndex.from_dense(dense_index, mesh, idx_dtype=jnp.int64)
    assert sidx.occ_super is not None and sidx.occ_super.shape[0] > 1
    Q, L = 16, 256
    qarr = np.zeros((Q, L), np.uint8)
    qlen = np.zeros(Q, np.int32)
    for t in range(Q):
        r = reads[t]
        qarr[t, : len(r)] = r
        qlen[t] = len(r)
    step = smem_sharded_fn(sidx, min_occ=1, min_len=21, max_mems=64, max_iters=4 * L + 64)
    qd = jax.device_put(qarr, NamedSharding(mesh, P("dp", None)))
    qld = jax.device_put(qlen, NamedSharding(mesh, P("dp")))
    mems, n_mem, _ = step(qd, qld)
    mems, n_mem = np.asarray(mems), np.asarray(n_mem)
    for t in range(Q):
        want = smem_ref.smem_tg(dense_index, reads[t], 1, 21)
        got = [tuple(int(v) for v in row) for row in mems[t, : n_mem[t]]]
        assert got == [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in want]


def test_int64_megablock_layout(dense_index, reads, monkeypatch):
    """int64 indexes use fused (nb, 12) rows with uint32 counts relative to
    2^32-symbol megablocks (one-hot base rows, no second gather).  Shrink the
    megablock so a toy index spans several, then check rank and SMEM equality
    against the numpy golden path / int32 device path."""
    import jax.numpy as jnp
    import numpy as np

    from ropebwt3_jax.ops import rank as rank_mod
    from ropebwt3_jax.ops.smem import smem_tg_batch

    monkeypatch.setattr(rank_mod, "MEGA_BLOCK_SHIFT", 6)  # 4096-symbol megablocks
    i64 = rank_mod.DeviceIndex.from_dense(dense_index, idx_dtype=jnp.int64)
    assert i64.occf is not None and i64.occ_super.shape[0] > 1
    rng = np.random.default_rng(5)
    ks = rng.integers(0, dense_index.n + 1, 300)
    got = np.asarray(rank_mod.rank1a(i64, jnp.asarray(ks)))
    assert np.array_equal(got, dense_index.rank1a(ks))
    i32 = rank_mod.DeviceIndex.from_dense(dense_index)
    Q, L = 32, 128
    qarr = np.zeros((Q, L), np.uint8)
    qlen = np.zeros(Q, np.int32)
    for t in range(Q):
        r = reads[t % len(reads)][:L]
        qarr[t, : len(r)] = r
        qlen[t] = len(r)
    args = dict(min_occ=1, min_len=17, max_mems=16, max_iters=4 * L + 64)
    m32, n32, _ = smem_tg_batch(i32, jnp.asarray(qarr), jnp.asarray(qlen), **args)
    m64, n64, _ = smem_tg_batch(i64, jnp.asarray(qarr), jnp.asarray(qlen), **args)
    assert np.array_equal(np.asarray(n32), np.asarray(n64))
    assert np.array_equal(np.asarray(m32).astype(np.int64), np.asarray(m64))


def test_carry_sp_matches_base(dense_index, reads):
    """carry_sp=True (seg record carried in loop state, refresh folded into
    the symbol take — a measured perf loss kept as a documented variant,
    scripts/sp_ab.py) must be bit-identical to the default packed body."""
    import jax.numpy as jnp
    import numpy as np

    from ropebwt3_jax.ops.rank import DeviceIndex
    from ropebwt3_jax.ops.smem import smem_tg_batch

    idx = DeviceIndex.from_dense(dense_index)
    Q, R, LBUF = 32, 8, 512
    qarr = np.zeros((Q, LBUF), np.uint8)
    seg_off = np.zeros((Q, R), np.int32)
    seg_len = np.zeros((Q, R), np.int32)
    n_seg = np.zeros(Q, np.int32)
    rng = np.random.default_rng(7)
    for lane in range(Q):
        pos = 0
        for s in range(int(rng.integers(1, R + 1))):
            r = reads[int(rng.integers(0, len(reads)))][: int(rng.integers(8, 100))]
            if pos + len(r) + 1 > LBUF:
                break
            qarr[lane, pos : pos + len(r)] = r
            seg_off[lane, s], seg_len[lane, s] = pos, len(r)
            n_seg[lane] = s + 1
            pos += len(r) + 1
    args = dict(min_occ=1, min_len=13, max_mems=32, max_iters=8 * LBUF)
    segs = (jnp.asarray(seg_off), jnp.asarray(seg_len), jnp.asarray(n_seg))
    outs = []
    for carry in (False, True):
        for unroll in (1, 2):
            m, n, _ = smem_tg_batch(idx, jnp.asarray(qarr), jnp.zeros(Q, jnp.int32), segments=segs, unroll=unroll, carry_sp=carry, **args)
            outs.append((np.asarray(m), np.asarray(n)))
    for m, n in outs[1:]:
        assert np.array_equal(n, outs[0][1])
        assert np.array_equal(m, outs[0][0])


def test_prefix_occ_matches_default(dense_index, reads, monkeypatch):
    """The prefix-occ layout (occf width 18, stored complement-order prefix
    columns; _extend_c_prefix's eq/lt circuits) must be bit-identical to the
    default 12-col layout — extend_c on random intervals, rank1a, and the
    full packed SMEM kernel, in int32 and (shrunken-megablock) int64 modes."""
    import jax.numpy as jnp
    import numpy as np

    from ropebwt3_jax.ops import rank as rank_mod
    from ropebwt3_jax.ops.smem import smem_tg_batch

    monkeypatch.setattr(rank_mod, "MEGA_BLOCK_SHIFT", 6)
    base32 = rank_mod.DeviceIndex.from_dense(dense_index, prefix=False)
    rng = np.random.default_rng(3)
    for dt in (jnp.int32, jnp.int64):
        pidx = rank_mod.DeviceIndex.from_dense(dense_index, idx_dtype=dt, prefix=True)
        assert pidx.has_prefix
        ks = rng.integers(0, dense_index.n + 1, 200)
        assert np.array_equal(np.asarray(rank_mod.rank1a(pidx, jnp.asarray(ks))), dense_index.rank1a(ks))
        # random valid intervals: set_intv of random symbols then extend
        cs = rng.integers(0, 6, 128).astype(np.int32)
        ik0 = rank_mod.set_intv(pidx, jnp.asarray(cs))
        c2 = jnp.asarray(rng.integers(0, 6, 128).astype(np.int32))
        back = jnp.asarray(rng.integers(0, 2, 128).astype(bool))
        a = rank_mod.extend_c(base32, ik0.astype(jnp.int32), c2, back)
        b = rank_mod.extend_c(pidx, ik0, c2, back)
        assert np.array_equal(np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64))
        Q, L = 16, 128
        qarr = np.zeros((Q, L), np.uint8)
        qlen = np.zeros(Q, np.int32)
        for t in range(Q):
            r = reads[t % len(reads)][:L]
            qarr[t, : len(r)] = r
            qlen[t] = len(r)
        args = dict(min_occ=1, min_len=17, max_mems=16, max_iters=4 * L + 64)
        ma, na, _ = smem_tg_batch(base32, jnp.asarray(qarr), jnp.asarray(qlen), **args)
        mb, nb_, _ = smem_tg_batch(pidx, jnp.asarray(qarr), jnp.asarray(qlen), **args)
        assert np.array_equal(np.asarray(na), np.asarray(nb_))
        assert np.array_equal(np.asarray(ma).astype(np.int64), np.asarray(mb).astype(np.int64))


def test_uniform_segments_match_general(dense_index, reads):
    """uniform_segments (per-lane equal-length packing, seg gather replaced by
    off = seg*stride arithmetic) must be bit-identical to the general packed
    kernel on the same layout — including empty lanes and partial last
    rounds."""
    import jax.numpy as jnp
    import numpy as np

    from ropebwt3_jax.ops.rank import DeviceIndex
    from ropebwt3_jax.ops.smem import smem_tg_batch

    idx = DeviceIndex.from_dense(dense_index)
    Q, R, LBUF, RL = 16, 6, 512, 73
    qarr = np.zeros((Q, LBUF), np.uint8)
    seg_off = np.zeros((Q, R), np.int32)
    seg_len = np.zeros((Q, R), np.int32)
    n_seg = np.zeros(Q, np.int32)
    rng = np.random.default_rng(11)
    for lane in range(Q - 2):  # last two lanes stay empty
        ns = int(rng.integers(1, R + 1))
        for s in range(ns):
            r = reads[int(rng.integers(0, len(reads)))][:RL]
            qarr[lane, s * (RL + 1) : s * (RL + 1) + RL] = r
            seg_off[lane, s], seg_len[lane, s] = s * (RL + 1), RL
        n_seg[lane] = ns
    args = dict(min_occ=1, min_len=13, max_mems=32, max_iters=8 * LBUF)
    stride = np.full(Q, RL + 1, np.int32)
    rlen = np.where(n_seg > 0, np.int32(RL), np.int32(0))
    outs = []
    for unroll in (1, 2):
        mg, ng, _ = smem_tg_batch(idx, jnp.asarray(qarr), jnp.zeros(Q, jnp.int32), unroll=unroll,
                                  segments=(jnp.asarray(seg_off), jnp.asarray(seg_len), jnp.asarray(n_seg)), **args)
        mu, nu, _ = smem_tg_batch(idx, jnp.asarray(qarr), jnp.zeros(Q, jnp.int32), unroll=unroll,
                                  uniform_segments=(jnp.asarray(stride), jnp.asarray(rlen), jnp.asarray(n_seg)), **args)
        outs.append((np.asarray(mg), np.asarray(ng), np.asarray(mu), np.asarray(nu)))
    for mg, ng, mu, nu in outs:
        assert np.array_equal(ng, nu)
        assert np.array_equal(mg, mu)


def test_extend_c_matches_extend_row(dense_index):
    """ops/rank.extend_c must equal row c of ops/rank.extend for every
    (interval, symbol, direction) — the SMEM loop's bit-exactness rests on
    this."""
    import jax.numpy as jnp
    import numpy as np

    from ropebwt3_jax.ops.rank import DeviceIndex, extend, extend_c, extend_c_circuit, set_intv

    idx = DeviceIndex.from_dense(dense_index)
    rng = np.random.default_rng(11)
    ik = np.asarray(set_intv(idx, jnp.asarray(rng.integers(0, 6, 64, dtype=np.int32))))
    for _ in range(4):  # walk a few random extension steps
        back = jnp.asarray(rng.random(64) < 0.5)
        c = jnp.asarray(rng.integers(0, 6, 64, dtype=np.int32))
        full = np.asarray(extend(idx, jnp.asarray(ik), back))
        one = np.asarray(extend_c(idx, jnp.asarray(ik), c, back))
        circ = np.asarray(extend_c_circuit(idx, jnp.asarray(ik), c, back))
        want = full[np.arange(64), np.asarray(c)]
        assert np.array_equal(one, want)
        assert np.array_equal(circ, want)
        ik = np.where(want[:, 2:3] > 0, want, ik)  # follow non-empty results


def test_int64_index_dtype_matches_int32(dense_index, reads):
    """Indexes >= 2^31 symbols use int64 device tables; force that dtype on a
    small index and require identical MEMs through the packed kernel."""
    import jax.numpy as jnp
    import numpy as np

    from ropebwt3_jax.ops.rank import DeviceIndex
    from ropebwt3_jax.ops.smem import smem_tg_batch

    i32 = DeviceIndex.from_dense(dense_index)
    i64 = DeviceIndex.from_dense(dense_index, idx_dtype=jnp.int64)
    assert i64.idx_dtype == jnp.int64
    Q, L = 64, 256
    qarr = np.zeros((Q, L), np.uint8)
    qlen = np.zeros(Q, np.int32)
    for t in range(Q):
        r = reads[t % len(reads)]
        qarr[t, : len(r)] = r
        qlen[t] = len(r)
    seg = (jnp.zeros((Q, 2), jnp.int32), jnp.stack([jnp.asarray(qlen), jnp.zeros(Q, jnp.int32)], 1), jnp.ones(Q, jnp.int32))
    args = dict(min_occ=1, min_len=21, max_mems=16, max_iters=4 * L + 64)
    for segments in (None, seg):
        a = smem_tg_batch(i32, jnp.asarray(qarr), jnp.asarray(qlen), segments=segments, **args)
        b = smem_tg_batch(i64, jnp.asarray(qarr), jnp.asarray(qlen), segments=segments, **args)
        assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))
        assert np.array_equal(np.asarray(a[0]).astype(np.int64), np.asarray(b[0]))


def test_merge_rank_device_matches_host():
    import numpy as np

    from ropebwt3_jax.construct.merge import merge_rank_device, merge_rank_plain
    from ropebwt3_jax.construct.sa import gsa_bwt
    from ropebwt3_jax.index.dense import DenseFMIndex

    rng = np.random.default_rng(4)

    def mkbatch(n_seq, lo, hi):
        parts = []
        for _ in range(n_seq):
            L = int(rng.integers(lo, hi))
            parts += [rng.integers(1, 6, L).astype(np.uint8), np.zeros(1, np.uint8)]
        return np.concatenate(parts)

    fa = DenseFMIndex.from_bwt(gsa_bwt(mkbatch(50, 20, 400), backend="numpy"))
    bwt2 = gsa_bwt(mkbatch(60, 10, 300), backend="numpy")
    a1, i1 = merge_rank_plain(fa, bwt2)
    a2, i2 = merge_rank_device(fa, bwt2)
    assert np.array_equal(a1, a2) and np.array_equal(i1, i2)
    # small window forces the multi-window resume path
    a3, i3 = merge_rank_device(fa, bwt2, window=64)
    assert np.array_equal(a1, a3) and np.array_equal(i1, i3)


def test_jax_sa_builder(corpus):
    from ropebwt3_jax.construct.sa import _initial_ranks, suffix_array_doubling
    from ropebwt3_jax.construct.sa_jax import gsa_bwt_jax

    rng = np.random.default_rng(3)
    parts = []
    for _ in range(20):
        L = int(rng.integers(5, 800))
        parts += [rng.integers(1, 6, L).astype(np.uint8), np.zeros(1, np.uint8)]
    seq = np.concatenate(parts)
    keys = _initial_ranks(seq)
    sa = suffix_array_doubling(keys)
    want = seq[np.where(sa == 0, len(seq) - 1, sa - 1)]
    assert np.array_equal(gsa_bwt_jax(seq), want)


def test_graft_entry():
    import subprocess
    import sys
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(root, "__graft_entry__.py"), "8"], capture_output=True, env=dict(os.environ))
    assert r.returncode == 0, r.stderr.decode()
    assert b"dryrun_multichip OK" in r.stdout


def test_native_sais_matches_doubling():
    """native/sais.cpp (SA-IS) must produce the exact multi-string BWT of the
    prefix-doubling spec (construct/sa.py) — same gsa semantics as the
    reference's libsais path (sais-ss.c:50-56) — on edge cases and random
    multi-string corpora, including highly repetitive input that exercises
    the recursion."""
    import pytest

    from ropebwt3_jax.construct.sa import _initial_ranks, suffix_array_doubling
    from ropebwt3_jax.native import get_sais_lib

    lib = get_sais_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")

    def numpy_bwt(seq):
        sa = suffix_array_doubling(_initial_ranks(seq))
        return seq[np.where(sa == 0, len(seq) - 1, sa - 1)]

    def native_bwt(seq):
        seq = np.ascontiguousarray(seq, np.uint8)
        out = np.empty(len(seq), np.uint8)
        assert lib.rb3t_gsa_bwt(seq.ctypes.data, len(seq), out.ctypes.data) == 0
        return out

    rng = np.random.default_rng(0)
    rep = np.tile(np.array([1, 2, 1, 2, 2, 1], np.uint8), 300)
    cases = [
        np.array([0], np.uint8),
        np.array([1, 0], np.uint8),
        np.array([0, 0, 0], np.uint8),
        np.array([1, 1, 1, 1, 0], np.uint8),
        np.array([1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5, 0], np.uint8),
        np.concatenate([rep, [0], rep, [0]]).astype(np.uint8),
    ]
    for _ in range(30):
        parts = []
        for _ in range(int(rng.integers(1, 8))):
            L = int(rng.integers(1, 80))
            parts += [rng.integers(1, 6, L).astype(np.uint8), np.zeros(1, np.uint8)]
        cases.append(np.concatenate(parts))
    for i, s in enumerate(cases):
        assert np.array_equal(numpy_bwt(s), native_bwt(s)), i


def test_merge_rank_native_matches_host():
    """rb3t_merge_rank (interleaved prefetching LF-walk SMs) must equal the
    numpy spec exactly, across lane counts that under- and over-fill the
    per-thread state-machine groups."""
    import pytest

    from ropebwt3_jax.construct.merge import merge_rank_native, merge_rank_plain
    from ropebwt3_jax.construct.sa import gsa_bwt
    from ropebwt3_jax.index.dense import DenseFMIndex
    from ropebwt3_jax.native import get_sw_lib

    if get_sw_lib() is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(21)

    def mkbatch(n_seq, lo, hi):
        parts = []
        for _ in range(n_seq):
            L = int(rng.integers(lo, hi))
            parts += [rng.integers(1, 6, L).astype(np.uint8), np.zeros(1, np.uint8)]
        return np.concatenate(parts)

    fa = DenseFMIndex.from_bwt(gsa_bwt(mkbatch(40, 20, 400)))
    for n_seq in (1, 3, 17, 200):
        b2 = gsa_bwt(mkbatch(n_seq, 1, 300))
        a1, i1 = merge_rank_plain(fa, b2)
        a2, i2 = merge_rank_native(fa, b2)
        assert np.array_equal(a1, a2) and np.array_equal(i1, i2), n_seq


def test_ssa_gen_native_matches_host():
    """rb3t_ssa_gen (interleaved LF-walk SMs) must equal the numpy batched
    ssa_gen exactly — r2i and ssa arrays — across sampling shifts and lane
    counts around the per-thread group size."""
    import pytest

    from ropebwt3_jax.construct.sa import gsa_bwt
    from ropebwt3_jax.index.dense import DenseFMIndex
    from ropebwt3_jax.native import get_sw_lib
    from ropebwt3_jax.ssa_ops import ssa_gen, ssa_gen_native

    if get_sw_lib() is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(33)
    for n_seq in (1, 5, 40):
        parts = []
        for _ in range(n_seq):
            L = int(rng.integers(1, 700))
            s = rng.integers(1, 6, L).astype(np.uint8)
            rc = np.where((s >= 1) & (s <= 4), 5 - s, s)[::-1].astype(np.uint8)
            parts += [s, np.zeros(1, np.uint8), rc, np.zeros(1, np.uint8)]
        f = DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))
        for ss in (2, 8):
            a = ssa_gen(f, ss)
            b = ssa_gen_native(f, ss)
            assert (a.ss, a.ms, a.m) == (b.ss, b.ms, b.m)
            assert np.array_equal(a.r2i, b.r2i), (n_seq, ss)
            assert np.array_equal(a.ssa, b.ssa), (n_seq, ss)


def test_native_lf2_and_merge_apply():
    """rb3t_lf2 / rb3t_lf2_packed and rb3t_merge_apply against numpy specs."""
    import ctypes

    import pytest

    from ropebwt3_jax.construct.merge import lf2_table
    from ropebwt3_jax.native import get_sw_lib

    lib = get_sw_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(44)
    P = ctypes.c_void_p
    for _ in range(20):
        n = int(rng.integers(1, 6000))
        seq = rng.integers(0, 6, n).astype(np.uint8)
        acc2, lf2 = lf2_table(seq)  # native fast path
        cnt = np.bincount(seq, minlength=6).astype(np.int64)
        a2 = np.zeros(7, np.int64)
        a2[1:] = np.cumsum(cnt)
        order = np.argsort(seq, kind="stable")
        within = np.empty(n, np.int64)
        within[order] = np.arange(n) - a2[seq[order].astype(np.int64)]
        want = a2[seq.astype(np.int64)] + within
        assert np.array_equal(acc2, a2) and np.array_equal(lf2, want)
        acc2p = np.zeros(7, np.int64)
        rec = np.empty(n, np.int64)
        lib.rb3t_lf2_packed(P(seq.ctypes.data), n, P(acc2p.ctypes.data), P(rec.ctypes.data))
        assert np.array_equal(acc2p, a2) and np.array_equal(rec, (want << 3) | seq)
        # merge_apply with a valid stable-merge ins (nondecreasing)
        n1 = int(rng.integers(1, 6000))
        bwt1 = rng.integers(0, 6, n1).astype(np.uint8)
        ins = np.sort(rng.integers(0, n1 + 1, n)).astype(np.int64)
        merged = np.empty(n1 + n, np.uint8)
        lib.rb3t_merge_apply(P(bwt1.ctypes.data), n1, P(seq.ctypes.data), P(ins.ctypes.data), n, P(merged.ctypes.data))
        pos2 = ins + np.arange(n)
        wantm = np.empty(n1 + n, np.uint8)
        mask = np.ones(n1 + n, bool)
        mask[pos2] = False
        wantm[pos2] = seq
        wantm[mask] = bwt1
        assert np.array_equal(merged, wantm)


def test_sharded_merge_rank(dense_index):
    """merge_rank_sharded == merge_rank_plain on a toy B2 batch (LF lanes
    over dp, rank psum over idx)."""
    import jax

    from ropebwt3_jax.construct.merge import merge_rank_plain
    from ropebwt3_jax.parallel.mesh import make_mesh
    from ropebwt3_jax.parallel.merge_sharded import merge_rank_sharded

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import numpy as np

    from ropebwt3_jax.construct.sa import gsa_bwt
    from ropebwt3_jax.nt6 import revcomp

    rng = np.random.default_rng(3)
    parts = []
    for _ in range(5):  # 10 sequences incl. rc -> odd lane count, pad path
        s = rng.integers(1, 5, 300).astype(np.uint8)
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    b2 = gsa_bwt(np.concatenate(parts), backend="numpy")

    mesh = make_mesh(2, 4)
    acc2a, ins_a = merge_rank_plain(dense_index, b2)
    acc2b, ins_b = merge_rank_sharded(dense_index, b2, mesh)
    assert (acc2a == acc2b).all()
    assert (ins_a == ins_b).all()
