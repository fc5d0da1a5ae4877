"""Native (C++) BWA-SW core equivalence: the ctypes DP must be bit-identical
to the Python reference implementation (which the golden CLI tests pin to the
reference binary), and the mmap dense sidecar must round-trip."""

import numpy as np
import pytest

import ropebwt3_jax.align.bwasw as bw
from ropebwt3_jax.align.bwtl import bwtl_gen, dawg_gen, dawg_gen_linear
from ropebwt3_jax.construct.sa import gsa_bwt
from ropebwt3_jax.index.dense import DenseFMIndex
from ropebwt3_jax.nt6 import char2nt6, revcomp


def _make_index(refseqs):
    parts = []
    for s in refseqs:
        q = char2nt6(s.encode())
        parts += [q, np.array([0], np.uint8), revcomp(q), np.array([0], np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts).astype(np.uint8)))


def _cells_key(rows):
    return [
        [
            (c.lo, c.hi, c.lo_rc, c.H, c.E, c.F, c.rlen, c.qlen, c.H_from, c.E_from,
             c.F_from, int(c.H_from_pos), int(c.E_from_pos), int(c.F_from_off), c.F_off_set, c.flt)
            for c in row
        ]
        for row in rows
    ]


@pytest.fixture(scope="module")
def native_lib():
    lib = bw._native_sw_lib()
    if lib is None:
        pytest.skip("native sw core unavailable")
    return lib


@pytest.mark.parametrize("trial", range(8))
def test_native_dp_matches_python(native_lib, trial):
    import random

    random.seed(500 + trial)
    L = random.choice([120, 250])
    refs = ["".join(random.choice("ACGT") for _ in range(L)) for _ in range(random.choice([1, 3]))]
    refs.append("".join(c if random.random() > 0.02 else random.choice("ACGT") for c in refs[0]))
    f = _make_index(refs)
    src = list(random.choice(refs))
    p = random.randrange(0, max(1, len(src) - 80))
    qv = src[p : p + 70]
    for _ in range(random.randrange(0, 5)):
        op, i = random.random(), random.randrange(len(qv))
        if op < 0.5:
            qv[i] = random.choice("ACGT")
        elif op < 0.75:
            qv.insert(i, random.choice("ACGT"))
        else:
            del qv[i]
    q = char2nt6("".join(qv).encode())
    for mode in ("local", "e2e"):
        opt = bw.SwOpt()
        if mode == "e2e":
            opt.flag |= bw.RB3_SWF_E2E
            g = dawg_gen_linear(q)
        else:
            g = dawg_gen(bwtl_gen(q))
        [(py_rows, py_pos, py_sc)] = bw.sw_core_multi(opt, f, [g])
        nat_rows, nat_pos, nat_sc = bw._sw_core_native(native_lib, opt, f, g)
        assert (py_pos, py_sc) == (nat_pos, nat_sc)
        assert _cells_key(py_rows) == _cells_key(nat_rows)


def test_native_full_sw_matches_python(native_lib, monkeypatch):
    import random

    random.seed(9)
    refs = ["".join(random.choice("ACGT") for _ in range(400)) for _ in range(4)]
    f = _make_index(refs)
    seqs = []
    for _ in range(10):
        src = random.choice(refs)
        p = random.randrange(0, 300)
        s = list(src[p : p + 90])
        for _ in range(3):
            s[random.randrange(len(s))] = random.choice("ACGT")
        seqs.append(char2nt6("".join(s).encode()))
    opt = bw.SwOpt()
    nat = bw.rb3_sw_batch(opt, f, seqs)
    py = [bw._rb3_sw_python(opt, f, s) for s in seqs]

    def hkey(h):
        return (h.score, h.qlen, h.rlen, h.mlen, h.blen, h.lo, h.hi, tuple(h.cigar), tuple(h.qoff), tuple(h.rseq), h.cs)

    assert [[hkey(h) for h in hs] for hs in nat] == [[hkey(h) for h in hs] for hs in py]


def test_native_hapdiv_matches_python(native_lib):
    import random

    random.seed(11)
    refs = ["".join(random.choice("ACGT") for _ in range(600)) for _ in range(2)]
    refs += ["".join(c if random.random() > 0.01 else random.choice("ACGT") for c in refs[0]) for _ in range(3)]
    f = _make_index(refs)
    opt = bw.SwOpt()
    opt.flag |= bw.RB3_SWF_E2E | bw.RB3_SWF_HAPDIV
    opt.end_len = 1
    q = char2nt6(refs[0][:301].encode())
    wins = [q[j : j + 101] for j in range(0, 201, 50)]
    nat = bw._hapdiv_native(native_lib, opt, f, wins)
    gs = [dawg_gen_linear(s) for s in wins]
    outs = bw.sw_core_multi(opt, f, gs)
    py = []
    for (rows, best_pos, best_score), g, s in zip(outs, gs, wins):
        if best_score >= opt.min_sc:
            _, anno = bw.sw_backtrack(opt, f, g, s, rows, best_pos, True)
            py.append(anno)
        else:
            py.append(None)

    def akey(a):
        return None if a is None else (a.n_al, a.max_ed, tuple(a.n_hap))

    assert [akey(a) for a in nat] == [akey(a) for a in py]


def test_native_smem_matches_ref(native_lib):
    import random

    from ropebwt3_jax.ops import smem_ref
    from ropebwt3_jax.ops.smem_native import smem_tg_batch_native

    random.seed(21)
    refs = ["".join(random.choice("ACGT") for _ in range(500)) for _ in range(3)]
    refs += ["".join(c if random.random() > 0.01 else random.choice("ACGT") for c in refs[0]) for _ in range(2)]
    f = _make_index(refs)
    seqs = []
    for _ in range(20):
        src = random.choice(refs)
        p = random.randrange(0, 350)
        s = list(src[p : p + 120])
        for _ in range(random.randrange(0, 4)):
            s[random.randrange(len(s))] = random.choice("ACGT")
        seqs.append(char2nt6("".join(s).encode()))
    for min_occ, min_len in ((1, 19), (1, 31), (2, 25)):
        nat = smem_tg_batch_native(f, seqs, min_occ, min_len)
        ref = [smem_ref.smem_tg(f, s, min_occ, min_len) for s in seqs]

        def key(ms):
            return [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in ms]

        assert [key(a) for a in nat] == [key(b) for b in ref]


def test_native_smem_edge_reads(native_lib):
    """Interleaved SM engine vs the host spec on pathological read mixes:
    empty reads, reads shorter than min_len, exact-min_len reads, reads with
    N, min_len=1, and enough reads (150) to force SM slot refill (G=16)."""
    import random

    from ropebwt3_jax.ops import smem_ref
    from ropebwt3_jax.ops.smem_native import smem_tg_batch_native

    random.seed(77)
    refs = ["".join(random.choice("ACGT") for _ in range(400)) for _ in range(2)]
    f = _make_index(refs)
    seqs = [
        char2nt6(b""),
        char2nt6(b"A"),
        char2nt6(b"ACGTACGTACGTACGTACG"),  # == min_len for (1, 19)
        char2nt6(refs[0][50:69].encode()),
        char2nt6((refs[0][100:150] + "N" + refs[1][20:70]).encode()),
        char2nt6(b"NNNNNNNNNNNNNNNNNNNNNNNNN"),
    ]
    for _ in range(150):
        p = random.randrange(0, 300)
        seqs.append(char2nt6(refs[random.randrange(2)][p : p + random.randrange(0, 100)].encode()))
    for min_occ, min_len in ((1, 19), (1, 1), (2, 12)):
        nat = smem_tg_batch_native(f, seqs, min_occ, min_len)
        ref = [smem_ref.smem_tg(f, s, min_occ, min_len) for s in seqs]

        def key(ms):
            return [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in ms]

        assert [key(a) for a in nat] == [key(b) for b in ref], (min_occ, min_len)


def test_native_smem_seed_table_matches(native_lib, monkeypatch):
    """The opt-in k-mer seed table (RB3T_SMEM_SEED) must be bit-identical to
    the sequential walk for every k, including k clamped to min_len-1."""
    import random

    from ropebwt3_jax.ops.smem_native import smem_tg_batch_native

    random.seed(5)
    refs = ["".join(random.choice("ACGT") for _ in range(600)) for _ in range(3)]
    f = _make_index(refs)
    seqs = []
    for _ in range(80):
        src = random.choice(refs)
        p = random.randrange(0, 450)
        s = list(src[p : p + random.randrange(0, 140)])
        for _ in range(random.randrange(0, 5)):
            if s:
                s[random.randrange(len(s))] = random.choice("ACGTN")
        seqs.append(char2nt6("".join(s).encode()))

    def key(ms):
        return [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in ms]

    for min_occ, min_len in ((1, 19), (2, 9), (1, 5)):
        monkeypatch.setenv("RB3T_SMEM_SEED", "0")
        base = smem_tg_batch_native(f, seqs, min_occ, min_len)
        for k in ("2", "4", "8", "12"):
            monkeypatch.setenv("RB3T_SMEM_SEED", k)
            got = smem_tg_batch_native(f, seqs, min_occ, min_len)
            assert [key(a) for a in got] == [key(b) for b in base], (min_occ, min_len, k)


def test_native_smem_fused_records_match(native_lib, monkeypatch):
    """The opt-in fused 128 B/block record layout (RB3T_SMEM_FUSED=1) must be
    bit-identical to the two-stream layout."""
    import random

    from ropebwt3_jax.ops.smem_native import smem_tg_batch_native

    random.seed(13)
    refs = ["".join(random.choice("ACGT") for _ in range(500)) for _ in range(3)]
    f = _make_index(refs)
    seqs = []
    for _ in range(60):
        p = random.randrange(0, 380)
        s = list(random.choice(refs)[p : p + random.randrange(0, 120)])
        for _ in range(random.randrange(0, 4)):
            if s:
                s[random.randrange(len(s))] = random.choice("ACGTN")
        seqs.append(char2nt6("".join(s).encode()))

    def key(ms):
        return [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in ms]

    monkeypatch.setenv("RB3T_SMEM_FUSED", "0")
    base = smem_tg_batch_native(f, seqs, 1, 17)
    monkeypatch.setenv("RB3T_SMEM_FUSED", "1")
    got = smem_tg_batch_native(f, seqs, 1, 17)
    assert [key(a) for a in got] == [key(b) for b in base]


def test_sidecar_roundtrip(tmp_path):
    from ropebwt3_jax.index.sidecar import read_sidecar, write_sidecar

    rng = np.random.default_rng(0)
    bwt = rng.integers(0, 6, 70000).astype(np.uint8)
    f = DenseFMIndex.from_bwt(bwt)
    p = str(tmp_path / "x.dense")
    write_sidecar(p, f)
    g = read_sidecar(p)
    assert g is not None and g.n == f.n
    assert np.array_equal(g.acc, f.acc)
    assert np.array_equal(np.asarray(g.bwt), f.bwt)
    assert np.array_equal(np.asarray(g.occ_block), f.occ_block)
    assert np.array_equal(np.asarray(g.occ_super), f.occ_super)
    ks = rng.integers(0, f.n + 1, 64)
    assert np.array_equal(f.rank1a(ks), g.rank1a(ks))


def test_native_smem_pline_records_match(native_lib, monkeypatch):
    """The packed one-line rank records (pline, default on) must be
    bit-identical to the two-stream layout, including indexes whose length
    is odd relative to the 128-symbol record (round 4)."""
    import random

    from ropebwt3_jax.ops.smem_native import smem_tg_batch_native

    random.seed(29)
    refs = ["".join(random.choice("ACGT") for _ in range(777)) for _ in range(3)]
    f = _make_index(refs)
    assert f.n % 128 != 0  # exercise the partial last record
    seqs = []
    for _ in range(80):
        p = random.randrange(0, 600)
        s = list(random.choice(refs)[p : p + random.randrange(0, 150)])
        for _ in range(random.randrange(0, 4)):
            if s:
                s[random.randrange(len(s))] = random.choice("ACGTN")
        seqs.append(char2nt6("".join(s).encode()))

    def key(ms):
        return [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in ms]

    monkeypatch.setenv("RB3T_SMEM_PLINE", "0")
    base = smem_tg_batch_native(f, seqs, 1, 17)
    monkeypatch.setenv("RB3T_SMEM_PLINE", "1")
    if hasattr(f, "_pline_recs"):
        del f._pline_recs
    got = smem_tg_batch_native(f, seqs, 1, 17)
    assert [key(a) for a in got] == [key(b) for b in base]


def test_pline_sidecar_roundtrip_and_dp(tmp_path, native_lib):
    """Sidecar-persisted pline records load back byte-identical and the
    native sw/hapdiv DPs produce the same results with them engaged."""
    import os
    import random

    from ropebwt3_jax.align.bwasw import SwOpt, RB3_SWF_E2E, RB3_SWF_HAPDIV, rb3_hapdiv_multi, rb3_sw
    from ropebwt3_jax.index.sidecar import read_pline, read_sidecar, write_pline, write_sidecar
    from ropebwt3_jax.ops.smem_native import pline_table

    random.seed(31)
    refs = ["".join(random.choice("ACGT") for _ in range(900)) for _ in range(2)]
    f = _make_index(refs)
    p = str(tmp_path / "x.dense")
    write_sidecar(p, f)
    g = read_sidecar(p)
    assert g is not None and g._sidecar_version == 2

    # build + persist + reload the records; bytes identical
    recs = pline_table(g)
    assert recs is not None
    assert os.path.exists(p + ".pl")
    got = read_pline(p + ".pl", g.n)
    assert got is not None and np.array_equal(np.asarray(got[0]), np.asarray(recs))

    # hapdiv + sw through the sidecar-backed index (pline engaged) must
    # match the plain in-memory index (no pline)
    win = char2nt6(refs[0][100:201].encode())
    opt = SwOpt()
    opt.flag, opt.end_len = RB3_SWF_E2E | RB3_SWF_HAPDIV, 1
    a = rb3_hapdiv_multi(opt, f, [win])[0]
    b = rb3_hapdiv_multi(opt, g, [win])[0]
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.n_al, a.max_ed, a.n_hap) == (b.n_al, b.max_ed, b.n_hap)
    sw_read = char2nt6((refs[1][200:280] + "T" + refs[1][281:340]).encode())
    ha = rb3_sw(SwOpt(), f, sw_read)
    hb = rb3_sw(SwOpt(), g, sw_read)
    assert [(h.score, h.lo, h.hi, h.cigar, h.cs) for h in ha] == [(h.score, h.lo, h.hi, h.cigar, h.cs) for h in hb]
