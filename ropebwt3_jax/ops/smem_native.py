"""Threaded native (C++) SMEM-TG engine — the host engine beside the device
kernel (ops/smem.py).  Same TG algorithm as ops/smem_ref.smem_tg
(fm-index.c:483-528), implemented in native/bwasw_core.cpp with the dense
occ tables and a rank cache; bit-identical outputs, equivalence-tested in
tests/test_native_sw.py."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..index.dense import DenseFMIndex
from .smem_ref import Mem


def native_smem_lib():
    if os.environ.get("RB3JAX_NATIVE_SW", "1") == "0":
        return None
    from ..native import get_sw_lib

    return get_sw_lib()


def fused_table(f: DenseFMIndex) -> np.ndarray | None:
    """Fused 128 B/block [symbols | within-super counts] records: one random
    memory region per rank instead of two (bwt line + occ row).  MEASURED
    NEUTRAL-to-WORSE on this host (64M: 1.22 vs 1.47 s best — the 12 MB occ
    table is L3-resident and fusing forfeits that; 640M: wash — the
    interleaved-SM prefetching already hides the second stream), at 2x the
    bwt in memory.  Kept opt-in (RB3T_SMEM_FUSED=1) for hosts with different
    cache/latency balances."""
    if os.environ.get("RB3T_SMEM_FUSED", "0") != "1":
        return None
    cached = getattr(f, "_fused_recs", None)
    if cached is not None:
        return cached
    lib = native_smem_lib()
    if lib is None:
        return None
    nb = len(f.occ_block)
    out = np.empty(nb << 7, np.uint8)
    P = ctypes.c_void_p
    lib.rb3t_fused_build(P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), nb, P(out.ctypes.data), int(os.cpu_count() or 1))
    f._fused_recs = out
    return out


def pline_table(f: DenseFMIndex) -> np.ndarray | None:
    """Packed one-line rank records: one 64-byte record per 128 symbols
    (three 128-bit symbol bit-planes + six uint16 within-super counts), so a
    rank touches a SINGLE random cache line instead of two-to-three.  Halves
    the random-line footprint that bounds the interleaved LF-walk engines at
    >=640M indexes and doubles the same-block pair-rank range.  Bit-exact by
    construction (a memory layout, not an algorithm change); equivalence
    tested in tests/test_native_sw.py.  RB3T_SMEM_PLINE=0 disables."""
    if os.environ.get("RB3T_SMEM_PLINE", "1") != "1":
        return None
    cached = getattr(f, "_pline_recs", None)
    if cached is not None:
        return cached
    lib = native_smem_lib()
    if lib is None:
        return None
    # sidecar-loaded indexes persist the records next to the .dense file and
    # mmap them hugepage-backed (the layout only wins when the TLB covers it)
    sc_path = getattr(f, "_sidecar_path", None)
    pl_path = sc_path + ".pl" if sc_path else None
    if pl_path and os.path.exists(pl_path) and os.path.getmtime(pl_path) >= os.path.getmtime(sc_path):
        from ..index.sidecar import read_pline

        got = read_pline(pl_path, int(f.n))
        if got is not None:
            f._pline_recs, f._pline_mm = got
            return f._pline_recs
    n_recs = (int(f.n) >> 7) + 1
    out = np.empty(n_recs * 64, np.uint8)
    P = ctypes.c_void_p
    lib.rb3t_pline_build(
        P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), n_recs, len(f.bwt),
        P(out.ctypes.data), int(os.cpu_count() or 1),
    )
    if pl_path:
        from ..index.sidecar import read_pline, write_pline

        try:
            write_pline(pl_path, int(f.n), out)
            got = read_pline(pl_path, int(f.n))
            if got is not None:
                f._pline_recs, f._pline_mm = got
                return f._pline_recs
        except OSError:
            pass
    f._pline_recs = out
    return out


def smem_tg_flat_native(f: DenseFMIndex, flat: np.ndarray, seq_off: np.ndarray, min_occ: int, min_len: int) -> tuple[np.ndarray, np.ndarray]:
    """SMEMs for reads packed in one flat nt6 buffer (read i =
    flat[seq_off[i]:seq_off[i+1]]).  Returns (counts (n_reads,) int64,
    rows (sum(counts), 5) int64 [start, end, size, lo, lo_rc]) with rows in
    read order — the allocation-free form the CLI writes BED from directly."""
    lib = native_smem_lib()
    assert lib is not None
    n_reads = len(seq_off) - 1
    if n_reads == 0:
        return np.zeros(0, np.int64), np.zeros((0, 5), np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    out_len = ctypes.c_int64(0)
    P = ctypes.c_void_p
    # the fused/pline tables pay off once the batch does >= ~1 rank per block;
    # the explicit RB3T_SMEM_FUSED=1 opt-in overrides the pline default
    big_batch = int(seq_off[-1]) * 2 >= len(f.occ_block)
    fused = fused_table(f) if big_batch else None
    pline = None
    if fused is None:
        pline = pline_table(f) if big_batch else getattr(f, "_pline_recs", None)
    ptr = lib.rb3t_smem_batch(
        P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data), P(f.acc.ctypes.data),
        int(f.n), int(min_occ), int(min_len), P(flat.ctypes.data), P(seq_off.ctypes.data), n_reads,
        min(os.cpu_count() or 1, n_reads), ctypes.byref(out_len),
        P(fused.ctypes.data) if fused is not None else None,
        P(pline.ctypes.data) if pline is not None else None,
    )
    try:
        raw = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.rb3t_buf_free(ptr)
    # blob: (n_reads+1) int64 offsets, then per read [n_mems][n_mems x 5 rows]
    words = np.frombuffer(raw, dtype=np.int64)
    offs = words[: n_reads + 1]
    counts = (np.diff(offs) - 8) // 40
    tail = words[n_reads + 1 :]
    keep = np.ones(len(tail), bool)
    keep[offs[:-1] // 8] = False  # drop the per-read count words
    return counts, tail[keep].reshape(-1, 5)


def smem_tg_batch_native(f: DenseFMIndex, seqs: list[np.ndarray], min_occ: int, min_len: int) -> list[list[Mem]]:
    n_reads = len(seqs)
    if n_reads == 0:
        return []
    flat = np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs]) if n_reads > 1 else np.asarray(seqs[0], np.uint8)
    seq_off = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=seq_off[1:])
    counts, rows = smem_tg_flat_native(f, flat, seq_off, min_occ, min_len)
    rows_l = rows.tolist()
    out: list[list[Mem]] = []
    k = 0
    for c in counts.tolist():
        out.append([Mem(*r) for r in rows_l[k : k + c]])
        k += c
    return out
