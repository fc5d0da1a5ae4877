"""FMD ("RLD\\3") codec — bit-exact re-implementation of the rld0 format.

Layout (rld0.c:222-243): magic "RLD\\3"; uint32 asize<<16|sbits; uint64 reserved;
uint64 n_bytes; uint64 n_frames; 6x uint64 marginal counts; n_bytes of data
words; n_frames * (asize+1) uint64 frame entries.

Data words hold small blocks of 2**sbits 64-bit words. Each block starts with
per-symbol counts of the *previous* block region (cumulative-since-last-header,
written in 16/32/64-bit flavors selected by magnitude; type in the top 2 bits
of the first word, rld0.c:107-135), followed by MSB-first Elias-delta codes of
(run_length, 3-bit symbol) pairs (rld0.c:45-51,137-151). Codes never span
blocks; remaining bits are zero. The last block in each 2**23-word segment has
one fewer usable word (rld0.h:81). A sparse "frame" rank index samples
cumulative counts every 2**ibits symbols (rld0.c:163-204).

This module is I/O-layer code and deliberately CPU-side (numpy/Python with an
optional C++ fast path in native/); the device query path consumes dense tables
built from the decoded runs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

LBITS = 23
LSIZE = 1 << LBITS
M64 = (1 << 64) - 1

_DEC_TAB = 0x333333335555779B


def _ilog2(v: int) -> int:
    return v.bit_length() - 1  # -1 for v == 0, like the reference ilog2 of 0


def _delta_enc(l: int) -> tuple[int, int]:
    """Return (code, width) of the Elias-delta code for run length l >= 1."""
    y = _ilog2(l)
    z = _ilog2(y + 1)
    width = (z << 1) + 1 + y
    code = (l ^ (1 << y)) | (y + 1) << y
    return code, width


@dataclass
class FMDHeader:
    asize: int
    sbits: int
    n_bytes: int
    n_frames: int
    mcnt: np.ndarray  # marginal counts of symbols 0..asize-1 (int64)


def _offset0(asize1: int) -> tuple[int, int, int]:
    return ((asize1 * 16 + 63) // 64, (asize1 * 32 + 63) // 64, asize1)


class FMDEncoder:
    """Streaming run encoder replicating rld_enc/rld_enc_finish exactly."""

    def __init__(self, asize: int = 6, sbits: int = 3):
        self.asize = asize
        self.asize1 = asize + 1
        self.sbits = sbits
        self.ssize = 1 << sbits
        self.off0 = _offset0(self.asize1)
        self.words = np.zeros(1 << 16, dtype=np.uint64)
        self.shead = 0  # word index of current block start
        self.p = self.off0[0]  # first block is type 0 (all-zero header)
        self.r = 64
        self.cnt = [0] * self.asize1  # cnt[0]=total, cnt[c+1]=count of c
        self.mcnt = [0] * self.asize1  # snapshot at current block start
        self.pend_c = -1
        self.pend_l = 0
        self.finished = False

    # -- low-level ---------------------------------------------------------
    def _grow(self, need: int):
        if need >= len(self.words):
            new = np.zeros(max(need + 1, len(self.words) * 2), dtype=np.uint64)
            new[: len(self.words)] = self.words
            self.words = new

    def _stail(self, shead: int) -> int:
        last_in_seg = (shead % LSIZE) + self.ssize == LSIZE
        return shead + self.ssize - (2 if last_in_seg else 1)

    def _next_block(self):
        stail = self._stail(self.shead)
        if (stail % LSIZE) + 2 == LSIZE:  # last block of the segment
            self.shead = (self.shead // LSIZE + 1) * LSIZE
        else:
            self.shead += self.ssize
        self._grow(self.shead + self.ssize)
        marg0 = self.cnt[0] - self.mcnt[0]
        if marg0 < 0x4000:
            typ, width = 0, 16
        elif marg0 < 0x40000000:
            typ, width = 1, 32
        else:
            typ, width = 2, 64
        # pack asize1 counts of `width` bits little-endian into the header words
        acc = 0
        for i in range(self.asize1):
            acc |= (self.cnt[i] - self.mcnt[i]) << (width * i)
        acc |= typ << 62  # type tag lives in bits 62-63 of the first word
        nw = self.off0[typ]
        for i in range(nw):
            self.words[self.shead + i] = (acc >> (64 * i)) & M64
        self.p = self.shead + self.off0[typ]
        self.r = 64
        self.mcnt = list(self.cnt)

    def _enc1(self, l: int, c: int):
        code, w0 = _delta_enc(l)
        x = code << 3 | c  # abits == 3 for the DNA alphabet
        w = w0 + 3
        if w >= self.r and self.p == self._stail(self.shead):
            self._next_block()
        if w > self.r:
            w2 = w - self.r
            self.words[self.p] |= np.uint64(x >> w2)
            self.p += 1
            self.r = 64 - w2
            self.words[self.p] = np.uint64((x << self.r) & M64)
        else:
            self.r -= w
            self.words[self.p] |= np.uint64((x << self.r) & M64)
        self.cnt[0] += l
        self.cnt[c + 1] += l

    # -- public ------------------------------------------------------------
    def put(self, l: int, c: int):
        if l == 0:
            return
        if self.pend_c != c:
            if self.pend_l:
                self._enc1(self.pend_l, self.pend_c)
            self.pend_c, self.pend_l = c, l
        else:
            self.pend_l += l

    def put_runs(self, syms: np.ndarray, lens: np.ndarray):
        for c, l in zip(syms.tolist(), lens.tolist()):
            self.put(int(l), int(c))

    def finish(self) -> None:
        assert not self.finished
        if self.pend_l:
            self._enc1(self.pend_l, self.pend_c)
        self._next_block()
        self.finished = True
        self.n_bytes = self.p * 8
        # cnt -> cumulative; mcnt -> marginals with mcnt[0] = total
        marg = [self.cnt[i] for i in range(self.asize1)]
        self.final_mcnt = [marg[0]] + marg[1:]
        cum = [0] * self.asize1
        for i in range(1, self.asize1):
            cum[i] = cum[i - 1] + marg[i]
        self.final_cnt = cum
        self._build_frames()

    def _build_frames(self):
        """Replicates rld_rank_index (rld0.c:163-204)."""
        ssize, asize, asize1 = self.ssize, self.asize, self.asize1
        n_blks = self.n_bytes * 8 // 64 // ssize + 1
        last = (self.n_bytes >> 3) >> self.sbits << self.sbits
        tot = self.final_mcnt[0]
        self.ibits = _ilog2(tot // n_blks) + 4
        self.n_frames = ((tot + (1 << self.ibits) - 1) >> self.ibits) + 1
        frame = np.zeros(self.n_frames * asize1, dtype=np.uint64)
        cnt = [0] * asize
        k = 1
        i = ssize
        while i <= last:
            w0 = int(self.words[i])
            typ = w0 >> 62
            hdr_words = [int(self.words[i + j]) for j in range(self.off0[typ])]
            acc = 0
            for j, hw in enumerate(hdr_words):
                acc |= hw << (64 * j)
            width = (16, 32, 64)[typ]
            for j in range(1, asize1):
                v = (acc >> (width * j)) & ((1 << width) - 1)
                if typ == 1:
                    v &= 0x3FFFFFFF
                cnt[j - 1] += v
            s = sum(cnt)
            while s >= (k << self.ibits):
                k += 1
            if k < self.n_frames:
                x = k * asize1
                frame[x] = i
                for j in range(asize):
                    frame[x + j + 1] = cnt[j]
            i += ssize
        for k2 in range(1, self.n_frames):
            x = k2 * asize1
            if frame[x] == 0:
                frame[x : x + asize1] = frame[x - asize1 : x]
        self.frame = frame

    def dump_bytes(self) -> bytes:
        assert self.finished
        hdr = b"RLD\x03"
        hdr += struct.pack("<I", self.asize << 16 | self.sbits)
        hdr += struct.pack("<Q", 0)
        hdr += struct.pack("<Q", self.n_bytes)
        hdr += struct.pack("<Q", self.n_frames)
        hdr += struct.pack("<6Q", *self.final_mcnt[1:])
        data = self.words[: self.n_bytes // 8].tobytes()
        return hdr + data + self.frame.tobytes()


def encode_runs(syms: np.ndarray, lens: np.ndarray, sbits: int = 3) -> bytes:
    if sbits == 3:
        data = _encode_runs_native(syms, lens)
        if data is not None:
            return data
    enc = FMDEncoder(6, sbits)
    enc.put_runs(syms, lens)
    enc.finish()
    return enc.dump_bytes()


def _encode_runs_native(syms: np.ndarray, lens: np.ndarray) -> bytes | None:
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out_size = ctypes.c_int64(0)
    ptr = lib.rb3t_fmd_encode(
        syms.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p),
        len(syms),
        ctypes.byref(out_size),
    )
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, out_size.value)
    finally:
        lib.rb3t_free(ptr)


def write_fmd(fn: str, syms: np.ndarray, lens: np.ndarray, sbits: int = 3) -> None:
    import sys

    from ..bufio import write_all

    data = encode_runs(syms, lens, sbits)
    if fn == "-":
        write_all(sys.stdout.buffer, data)
    else:
        with open(fn, "wb") as fp:
            write_all(fp, data)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def parse_header(data: bytes) -> FMDHeader:
    if data[:4] != b"RLD\x03":
        raise ValueError("not an FMD (RLD\\3) file")
    (a,) = struct.unpack_from("<I", data, 4)
    asize, sbits = a >> 16, a & 0xFFFF
    n_bytes, n_frames = struct.unpack_from("<QQ", data, 16)
    mcnt = np.frombuffer(data, dtype="<u8", count=asize, offset=32).astype(np.int64)
    return FMDHeader(asize, sbits, n_bytes, n_frames, mcnt)


def decode_runs(data: bytes) -> tuple[FMDHeader, np.ndarray, np.ndarray]:
    """Decode an FMD byte string into (header, run symbols uint8, run lengths int64).

    Adjacent equal-symbol runs split across blocks are merged, so the result is
    a maximal run-length encoding of the BWT."""
    h = parse_header(data)
    native = _decode_runs_native(data)
    if native is not None:
        return h, native[0], native[1]
    asize1 = h.asize + 1
    off0 = _offset0(asize1)
    words_off = 32 + 8 * h.asize
    words = np.frombuffer(data, dtype="<u8", count=h.n_bytes // 8, offset=words_off)
    ssize = 1 << h.sbits
    last = (h.n_bytes >> 3) >> h.sbits << h.sbits
    syms: list[int] = []
    lens: list[int] = []
    shead = 0
    wl = words.tolist()
    while shead < last:
        stail = shead + ssize - (2 if (shead % LSIZE) + ssize == LSIZE else 1)
        w0 = wl[shead]
        typ = w0 >> 62
        p = shead + off0[typ]
        r = 64
        while True:
            x = (wl[p] << (64 - r)) & M64
            if p != stail and r != 64:
                x |= wl[p + 1] >> r
            if x >> 63:
                run_l, w = 1, 1
            else:
                w = (_DEC_TAB >> ((x >> 59) << 2)) & 0xF
                if w == 0xB and (x >> 58) == 0:
                    break  # end of block
                y = (x >> (64 - w)) - 1
                run_l = (((x << w) & M64) >> (64 - y)) | (1 << y)
                w += y
            c = ((x << w) & M64) >> 61
            w += 3
            if c > h.asize:
                break
            if r > w:
                r -= w
            else:
                p += 1
                r = 64 + r - w
            if syms and syms[-1] == c:
                lens[-1] += run_l
            else:
                syms.append(c)
                lens.append(run_l)
        if (shead % LSIZE) + 2 * ssize > LSIZE:
            shead = (shead // LSIZE + 1) * LSIZE
        else:
            shead += ssize
    return h, np.asarray(syms, dtype=np.uint8), np.asarray(lens, dtype=np.int64)


def _decode_runs_native(data: bytes) -> tuple[np.ndarray, np.ndarray] | None:
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    n = lib.rb3t_fmd_decode(data, len(data), None, None, 0)
    if n < 0:
        return None
    syms = np.empty(n, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int64)
    n2 = lib.rb3t_fmd_decode(
        data, len(data), syms.ctypes.data_as(ctypes.c_void_p), lens.ctypes.data_as(ctypes.c_void_p), n
    )
    if n2 != n:
        return None
    return syms, lens


def read_fmd(fn: str) -> tuple[FMDHeader, np.ndarray, np.ndarray]:
    with open(fn, "rb") as fp:
        data = fp.read()
    return decode_runs(data)
