"""Native (C++) fast paths, compiled on demand with g++ and loaded via ctypes.

Currently: the FMD run-length codec (rld_codec.cpp).  Every entry point has a
pure-Python fallback in formats/, so a missing toolchain only costs speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "rld_codec.cpp")
_SO = os.path.join(_DIR, "_rld_codec.so")
_SW_SRC = os.path.join(_DIR, "bwasw_core.cpp")
_SW_SO = os.path.join(_DIR, "_bwasw_core.so")

_SAIS_SRC = os.path.join(_DIR, "sais.cpp")
_SAIS_SO = os.path.join(_DIR, "_sais.so")

_lib = None
_tried = False
_sw_lib = None
_sw_tried = False
_sais_lib = None
_sais_tried = False


_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _build(src: str, so: str) -> None:
    # Rebuild keyed on a source+flags hash (not mtimes): a checked-out or
    # foreign-arch .so (-march=native!) must always be replaced, never trusted.
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXXFLAGS).encode()).hexdigest()
    stamp = so + ".hash"
    if os.path.exists(so) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return
    # per-process temp name: concurrent builds must not interleave g++ writes
    # on a shared .tmp path (os.replace then installs atomically)
    tmp = f"{so}.tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", *_CXXFLAGS, "-o", tmp, src],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(stamp, "w") as f:
        f.write(digest)


_FA2LINE_SRC = os.path.join(_DIR, "fa2line.cpp")
_FA2LINE_BIN = os.path.join(_DIR, "_fa2line")
_FA2LINE_FLAGS = ["-O2", "-std=c++17"]


def ensure_fa2line() -> str | None:
    """Build the standalone fa2line binary (native/fa2line.cpp) and
    best-effort copy it next to the installed launcher as rb3jax-fa2line so
    bin/rb3jax can exec it without starting Python — the interpreter + numpy
    startup (~0.9 s) dominates this I/O-bound command.  Returns the binary
    path, or None if the toolchain is unavailable."""
    import shutil
    import sys

    try:
        with open(_FA2LINE_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_FA2LINE_FLAGS).encode()).hexdigest()
        stamp = _FA2LINE_BIN + ".hash"
        fresh = not (os.path.exists(_FA2LINE_BIN) and os.path.exists(stamp) and open(stamp).read().strip() == digest)
        if fresh:
            tmp = f"{_FA2LINE_BIN}.tmp.{os.getpid()}"  # no shared-tmp build race
            try:
                subprocess.run(
                    ["g++", *_FA2LINE_FLAGS, "-o", tmp, _FA2LINE_SRC, "-lz"],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _FA2LINE_BIN)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            with open(stamp, "w") as f:
                f.write(digest)
        launcher_copy = os.path.join(os.path.dirname(sys.executable), "rb3jax-fa2line")
        if fresh or not os.path.exists(launcher_copy) or not os.path.exists(launcher_copy + ".src"):
            try:  # best-effort: a read-only bin dir only costs the fast path
                tmp = f"{launcher_copy}.tmp.{os.getpid()}"
                shutil.copy2(_FA2LINE_BIN, tmp)
                os.replace(tmp, launcher_copy)
                # source-path pointer: bin/rb3jax compares the copy's mtime
                # against this source before exec'ing, so a fa2line.cpp edit
                # falls back to Python (which rebuilds + recopies) instead of
                # running a stale binary forever (advisor round 3)
                with open(tmp, "w") as pf:
                    pf.write(_FA2LINE_SRC + "\n")
                os.replace(tmp, launcher_copy + ".src")
            except OSError:
                pass
        return _FA2LINE_BIN
    except Exception:
        return None


def get_lib():
    """Return the loaded ctypes library, building it if needed; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _build(_SRC, _SO)
        lib = ctypes.CDLL(_SO)
        lib.rb3t_fmd_decode.restype = ctypes.c_int64
        lib.rb3t_fmd_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.rb3t_fmd_encode.restype = ctypes.c_void_p
        lib.rb3t_fmd_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.rb3t_free.argtypes = [ctypes.c_void_p]
        lib.rb3t_runs_expand.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.rb3t_block_counts.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.rb3t_dense_tables.restype = None
        lib.rb3t_dense_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        # without argtypes ctypes passes Python ints as 32-bit C int — the
        # runblock builders take int64 lengths (8 Gsym indexes truncate!)
        lib.rb3t_runblock_count.restype = None
        lib.rb3t_runblock_count.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.rb3t_runblock_fill.restype = None
        lib.rb3t_runblock_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def get_sw_lib():
    """BWA-SW native DP core (bwasw_core.cpp); None if unavailable."""
    global _sw_lib, _sw_tried
    if _sw_lib is not None or _sw_tried:
        return _sw_lib
    _sw_tried = True
    try:
        _build(_SW_SRC, _SW_SO)
        lib = ctypes.CDLL(_SW_SO)
        V, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.rb3t_sw_dp.restype = None
        lib.rb3t_sw_dp.argtypes = [V, V, V, V, I64, V, I32, V, V, V, V, V, V, V, V, V, V]
        lib.rb3t_hapdiv_batch.restype = None
        lib.rb3t_hapdiv_batch.argtypes = [V, V, V, V, I64, V, V, I64, I64, I32, V, V]
        lib.rb3t_sw_batch.restype = V
        lib.rb3t_sw_batch.argtypes = [V, V, V, V, I64, V, V, V, I64, I32, ctypes.POINTER(I64), V]
        lib.rb3t_smem_batch.restype = V
        lib.rb3t_smem_batch.argtypes = [V, V, V, V, I64, I64, I32, V, V, I64, I32, ctypes.POINTER(I64), V, V]
        lib.rb3t_fused_build.restype = None
        lib.rb3t_fused_build.argtypes = [V, V, I64, V, I32]
        lib.rb3t_pline_build.restype = None
        lib.rb3t_pline_build.argtypes = [V, V, I64, I64, V, I32]
        lib.rb3t_buf_free.restype = None
        lib.rb3t_buf_free.argtypes = [V]
        lib.rb3t_ssa_multi_batch.restype = None
        lib.rb3t_ssa_multi_batch.argtypes = [V, V, V, V, I64, I32, I32, V, V, I64, V, V, V, V, V, V, V, I32, V]
        lib.rb3t_merge_rank.restype = None
        lib.rb3t_merge_rank.argtypes = [V, V, V, V, I64, V, V, I64, I64, V, I32]
        lib.rb3t_lf2.restype = None
        lib.rb3t_lf2.argtypes = [V, I64, V, V]
        lib.rb3t_ssa_gen.restype = None
        lib.rb3t_ssa_gen.argtypes = [V, V, V, V, I64, I64, I32, I32, V, V, I32]
        lib.rb3t_rank_batch.restype = None
        lib.rb3t_rank_batch.argtypes = [V, V, V, V, I64, V, I64, V, I32]
        lib.rb3t_retrieve.restype = I64
        lib.rb3t_retrieve.argtypes = [V, V, V, V, I64, I64, V, I64, ctypes.POINTER(I64)]
        lib.rb3t_merge_rank_packed.restype = None
        lib.rb3t_merge_rank_packed.argtypes = [V, V, V, V, I64, V, I64, I64, I32]
        lib.rb3t_lf2_packed.restype = None
        lib.rb3t_lf2_packed.argtypes = [V, I64, V, V]
        lib.rb3t_merge_apply.restype = None
        lib.rb3t_merge_apply.argtypes = [V, I64, V, V, I64, V]
        _sw_lib = lib
    except Exception:
        _sw_lib = None
    return _sw_lib


def get_sais_lib():
    """Native SA-IS batch BWT builder (sais.cpp); None if unavailable."""
    global _sais_lib, _sais_tried
    if _sais_lib is not None or _sais_tried:
        return _sais_lib
    _sais_tried = True
    try:
        _build(_SAIS_SRC, _SAIS_SO)
        lib = ctypes.CDLL(_SAIS_SO)
        lib.rb3t_gsa_bwt.restype = ctypes.c_int
        lib.rb3t_gsa_bwt.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        _sais_lib = lib
    except Exception:
        _sais_lib = None
    return _sais_lib
