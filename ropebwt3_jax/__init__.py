"""ropebwt3_jax — an accelerator FM-index engine with the capabilities of lh3/ropebwt3.

Design in JAX/XLA: the run-length BWT is decoded into dense, blockwise
occurrence-checkpoint tables resident in (sharded) device memory; rank /
bidirectional extension / SMEM scans / alignment DP run as batched JAX
computations; construction uses native SA-IS batches plus a batched
interleave-rank BWT merge.

On-disk formats (FMD/FMR/BRE/SSA/plain) and stdout formats (mem BED, sw PAF,
hapdiv tables) are bit-compatible with ropebwt3 v3.10-r281.

NB: jax is imported lazily (see _jax_setup): host-only commands (stat, get,
format conversion, the native engines, ...) never start a device backend.
"""

__version__ = "0.1.0"

# numpy madvise(MADV_HUGEPAGE) makes first-touch page faults ~100x slower on
# some virtualized hosts (THP assembly under lazily-populated VM memory;
# measured 15-170 MB/s vs ~2 GB/s fill bandwidth on one such host).  Disable it
# for every array numpy allocates from here on (and via env for any numpy
# imported later in subprocesses).
import os as _os

_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
try:  # pragma: no cover - numpy private API, best effort
    import numpy as _np

    _np._core.multiarray._set_madvise_hugepage(False)
except Exception:
    pass

_jax_ready = False


def _jax_setup():
    """Import jax and enable x64 (int64 BWT offsets for terabase indexes).
    Call this before using any jax-backed module.

    Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR is set,
    jax reads it and nothing here overrides it; otherwise the cache lives at
    CACHE_DIR, a fixed directory of the checkout (the path is part of the
    cache key, so it must not move between runs)."""
    global _jax_ready
    if _jax_ready:
        return
    import jax

    jax.config.update("jax_enable_x64", True)
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax_ready = True


CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")


def require_device():
    """Gate for the device engines: they run on an accelerator.  The CPU
    backend serves them only when it was asked for by name
    (JAX_PLATFORMS=cpu, as the tests do); a process that merely found no
    accelerator fails here instead of running the device path on the host."""
    _jax_setup()
    import jax

    platform = jax.devices()[0].platform
    if platform == "cpu" and _os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu":
        raise RuntimeError(
            "device engine: JAX found no accelerator (set JAX_PLATFORMS=cpu to run the device path on the host on purpose)"
        )
    return platform
