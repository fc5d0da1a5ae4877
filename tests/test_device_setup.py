"""Device set-up that the CPU can check: where the compile cache goes, that
the device engines refuse an unpinned CPU backend, that --engine=hybrid and
--engine=jax fail loudly instead of running host-only, and the occ="auto"
choice from a reported device memory limit."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _py(code: str, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT)


@pytest.mark.parametrize("preset", [None, "custom"])
def test_compile_cache_dir(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    the fixed <checkout>/.jax_cache."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    if preset:
        want = str(tmp_path / preset)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = _py("import jax, ropebwt3_jax as r; r._jax_setup(); print(jax.config.jax_compilation_cache_dir)", env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


def test_cache_dir_is_gitignored():
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read().split()


@pytest.mark.parametrize("platforms, ok", [("cpu", True), (None, False), ("", False)])
def test_require_device(platforms, ok):
    """The CPU backend runs the device path only when pinned by name."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    if platforms is not None:
        env["JAX_PLATFORMS"] = platforms
    r = _py("import ropebwt3_jax as r; print(r.require_device())", env)
    if ok:
        assert r.returncode == 0 and r.stdout.strip() == "cpu", r.stderr
    else:
        assert r.returncode != 0 and "found no accelerator" in r.stderr


@pytest.mark.parametrize("engine", ["hybrid", "jax"])
def test_device_engine_failure_is_loud(ref_index, corpus, engine):
    """With no buildable device engine (here: no accelerator and no CPU pin),
    `mem --engine=hybrid|jax` fails and prints no BED, instead of quietly
    answering from the host engine."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["RB3JAX_STRICT_EXIT"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "ropebwt3_jax", "mem", "-l13", f"--engine={engine}", str(ref_index), str(corpus / "reads.fa")],
        capture_output=True, env=env, cwd=ROOT,
    )
    assert r.returncode != 0
    assert r.stdout == b""
    assert b"found no accelerator" in r.stderr


def test_mem_auto_stays_on_host(ref_index, corpus):
    """`mem` with the default engine never builds the device engine: it
    answers with no accelerator and no CPU pin."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["RB3JAX_STRICT_EXIT"] = "1"
    args = ["mem", "-l13", str(ref_index), str(corpus / "reads.fa")]
    r = subprocess.run([sys.executable, "-m", "ropebwt3_jax"] + args, capture_output=True, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout.count(b"\n") > 0


@pytest.mark.parametrize(
    "n, n_idx, limit, want",
    [
        (10**9, 1, None, "dense"),  # no reported limit (CPU backend): dense
        (10**9, 1, 0, "dense"),
        (10**9, 1, 60 * 10**9, "dense"),  # 0.75 GB of dense rows on a 60 GB limit
        (100 * 10**9, 1, 60 * 10**9, "rb"),  # 75 GB of rows: compressed
        (100 * 10**9, 4, 60 * 10**9, "dense"),  # 18.75 GB per idx shard
        (80 * 10**9, 1, 80 * 10**9, "dense"),  # 60 GB == 0.75 of the limit
        (80 * 10**9 + 8, 1, 80 * 10**9, "rb"),
    ],
)
def test_auto_occ_from_bytes_limit(n, n_idx, limit, want):
    from ropebwt3_jax.ops.smem import auto_occ

    assert auto_occ(n, n_idx, bytes_limit=limit) == want


def test_auto_occ_reads_device_limit(monkeypatch):
    """Without an explicit limit auto_occ asks the first device."""
    import jax

    from ropebwt3_jax.ops import smem

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 8 * 10**9}

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert smem.auto_occ(10 * 10**9) == "rb"
    assert smem.auto_occ(7 * 10**9) == "dense"
