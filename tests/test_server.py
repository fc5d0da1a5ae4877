"""Resident engine server (server.py): golden mem via the socket route.

Starts `rb3jax serve` (CPU backend, device engine) on the tiny index, lets a
plain `mem` CLI invocation auto-route to it, and byte-compares the BED with
the reference binary (or, without it, the native host engine)."""

import os
import subprocess
import sys
import time

import pytest

from .conftest import run_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    e = dict(os.environ)
    e["JAX_PLATFORMS"] = "cpu"
    return e


@pytest.mark.slow  # ~3 min of daemon spawn/compile; serve coverage stays
# via test_mem_via_server_golden
def test_daemon_lifecycle_golden(ref_bin, ref_index, corpus):
    """serve --daemon + RB3JAX_AUTO_SERVE: the daemon detaches with a
    pidfile, a first auto-spawning mem runs locally and stays golden, a later
    mem hits the warm server, and serve --stop tears everything down."""
    from ropebwt3_jax.server import pid_path, server_available, sock_path

    idx = str(ref_index)
    env = _env()
    want = run_ref(ref_bin, ["mem", "-l13", idx, str(corpus / "reads.fa")])
    try:
        # first use with auto-spawn enabled: spawns the daemon, runs locally
        env_auto = dict(env)
        env_auto["RB3JAX_AUTO_SERVE"] = "1"
        env_auto["RB3JAX_SERVE_ARGS"] = "--warm=13:150"  # one light warm on CPU
        r = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "mem", "-l13", idx, str(corpus / "reads.fa")],
            env=env_auto, cwd=ROOT, capture_output=True, timeout=600,
        )
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        assert r.stdout == want
        assert b"warm-engine daemon" in r.stderr
        assert os.path.exists(pid_path(idx))
        # a second auto-spawn attempt must NOT start another daemon
        r2 = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "mem", "-l13", idx, str(corpus / "reads.fa")],
            env=env_auto, cwd=ROOT, capture_output=True, timeout=600,
        )
        assert r2.stdout == want
        assert b"starting warm-engine daemon" not in r2.stderr
        # wait for readiness, then the warm-path request must be golden
        for _ in range(1200):  # 10 min: CPU-contended warm compiles exceeded 300 s
            if server_available(idx):
                break
            time.sleep(0.5)
        else:
            raise AssertionError("daemon never became ready: " + open(sock_path(idx)[:-5] + ".log").read()[-2000:])
        r3 = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "mem", "-l13", idx, str(corpus / "reads.fa")],
            env=env, cwd=ROOT, capture_output=True, timeout=600,
        )
        assert r3.stdout == want
    finally:
        subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "serve", "--stop", idx],
            env=env, cwd=ROOT, capture_output=True, timeout=60,
        )
    time.sleep(1.0)
    assert not os.path.exists(pid_path(idx))
    assert not server_available(idx)


def test_mem_via_server_golden(golden, ref_index, corpus):
    from ropebwt3_jax.server import server_available, sock_path

    idx = str(ref_index)
    srv = subprocess.Popen(
        [sys.executable, "-m", "ropebwt3_jax", "serve", "--warm=13:150", idx],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        for _ in range(1200):  # 10 min: CPU-contended warm compiles exceeded 300 s
            if server_available(idx):
                break
            if srv.poll() is not None:
                raise AssertionError(f"server died: {srv.communicate()[1].decode()[-2000:]}")
            time.sleep(0.5)
        else:
            raise AssertionError("server never became ready")

        want = golden(["mem", "-l13", idx, str(corpus / "reads.fa")])
        r = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "mem", "-l13", idx, str(corpus / "reads.fa")],
            env=_env(), cwd=ROOT, capture_output=True, timeout=600,
        )
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        assert r.stdout == want
        # second request reuses the warm engine (same bytes)
        r2 = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "mem", "-l13", idx, str(corpus / "reads.fa")],
            env=_env(), cwd=ROOT, capture_output=True, timeout=600,
        )
        assert r2.stdout == want
        # --engine=native must BYPASS the server and still match
        r3 = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "mem", "--engine=native", "-l13", idx, str(corpus / "reads.fa")],
            env=_env(), cwd=ROOT, capture_output=True, timeout=600,
        )
        assert r3.stdout == want
        # mem --engine=hybrid routes to the server too (device + native
        # split inside the server process) and stays byte-golden
        r4 = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "mem", "--engine=hybrid", "-l13", idx, str(corpus / "reads.fa")],
            env=_env(), cwd=ROOT, capture_output=True, timeout=600,
        )
        assert r4.returncode == 0, r4.stderr.decode()[-2000:]
        assert r4.stdout == want
        # sw/hapdiv --engine=jax route to the same server (device DP engines
        # held warm per SwOpt) and stay byte-golden
        lines = open(corpus / "reads.fa").read().strip().split("\n")
        swr = corpus / "reads_srv.fa"
        swr.write_text("\n".join(lines[:12]) + "\n")
        for cmd in (["sw", "-p2"], ["hapdiv", "-a61", "-w25"]):
            want_c = golden(cmd + [idx, str(swr)])
            rc = subprocess.run(
                [sys.executable, "-m", "ropebwt3_jax", cmd[0], "--engine=jax"] + cmd[1:] + [idx, str(swr)],
                env=_env(), cwd=ROOT, capture_output=True, timeout=600,
            )
            assert rc.returncode == 0, (cmd[0], rc.stderr.decode()[-2000:])
            assert rc.stdout == want_c, cmd[0]
    finally:
        subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax", "serve", "--stop", idx],
            env=_env(), cwd=ROOT, capture_output=True, timeout=60,
        )
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
        try:
            os.unlink(sock_path(idx))
        except FileNotFoundError:
            pass
