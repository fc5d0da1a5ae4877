"""Resident engine server: pay device start-up once per index.

One process opens the device, loads the index, builds the device engine and
compiles its programs ONCE; thin CLI clients then stream `mem` (and device
`sw`/`hapdiv`) requests over a unix socket and get the output bytes back at
warm-engine speed.  The clients never start a device backend themselves
(bin/rb3jax runs them with JAX_PLATFORMS=cpu), so the server is the one
process holding the card.

    rb3jax serve idx.fmd &          # warm the device engine for this index
    rb3jax mem -l31 idx.fmd q.fa    # auto-routes to the server when up

The socket is keyed by the index's realpath, so clients can only reach a
server holding the same index.  Requests are serialized (the device runs one
program at a time anyway); the protocol is length-prefixed JSON + raw bytes.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import socket
import struct
import sys
import tempfile

MAGIC_Q = b"RB3Q"
MAGIC_R = b"RB3R"


class EngineCache:
    """Per-(min_occ, min_len) BatchedSmemTG engines plus per-SwOpt device
    sw/hapdiv engines over one loaded index (those parameters are
    compile-time constants of the kernels)."""

    def __init__(self, f):
        self.f = f
        self._engs: dict = {}
        self._sw: dict = {}
        self._hapdiv: dict = {}

    def engine_for(self, min_occ: int, min_len: int):
        key = (int(min_occ), int(min_len))
        if key not in self._engs:
            from .ops.smem import BatchedSmemTG

            self._engs[key] = BatchedSmemTG(self.f, min_occ=key[0], min_len=key[1])
        return self._engs[key]

    @staticmethod
    def _opt_key(opt):
        return (opt.flag, opt.n_best, opt.min_sc, opt.end_len, opt.match, opt.mis,
                opt.e2e_drop, opt.gap_open, opt.gap_ext, opt.min_mem_len, opt.max_pos)

    def sw_engine_for(self, opt):
        key = self._opt_key(opt)
        if key not in self._sw:
            from .align.sw_jax import SwDeviceEngine

            self._sw[key] = SwDeviceEngine(self.f, opt)
        return self._sw[key]

    def hapdiv_engine_for(self, opt):
        key = self._opt_key(opt)
        if key not in self._hapdiv:
            from .align.hapdiv_jax import HapdivDeviceEngine

            self._hapdiv[key] = HapdivDeviceEngine(self.f, opt)
        return self._hapdiv[key]


def sock_path(index_path: str) -> str:
    h = hashlib.sha1(os.path.realpath(index_path).encode()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"rb3jax-serve-{h}.sock")


def pid_path(index_path: str) -> str:
    return sock_path(index_path)[: -len(".sock")] + ".pid"


def log_path(index_path: str) -> str:
    return sock_path(index_path)[: -len(".sock")] + ".log"


def spawn_daemon(index_path: str, extra: list[str] | None = None) -> int:
    """Start a detached `serve` for index_path; returns the child pid.

    Used by `serve --daemon` and by the opt-in first-use auto-spawn
    (RB3JAX_AUTO_SERVE=1): the spawning request proceeds on the local engine
    while the daemon pays the compiles, so the SECOND invocation hits
    the warm engine.  Logs go to log_path(); the pid is recorded so
    `serve --stop` can clean up even before the socket exists."""
    import subprocess

    env = dict(os.environ)
    # the daemon exists to hold the device engine: drop a host-only pin the
    # launcher may have put on the spawning client
    if env.get("JAX_PLATFORMS") == "cpu" and env.get("RB3JAX_HOST_ONLY") == "1":
        env.pop("JAX_PLATFORMS")
    env.pop("RB3JAX_HOST_ONLY", None)
    lp = log_path(index_path)
    with open(lp, "ab") as lf:
        child = subprocess.Popen(
            [sys.executable, "-m", "ropebwt3_jax", "serve"] + (extra or []) + [os.path.abspath(index_path)],
            stdout=lf, stderr=lf, stdin=subprocess.DEVNULL, start_new_session=True, env=env,
        )
    with open(pid_path(index_path), "w") as pf:
        pf.write(str(child.pid))
    return child.pid


def maybe_autospawn(index_path: str) -> None:
    """Opt-in (RB3JAX_AUTO_SERVE=1) fire-and-forget daemon spawn when no
    server answers for this index and none is already starting."""
    if os.environ.get("RB3JAX_AUTO_SERVE") != "1":
        return
    pp = pid_path(index_path)
    if os.path.exists(pp):  # one already starting (or stale: user runs --stop)
        try:
            pid = int(open(pp).read().strip())
            os.kill(pid, 0)
            return  # alive: starting up or serving
        except (ValueError, ProcessLookupError, PermissionError):
            pass
    extra = os.environ.get("RB3JAX_SERVE_ARGS", "").split()
    pid = spawn_daemon(index_path, extra)
    print(f"[rb3jax] starting warm-engine daemon (pid {pid}, log {log_path(index_path)}); this request runs locally", file=sys.stderr)


def _send(conn, magic: bytes, meta: dict, *payloads: bytes) -> None:
    m = json.dumps(meta).encode()
    conn.sendall(magic + struct.pack("<I", len(m)) + m + struct.pack("<I", len(payloads)))
    for p in payloads:
        conn.sendall(struct.pack("<Q", len(p)))
        conn.sendall(p)


def _recv_exact(conn, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = conn.recv(min(1 << 20, n - len(buf)))
        if not got:
            raise ConnectionError("peer closed")
        buf += got
    return buf


def _recv(conn, magic: bytes):
    got = _recv_exact(conn, 4)
    if got != magic:
        raise ConnectionError(f"bad magic {got!r}")
    (mlen,) = struct.unpack("<I", _recv_exact(conn, 4))
    meta = json.loads(_recv_exact(conn, mlen))
    (np_,) = struct.unpack("<I", _recv_exact(conn, 4))
    payloads = []
    for _ in range(np_):
        (plen,) = struct.unpack("<Q", _recv_exact(conn, 8))
        payloads.append(_recv_exact(conn, plen))
    return meta, payloads


def server_available(index_path: str) -> bool:
    p = sock_path(index_path)
    if not os.path.exists(p):
        return False
    try:
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(2.0)
        s.connect(p)
        _send(s, MAGIC_Q, {"cmd": "ping"})
        meta, _ = _recv(s, MAGIC_R)
        s.close()
        return meta.get("rc") == 0
    except Exception:
        return False


def client_run(index_path: str, argv: list[str], timeout: float = 3600.0, cmd: str = "mem") -> int:
    """Run `<cmd> argv` on the resident server; stream stdout/stderr here.
    Returns the remote rc; raises on transport errors (caller falls back)."""
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(timeout)
    s.connect(sock_path(index_path))
    # absolutize file args so the server resolves them regardless of its cwd
    argv = [os.path.abspath(a) if os.path.exists(a) else a for a in argv]
    _send(s, MAGIC_Q, {"cmd": cmd, "argv": argv})
    meta, payloads = _recv(s, MAGIC_R)
    s.close()
    if payloads:
        sys.stdout.buffer.write(payloads[0])
        sys.stdout.buffer.flush()
    if len(payloads) > 1 and payloads[1]:
        sys.stderr.buffer.write(payloads[1])
        sys.stderr.buffer.flush()
    # route marker so harnesses (fuzz server_scenario) can verify the request
    # really went through the resident engine, not a silent local fallback
    print("[server] request served by resident engine", file=sys.stderr)
    return int(meta.get("rc", 1))


def main_serve(argv: list[str]) -> int:
    """`rb3jax serve [options] <idx>`: hold a warm mem engine for <idx>.

    Options: --engine=jax|native (default jax: that is the engine worth
    keeping resident), --warm-len=INT,INT (read-length buckets to precompile),
    --stop (shut down a running server for this index)."""
    from . import cli as _cli

    engine = "jax"
    warm_lens = ["19:150", "31:150"]
    warm_hapdiv: list[int] = []
    warm_sw: list[int] = []
    stop = False
    daemon = False
    fwd: list[str] = []  # options forwarded to the daemon child
    args = []
    for a in argv:
        if a.startswith("--engine=") or a.startswith("--warm"):
            fwd.append(a)
        if a.startswith("--engine="):
            engine = a.split("=", 1)[1]
        elif a.startswith("--warm="):
            warm_lens = [x for x in a.split("=", 1)[1].split(",") if x]
        elif a.startswith("--warm-hapdiv="):
            warm_hapdiv = [int(x) for x in a.split("=", 1)[1].split(",") if x]
        elif a.startswith("--warm-sw="):
            warm_sw = [int(x) for x in a.split("=", 1)[1].split(",") if x]
        elif a == "--stop":
            stop = True
        elif a == "--daemon":
            daemon = True
        else:
            args.append(a)
    if not args:
        print(
            "Usage: rb3jax serve [--engine=jax] [--warm=MINLEN:READLEN,...]"
            " [--warm-hapdiv=K,...] [--warm-sw=READLEN,...] [--daemon] [--stop] <idx>",
            file=sys.stderr,
        )
        return 1
    index_path = args[0]
    sp = sock_path(index_path)

    if stop:
        rc = 1
        try:
            s = socket.socket(socket.AF_UNIX)
            s.settimeout(5.0)
            s.connect(sp)
            _send(s, MAGIC_Q, {"cmd": "stop"})
            _recv(s, MAGIC_R)
            print("server stopped", file=sys.stderr)
            rc = 0
        except Exception as e:
            # not serving yet (still warming?) — fall back to the pidfile
            pp = pid_path(index_path)
            try:
                pid = int(open(pp).read().strip())
                os.kill(pid, 15)
                print(f"killed warming daemon pid {pid}", file=sys.stderr)
                rc = 0
            except Exception:
                print(f"no server to stop ({e})", file=sys.stderr)
        for p in (pid_path(index_path),):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        return rc

    if daemon:
        pid = spawn_daemon(index_path, fwd)
        print(f"[serve] daemon started (pid {pid}, log {log_path(index_path)})", file=sys.stderr)
        return 0

    f = _cli.load_index(index_path, load_ssa=True, load_sid=True)
    eng = None
    if engine == "jax":
        eng = EngineCache(f)
        # precompile the packed kernel for the expected workloads
        import numpy as np

        for spec in warm_lens:
            min_len, _, L = spec.partition(":")
            min_len, L = int(min_len), int(L or 150)
            rng = np.random.default_rng(0)
            qs = [rng.integers(1, 5, L).astype(np.uint8) for _ in range(64)]
            print(f"[serve] warming -l{min_len} L={L} ...", file=sys.stderr, flush=True)
            eng.engine_for(1, min_len).run(qs)
        if warm_hapdiv or warm_sw:
            from .align.bwasw import RB3_SWF_E2E, RB3_SWF_HAPDIV, SwOpt

            rng = np.random.default_rng(0)
            for k in warm_hapdiv:
                opt = SwOpt()
                opt.flag, opt.end_len = RB3_SWF_E2E | RB3_SWF_HAPDIV, 1
                print(f"[serve] warming hapdiv K={k} ...", file=sys.stderr, flush=True)
                eng.hapdiv_engine_for(opt).run([rng.integers(1, 5, k).astype(np.uint8) for _ in range(32)])
            for L in warm_sw:
                opt = SwOpt()
                print(f"[serve] warming sw L={L} ...", file=sys.stderr, flush=True)
                eng.sw_engine_for(opt).run([rng.integers(1, 5, L).astype(np.uint8) for _ in range(8)])
    try:
        os.unlink(sp)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX)
    srv.bind(sp)
    srv.listen(8)
    with open(pid_path(index_path), "w") as pf:  # --stop works pre-socket too
        pf.write(str(os.getpid()))
    print(f"[serve] ready on {sp} (engine={engine})", file=sys.stderr, flush=True)
    try:
        while True:
            conn, _ = srv.accept()
            try:
                meta, _payloads = _recv(conn, MAGIC_Q)
                cmd = meta.get("cmd")
                if cmd == "ping":
                    _send(conn, MAGIC_R, {"rc": 0})
                    continue
                if cmd == "stop":
                    _send(conn, MAGIC_R, {"rc": 0})
                    break
                if cmd not in ("mem", "sw", "hapdiv"):
                    _send(conn, MAGIC_R, {"rc": 1, "err": "unknown cmd"})
                    continue
                out_b = io.BytesIO()
                err_t = io.StringIO()
                out_t = io.TextIOWrapper(out_b, write_through=True)
                with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err_t):
                    try:
                        rc = _cli.main_search(
                            list(meta["argv"]), cmd,
                            _preloaded=(index_path, f, eng),
                        )
                    except BaseException as e:  # report, keep serving
                        rc = 1
                        print(f"ERROR: {type(e).__name__}: {e}", file=sys.stderr)
                out_t.flush()
                _send(conn, MAGIC_R, {"rc": rc}, out_b.getvalue(), err_t.getvalue().encode())
            except ConnectionError:
                pass
            finally:
                conn.close()
    finally:
        srv.close()
        for p in (sp, pid_path(index_path)):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
    return 0
