#!/usr/bin/env python
"""End-to-end smoke test of the FM-index query path on one GPU.

    python chip_smoke.py               # phases 1-7 on one card
    python chip_smoke.py --trace DIR   # + profiler trace of the device mem run
    python chip_smoke.py --four-cards  # only the --mesh runs, on four cards

Every phase runs the CLI (bin/rb3jax) as a user would call it, on an index
built from a seeded synthetic pangenome at the mtb152 shape (BASELINE.json
config 3: 152 haplotypes x 4.4 Mbp at 1% divergence, ~1.34 Gsym
double-strand), with 100k x 150 bp reads at 1% error:

  1. device      jax.devices() must be a GPU (else exit non-zero, nothing run)
  2. build       `build -m120m -do` (native SA-IS + merge on the host)
  3. mem         `mem -l31 --engine=jax` (cold, then warm) and `--engine=hybrid`,
                 byte-equal to `--engine=native` run on the CPU backend; 500
                 reads also checked against ops/smem_ref.py
  4. long reads  500 x 10 kb through `--engine=jax`
  5. rb rows     `mem --engine=jax --occ=rb` (compressed capacity rows)
  6. device DPs  `sw --engine=jax -N25 --no-ssa`, `hapdiv --engine=jax -a101`
  7. served      `serve` + two auto-routed `mem` clients; only the server
                 process may hold the card
  8. four cards  (--four-cards only) `mem --mesh=4x1`, `--mesh=1x4`,
                 `--mesh=1x4 --occ=rb`

All outputs are integer results and compare by exact byte equality.  The
last stdout line is one JSON object {"ok": true, "device": {...}}; any
failure raises and exits non-zero before it is printed.  This process never
starts a device backend itself: every device run is a child process, so one
process at a time holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LAUNCHER = os.path.join(ROOT, "bin", "rb3jax")

# corpus shapes (scripts/scale_bench.py SCALES): double-strand symbols =
# 2 * n_genomes * (glen + 1)
SHAPES = {
    "mtb152": dict(n_genomes=152, glen=4_400_000),  # 1,337,600,304 symbols
    "s640": dict(n_genomes=64, glen=5_000_000),  # 640,000,128 symbols
    "tiny": dict(n_genomes=8, glen=20_000),  # CPU rehearsal only
}
DIVERGENCE = 0.01
N_READS, READ_LEN, READ_ERR = 100_000, 150, 0.01
N_LONG, LONG_LEN = 500, 10_000
N_REF = 500  # reads also checked against the plain reference (ops/smem_ref.py)
N_DP = 200  # reads for the device sw / hapdiv phase
MIN_LEN = 31
SEED = 20260820
ALPHA = b"$ACGTN"


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# corpus


def make_corpus(out: str, n_genomes: int, glen: int, seed: int, n_reads: int = N_READS, n_long: int = N_LONG, long_len: int = LONG_LEN) -> dict:
    """Seeded pangenome + reads, written as FASTA under `out`.  Haplotypes
    are the base genome with DIVERGENCE substitutions; reads are sampled
    from the base genome with READ_ERR substitutions.  Returns the paths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(ALPHA, np.uint8)
    base = rng.integers(1, 5, glen).astype(np.uint8)
    paths = {k: os.path.join(out, f"{k}.fa") for k in ("genomes", "reads", "long", "dp")}
    with open(paths["genomes"], "wb") as f:
        for i in range(n_genomes):
            s = base.copy()
            mut = rng.random(glen) < DIVERGENCE
            s[mut] = rng.integers(1, 5, int(mut.sum()))
            f.write(b">g%d\n" % i + alpha[s].tobytes() + b"\n")

    def sample(n, ln):
        ln = min(ln, glen)
        st = rng.integers(0, glen - ln + 1, n)
        r = base[st[:, None] + np.arange(ln)]
        err = rng.random(r.shape) < READ_ERR
        return np.where(err, rng.integers(1, 5, r.shape), r).astype(np.uint8)

    def write_reads(path, reads, prefix):
        with open(path, "wb") as f:
            f.write(b"".join(b">%s%d\n" % (prefix, i) + alpha[r].tobytes() + b"\n" for i, r in enumerate(reads)))

    reads = sample(n_reads, READ_LEN)
    write_reads(paths["reads"], reads, b"r")
    write_reads(paths["dp"], reads[:N_DP], b"r")
    write_reads(paths["long"], sample(n_long, long_len), b"L")
    return paths


# ---------------------------------------------------------------------------
# comparators


def parse_bed(data: bytes) -> dict:
    """mem BED -> {read name: [(start, end, size), ...]} in output order."""
    out: dict = {}
    for line in data.decode().splitlines():
        nm, st, en, sz = line.split("\t")[:4]
        out.setdefault(nm, []).append((int(st), int(en), int(sz)))
    return out


def compare_bytes(label: str, got: bytes, want: bytes) -> None:
    """Exact equality; on mismatch report the first differing line."""
    if got == want:
        return
    g, w = got.splitlines(), want.splitlines()
    for i, (a, b) in enumerate(zip(g, w)):
        if a != b:
            raise AssertionError(f"{label}: line {i + 1} differs: {a[:120]!r} != {b[:120]!r}")
    raise AssertionError(f"{label}: {len(g)} lines != {len(w)} lines expected")


def compare_ref(label: str, bed: bytes, f, reads_fa: str, n: int, min_len: int = MIN_LEN) -> int:
    """Check the first n reads of a mem BED against ops/smem_ref.smem_tg
    on the host index `f`.  Returns the number of MEMs checked."""
    from ropebwt3_jax.nt6 import char2nt6
    from ropebwt3_jax.ops import smem_ref
    from ropebwt3_jax.seqio import read_seqs

    got = parse_bed(bed)
    checked = 0
    for i, rec in enumerate(read_seqs(reads_fa)):
        if i == n:
            break
        want = [(m.start, m.end, m.size) for m in smem_ref.smem_tg(f, char2nt6(rec.seq), 1, min_len)]
        if got.get(rec.name, []) != want:
            raise AssertionError(f"{label}: read {rec.name}: {got.get(rec.name, [])[:4]} != reference {want[:4]}")
        checked += len(want)
    return checked


# ---------------------------------------------------------------------------
# running the CLI


class Runner:
    """Runs bin/rb3jax.  Host runs pin JAX_PLATFORMS=cpu; device runs get
    the caller's platform setting back (this process pins itself to the CPU
    so that it never opens the card)."""

    def __init__(self, device_platforms: str | None):
        self.device_platforms = device_platforms

    def env(self, device: bool) -> dict:
        e = dict(os.environ)
        e["RB3JAX_STRICT_EXIT"] = "1"
        e["JAX_LOG_COMPILES"] = "1"  # compile times on stderr (compile_summary)
        if not device:
            e["JAX_PLATFORMS"] = "cpu"
        elif self.device_platforms is None:
            e.pop("JAX_PLATFORMS", None)
        else:
            e["JAX_PLATFORMS"] = self.device_platforms
        return e

    def run(self, args: list[str], device: bool, timeout: float = 1200) -> tuple[bytes, float, str]:
        t0 = time.perf_counter()
        r = subprocess.run(["sh", LAUNCHER] + args, capture_output=True, env=self.env(device), cwd=ROOT, timeout=timeout)
        dt = time.perf_counter() - t0
        err = r.stderr.decode(errors="replace")
        if r.returncode != 0:
            raise RuntimeError(f"`rb3jax {' '.join(args)}` exited {r.returncode}:\n{err[-3000:]}")
        return r.stdout, dt, err


def rate(n: int, secs: float) -> str:
    return f"{secs:.2f} s ({n / secs:,.0f} reads/s)"


_COMPILED = re.compile(r"Finished XLA compilation of (\S+) in ([0-9.]+) sec")


def compile_summary(err: str) -> str:
    """How much of a device run's wall went to XLA compilation, from the
    JAX_LOG_COMPILES lines on its stderr.  A program found in the persistent
    compile cache is logged too, with its load time."""
    progs = [(m.group(1), float(m.group(2))) for m in _COMPILED.finditer(err)]
    if not progs:
        return "no XLA compilation logged"
    name, top = max(progs, key=lambda p: p[1])
    hits = err.count("Persistent compilation cache hit")
    return (f"XLA compile or cache load {sum(t for _, t in progs):.2f} s over {len(progs)} programs "
            f"({hits} cache hits; longest {name} {top:.2f} s)")


# ---------------------------------------------------------------------------
# phases


def device_probe(runner: Runner) -> dict:
    """Phase 1, in a child so this process stays off the card."""
    code = (
        "import json, jax, ropebwt3_jax as r; r._jax_setup(); d = jax.devices(); "
        "print(json.dumps({'platform': d[0].platform, 'kind': d[0].device_kind, 'count': len(d), "
        "'jax': jax.__version__, 'cache': jax.config.jax_compilation_cache_dir}))"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=runner.env(True), cwd=ROOT, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"device probe failed:\n{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def gpu_power_lines() -> list[str]:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def gpu_compute_apps() -> list[str]:
    """Processes holding a context on the card, as nvidia-smi lists them
    (inside a container the listed pids need not be this namespace's)."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def phase_build(runner: Runner, paths: dict, idx: str) -> None:
    _, dt, _ = runner.run(["build", "-m120m", "-do", idx, paths["genomes"]], device=False, timeout=3600)
    log(f"[2 build] {os.path.getsize(idx):,} B FMD in {dt:.2f} s")


def phase_mem(runner: Runner, paths: dict, idx: str, n_reads: int, trace_dir: str | None) -> bytes:
    args = ["mem", f"-l{MIN_LEN}", idx, paths["reads"]]
    want, dt, _ = runner.run(args + ["--engine=native"], device=False)
    log(f"[3 mem] native (CPU backend, first load writes the .dense sidecar): {rate(n_reads, dt)}")
    got, dt, err = runner.run(args + ["--engine=jax"], device=True)
    compare_bytes("mem --engine=jax (cold)", got, want)
    log(f"[3 mem] jax first run: {rate(n_reads, dt)}, byte-equal; {compile_summary(err)}")
    got, dt, err = runner.run(args + ["--engine=jax"], device=True)
    compare_bytes("mem --engine=jax (warm)", got, want)
    log(f"[3 mem] jax second run: {rate(n_reads, dt)}, byte-equal; {compile_summary(err)}")
    got, dt, _ = runner.run(args + ["--engine=hybrid"], device=True)
    compare_bytes("mem --engine=hybrid", got, want)
    log(f"[3 mem] hybrid: {rate(n_reads, dt)}, byte-equal")
    from ropebwt3_jax.cli import load_index

    t0 = time.perf_counter()
    n = compare_ref("mem --engine=jax vs smem_ref", got, load_index(idx), paths["reads"], N_REF)
    log(f"[3 mem] first {N_REF} reads equal to ops/smem_ref.py ({n} MEMs, {time.perf_counter() - t0:.2f} s)")
    if trace_dir:
        smem_trace(runner, idx, paths["reads"], trace_dir)
    return want


def smem_trace(runner: Runner, idx: str, reads_fa: str, out: str) -> None:
    """Profiler trace of the device mem engine (a child process): FSM steps
    and loop trips per dispatch, device time per step (scripts/smem_trace.py)."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "smem_trace.py"), idx, reads_fa, out, f"-l{MIN_LEN}"],
        capture_output=True, text=True, env=runner.env(True), cwd=ROOT, timeout=1200,
    )
    if r.returncode != 0:
        raise RuntimeError(f"smem trace failed:\n{r.stderr[-3000:]}")
    for ln in r.stdout.strip().splitlines():
        log(f"[3 trace] {ln}")


def phase_long(runner: Runner, paths: dict, idx: str, n_long: int, long_len: int) -> None:
    args = ["mem", f"-l{MIN_LEN}", idx, paths["long"]]
    want, dt_n, _ = runner.run(args + ["--engine=native"], device=False)
    got, dt, err = runner.run(args + ["--engine=jax"], device=True)
    compare_bytes("long reads --engine=jax", got, want)
    log(f"[4 long] {n_long} x {long_len} bp: jax {rate(n_long, dt)} vs native {dt_n:.2f} s, byte-equal; {compile_summary(err)}")


def phase_rb(runner: Runner, paths: dict, idx: str, want: bytes, n_reads: int) -> None:
    got, dt, err = runner.run(["mem", f"-l{MIN_LEN}", "--engine=jax", "--occ=rb", idx, paths["reads"]], device=True)
    compare_bytes("mem --engine=jax --occ=rb", got, want)
    log(f"[5 rb] occ=rb (first use builds the .rb.npz rows): {rate(n_reads, dt)}, byte-equal; {compile_summary(err)}")


def phase_dp(runner: Runner, paths: dict, idx: str) -> None:
    for cmd in (["sw", "-N25", "--no-ssa"], ["hapdiv", "-a101"]):
        args = cmd + [idx, paths["dp"]]
        want, dt_n, _ = runner.run(args + ["--engine=native"], device=False)
        got, dt, err = runner.run(args + ["--engine=jax"], device=True)
        compare_bytes(f"{cmd[0]} --engine=jax", got, want)
        log(f"[6 dp] {' '.join(cmd)}: jax {rate(N_DP, dt)} vs native {dt_n:.2f} s, byte-equal; {compile_summary(err)}")


def phase_serve(runner: Runner, paths: dict, idx: str, want: bytes, n_reads: int, check_apps: bool = True) -> None:
    from ropebwt3_jax.server import log_path, server_available

    t0 = time.perf_counter()
    with open(os.path.join(os.path.dirname(idx), "serve.log"), "wb") as lf:
        srv = subprocess.Popen(["sh", LAUNCHER, "serve", f"--warm={MIN_LEN}:{READ_LEN}", idx], stdout=lf, stderr=subprocess.STDOUT, env=runner.env(True), cwd=ROOT)
    try:
        while not server_available(idx):
            if srv.poll() is not None:
                raise RuntimeError(f"serve exited {srv.returncode}: {open(lf.name, 'rb').read()[-3000:]!r}")
            if time.perf_counter() - t0 > 900:
                raise RuntimeError("serve did not come up within 900 s")
            time.sleep(1)
        log(f"[7 serve] server up (index load + warm-up compiles) in {time.perf_counter() - t0:.2f} s")
        if check_apps:
            apps = gpu_compute_apps()
            if len(apps) != 1:
                raise AssertionError(f"with only the server up the card lists {apps}")
        for i in range(2):
            # the client gets the ambient device environment: only the
            # launcher's own host-only pin (JAX_PLATFORMS=cpu) keeps it off
            # the card.  Sample the card's process list while it runs: still
            # one (output goes to files: a full pipe would stall the client
            # while this loop polls)
            t1 = time.perf_counter()
            out_path, err_path = (os.path.join(os.path.dirname(idx), f"client{i + 1}.{x}") for x in ("bed", "err"))
            with open(out_path, "wb") as fo, open(err_path, "wb") as fe:
                cl = subprocess.Popen(["sh", LAUNCHER, "mem", f"-l{MIN_LEN}", idx, paths["reads"]], stdout=fo,
                                      stderr=fe, env=runner.env(True), cwd=ROOT)
            most = []
            while check_apps and cl.poll() is None:
                apps = gpu_compute_apps()
                most = apps if len(apps) > len(most) else most
                time.sleep(0.2)
            cl.wait(timeout=1200)
            dt = time.perf_counter() - t1
            with open(out_path, "rb") as fo, open(err_path, "rb") as fe:
                got, err = fo.read(), fe.read()
            if cl.returncode != 0:
                raise RuntimeError(f"client request {i + 1} exited {cl.returncode}:\n{err.decode()[-2000:]}")
            if b"served by resident engine" not in err:
                raise AssertionError(f"client request {i + 1} did not reach the server:\n{err.decode()[-2000:]}")
            compare_bytes(f"served mem request {i + 1}", got, want)
            if check_apps and len(most) > 1:
                raise AssertionError(f"a client opened the card: {most}")
            log(f"[7 serve] client request {i + 1}: {rate(n_reads, dt)}, byte-equal"
                + (f"; card processes while it ran: {len(most) or 1} ({'; '.join(most or apps)})" if check_apps else ""))
    finally:
        subprocess.run(["sh", LAUNCHER, "serve", "--stop", idx], capture_output=True, env=runner.env(False), cwd=ROOT, timeout=120)
        try:
            srv.wait(timeout=120)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        if os.path.exists(log_path(idx)):
            os.unlink(log_path(idx))


def phase_four_cards(runner: Runner, paths: dict, idx: str, n_reads: int) -> None:
    args = ["mem", f"-l{MIN_LEN}", idx, paths["reads"]]
    want, dt, _ = runner.run(args + ["--engine=native"], device=False)
    log(f"[8 mesh] native (CPU backend): {rate(n_reads, dt)}")
    for extra in (["--mesh=4x1"], ["--mesh=1x4"], ["--mesh=1x4", "--occ=rb"]):
        got, dt, err = runner.run(args + ["--engine=jax"] + extra, device=True)
        compare_bytes(f"mem {' '.join(extra)}", got, want)
        log(f"[8 mesh] {' '.join(extra)}: {rate(n_reads, dt)}, byte-equal; {compile_summary(err)}")


def run_phases(work: str, shape: str, seed: int, runner: Runner, four_cards: bool = False, trace_dir: str | None = None, check_apps: bool = True) -> None:
    """Phases 2-8 in `work` (phase 1 is the caller's).  Raises on any
    failure."""
    cfg = SHAPES[shape]
    t0 = time.perf_counter()
    small = shape == "tiny"
    n_reads, n_long, long_len = (2000, 20, 3000) if small else (N_READS, N_LONG, LONG_LEN)
    paths = make_corpus(work, cfg["n_genomes"], cfg["glen"], seed, n_reads=n_reads, n_long=n_long, long_len=long_len)
    log(f"[2 corpus] {shape}: {cfg['n_genomes']} x {cfg['glen']:,} bp at {DIVERGENCE:.0%} divergence "
        f"({2 * cfg['n_genomes'] * (cfg['glen'] + 1):,} symbols), {n_reads:,} x {READ_LEN} bp reads, seed {seed}: "
        f"{time.perf_counter() - t0:.2f} s")
    idx = os.path.join(work, "idx.fmd")
    phase_build(runner, paths, idx)
    if four_cards:
        phase_four_cards(runner, paths, idx, n_reads)
        return
    want = phase_mem(runner, paths, idx, n_reads, trace_dir)
    phase_long(runner, paths, idx, n_long, long_len)
    phase_rb(runner, paths, idx, want, n_reads)
    phase_dp(runner, paths, idx)
    phase_serve(runner, paths, idx, want, n_reads, check_apps=check_apps)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true", help="only the --mesh runs, on four cards")
    ap.add_argument("--trace", metavar="DIR", help="also trace the device mem engine, writing the trace and summary.json to DIR")
    ap.add_argument("--shape", choices=["mtb152", "s640"], default="mtb152", help="corpus shape (default: mtb152)")
    a = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "ropebwt3_jax")) or not os.path.exists(LAUNCHER):
        print("chip_smoke.py: the ropebwt3_jax checkout is not next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    runner = Runner(os.environ.get("JAX_PLATFORMS") or None)
    os.environ["JAX_PLATFORMS"] = "cpu"  # this process never opens the card
    t_all = time.perf_counter()
    dev = device_probe(runner)
    if dev["platform"] != "gpu":
        print(f"chip_smoke.py: JAX found no GPU (platform {dev['platform']!r}); nothing was run", file=sys.stderr)
        return 1
    want_count = 4 if a.four_cards else 1
    if dev["count"] < want_count:
        print(f"chip_smoke.py: {dev['count']} GPU(s), {want_count} needed", file=sys.stderr)
        return 1
    power = gpu_power_lines()
    log(f"[1 device] {dev['kind']} x{dev['count']} ({dev['platform']}), jax {dev['jax']}, compile cache {dev['cache']}, "
        f"host CPU cores {os.cpu_count()}")
    for ln in power:
        log(f"[1 device] nvidia-smi name, power.limit: {ln}")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.environ.get("TMPDIR"))
    trace_dir = os.path.abspath(a.trace) if a.trace else None
    try:
        run_phases(work, a.shape, SEED, runner, four_cards=a.four_cards, trace_dir=trace_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.2f} s on {power[0]}")
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
