#!/usr/bin/env python
"""Randomized differential testing: run random command/flag combinations on
random corpora under both rb3jax and the reference binary and diff stdout.

Usage: python scripts/fuzz_diff.py [n_iters] [seed0]

Every iteration builds a fresh random corpus (with edge cases: N runs, empty
and 1-bp sequences, lowercase, line mode) via the REFERENCE binary, then picks
several random query/util invocations and requires byte-identical stdout.
FMR outputs are compared logically (tree shape is history-dependent).
"""

from __future__ import annotations

import os
import random
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF_BIN = "/tmp/rb3_ref_bin/ropebwt3"

ENV = dict(os.environ)
ENV["PYTHONPATH"] = ""
ENV["JAX_PLATFORMS"] = "cpu"
ENV["RB3JAX_CACHE"] = "0"
# 4 virtual CPU devices so --mesh scenarios (up to 2x2) can run
ENV["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4").strip()


TIMEOUT = 600  # a hang is a bug (fa2kmer -w<0 spun forever, fuzz seed 10141)


def run_ref(args, input=None):
    try:
        r = subprocess.run([REF_BIN] + args, input=input, capture_output=True, timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        return -99, b"", b"TIMEOUT"
    return r.returncode, r.stdout, r.stderr


def run_ours(args, input=None):
    try:
        r = subprocess.run(
            [sys.executable, "-m", "ropebwt3_jax"] + args,
            input=input, capture_output=True, env=ENV, cwd=ROOT, timeout=TIMEOUT,
        )
    except subprocess.TimeoutExpired:
        return -99, b"", b"TIMEOUT (hang)"
    return r.returncode, r.stdout, r.stderr


def rand_seq(rng: random.Random, n: int, p_n=0.0) -> str:
    s = []
    for _ in range(n):
        if p_n and rng.random() < p_n:
            s.append(rng.choice("NnX-"))
        else:
            s.append(rng.choice("ACGTacgt" if rng.random() < 0.2 else "ACGT"))
    return "".join(s)


def make_corpus(rng: random.Random, d: str):
    """Random genomes (with mutated copies) + reads; returns paths."""
    n_g = rng.randint(1, 6)
    base_len = rng.randint(40, 3000)
    base = rand_seq(rng, base_len, p_n=0.02 if rng.random() < 0.3 else 0.0)
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        for i in range(n_g):
            s = list(base)
            for j in range(len(s)):
                if rng.random() < 0.02:
                    s[j] = rng.choice("ACGT")
            if rng.random() < 0.15:  # occasional odd sequences
                extra = rng.choice(["", "A", "N", rand_seq(rng, 5)])
                s = list(extra) + s
            f.write(f">g{i} desc{i}\n")
            body = "".join(s)
            # random line wrapping
            w = rng.choice([0, 60, 7])
            if w:
                for k in range(0, len(body), w):
                    f.write(body[k : k + w] + "\n")
            else:
                f.write(body + "\n")
    reads = os.path.join(d, "r.fa")
    n_r = rng.randint(1, 30)
    fastq = rng.random() < 0.3
    with open(reads, "w") as f:
        for i in range(n_r):
            ln = rng.randint(1, min(len(base), 200))
            st = rng.randint(0, len(base) - ln)
            r = list(base[st : st + ln])
            for j in range(len(r)):
                if rng.random() < 0.03:
                    r[j] = rng.choice("ACGTN")
            body = "".join(r)
            if fastq:
                f.write(f"@r{i}\n{body}\n+\n{'I' * len(body)}\n")
            else:
                f.write(f">r{i}\n{body}\n")
    return fa, reads


def build_indexes(rng: random.Random, d: str, fa: str):
    fmd = os.path.join(d, "idx.fmd")
    rc, _, err = run_ref(["build", "-do", fmd, fa])
    assert rc == 0, err.decode()
    rc, _, err = run_ref(["ssa", "-o", fmd + ".ssa", "-s", str(rng.choice([2, 4, 8])), fmd])
    assert rc == 0, err.decode()
    import gzip

    with gzip.open(fmd + ".len.gz", "wt") as f:
        name, ln = None, 0
        for line in open(fa):
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    f.write(f"{name}\t{ln}\n")
                name, ln = line[1:].split()[0], 0
            else:
                ln += len(line)
        if name is not None:
            f.write(f"{name}\t{ln}\n")
    return fmd


def _maybe_junk(rng: random.Random, argv: list[str]) -> list[str]:
    """Occasionally inject an unknown flag: the reference's ketopt silently
    skips unknown options in most commands but main_search/fa2kmer abort with
    'ERROR: unknown option' — both behaviors are part of the CLI contract."""
    if rng.random() < 0.15:
        junk = rng.choice(["-Z", "-q9", "--bogus", "--zzz=1"])
        pos = rng.randrange(1, len(argv))
        argv = argv[:pos] + [junk] + argv[pos:]
    return argv


def scenarios(rng: random.Random, fmd: str, fa: str, reads: str):
    """Yield argv lists exercising random flag combinations."""
    mem = ["mem", "-l", str(rng.choice([1, 5, 10, 19, 31])), "-c", str(rng.choice([1, 1, 2, 5]))]
    if rng.random() < 0.3:
        mem += ["--old-mem"]
    if rng.random() < 0.2:
        mem += ["--gap=" + str(rng.choice([1, 10, 50]))]
    elif rng.random() < 0.2:
        mem += ["--cov"]
    elif rng.random() < 0.4:
        mem += ["-p", str(rng.choice([1, 3, 7]))]
    r_eng = rng.random()
    if r_eng < 0.25:
        # exercise the batched-lane kernel (and sometimes the sharded mesh)
        # on the CPU backend — tiny corpora keep the lock-step loop cheap
        mem += ["--engine=jax"]
        if rng.random() < 0.5:
            mem += ["--mesh=" + rng.choice(["2x1", "2x2", "1x2"])]
    elif r_eng < 0.4:
        mem += ["--engine=hybrid"]  # device + native concurrent split
    yield mem + [fmd, reads]

    sw = ["sw"]
    for flag, vals in (("-N", [5, 25, 50]), ("-m", [10, 30]), ("-A", [1, 2]), ("-B", [3, 5]), ("-O", [5, 3]), ("-E", [2, 1]), ("-k", [1, 7, 11]), ("-j", [0, 10])):
        if rng.random() < 0.4:
            sw += [flag, str(rng.choice(vals))]
    if rng.random() < 0.25:
        sw += ["-e"]
    if rng.random() < 0.25:
        sw += ["-u"]
    if rng.random() < 0.25:
        sw += ["--seq"]
    if rng.random() < 0.25:
        sw += ["-y", str(rng.choice([0, 5]))]
    if rng.random() < 0.3:
        sw += ["-p", str(rng.choice([1, 5]))]
    mode = rng.random()
    if mode < 0.2:
        sw += ["--all-e2e"]
        if rng.random() < 0.5:
            sw += ["-b"]
    elif mode < 0.3:
        sw += ["-g", str(rng.choice([1, 3]))]
    if rng.random() < 0.25:
        # device sw scoring + host backtrack (align/sw_jax.py) on the CPU
        # backend; ineligible/flagged reads fall back to the host engine
        sw += ["--engine=jax"]
    yield sw + [fmd, reads]

    hd = ["hapdiv", "-a", str(rng.choice([31, 51, 101])), "-w", str(rng.choice([10, 50]))]
    if rng.random() < 0.25:
        hd += ["--engine=" + rng.choice(["jax", "hybrid"])]
    if rng.random() < 0.5:
        yield hd + [fmd, reads]
    if rng.random() < 0.5:
        yield ["suffix", fmd, reads]
    if rng.random() < 0.5:
        yield ["stat", fmd]
    if rng.random() < 0.5:
        yield ["get", fmd, "0", "1"]
    if rng.random() < 0.3:
        yield ["kount", "-k", str(rng.choice([11, 17, 51])), "-m", str(rng.choice([1, 2, 100])), fmd]
    if rng.random() < 0.3:
        yield ["fa2kmer", "-k", str(rng.choice([31, 151])), "-w", str(rng.choice([10, 50])), reads]
    if rng.random() < 0.3:
        yield ["fa2line", reads]
    if rng.random() < 0.3:
        yield ["build", "-LR" if rng.random() < 0.5 else "-L", fa]  # plain BWT out (fa here is multi-line: use -L only on reads)


def build_scenarios(rng: random.Random, d: str, fa: str, reads: str):
    """Construction invocations (exercise OUR builder, not just queries)."""
    strand = rng.choice(["", "-F", "-R"])
    base = ["build"] + ([strand] if strand else [])
    yield base + [fa]  # plain BWT to stdout
    if rng.random() < 0.5:
        yield base + ["-m", str(rng.choice([100, 500, 2000])), fa]  # multi-batch merge path
    if rng.random() < 0.4:
        # legacy sort orders: ours -s/-r must match reference -2s/-2r
        o = rng.choice(["-s", "-r"])
        ours_fmd = os.path.join(d, "o_sort.fmd")
        ref_fmd = os.path.join(d, "r_sort.fmd")
        rc_o, _, err_o = run_ours(["build", o, "-do", ours_fmd, fa])
        rc_r, _, _ = run_ref(["build", "-2" + o[1], "-do", ref_fmd, fa])
        if rc_r == 0:
            if rc_o != 0:
                yield ("FAIL", f"build {o} crashed: {err_o.decode()[-500:]}")
            elif open(ours_fmd, "rb").read() != open(ref_fmd, "rb").read():
                yield ("FAIL", f"build {o} FMD bytes differ")
    if rng.random() < 0.4:
        # our FMD build + our BRE build vs reference bytes
        for fmt, ext in (("-d", "fmd"), ("-e", "bre")):
            ours_f = os.path.join(d, f"o.{ext}")
            ref_f = os.path.join(d, f"r.{ext}")
            rc_o, _, err_o = run_ours(["build", fmt + "o", ours_f, fa])
            rc_r, _, _ = run_ref(["build", fmt + "o", ref_f, fa])
            if rc_r == 0:
                if rc_o != 0:
                    yield ("FAIL", f"build {fmt} crashed: {err_o.decode()[-500:]}")
                elif open(ours_f, "rb").read() != open(ref_f, "rb").read():
                    yield ("FAIL", f"build {fmt} bytes differ")
    if rng.random() < 0.3:
        # incremental: build reads on top of fa index (ours) vs one-shot ref
        ours_fmr = os.path.join(d, "o1.fmr")
        rc_o, _, err_o = run_ours(["build", "-bo", ours_fmr, fa])
        rc_o2, out_o, err_o2 = run_ours(["build", "-i", ours_fmr, reads])
        # reference equivalent: build fa then -i reads, plain output
        ref_fmr = os.path.join(d, "r1.fmr")
        run_ref(["build", "-bo", ref_fmr, fa])
        rc_r, out_r, _ = run_ref(["build", "-i", ref_fmr, reads])
        if rc_r == 0 and (rc_o or rc_o2):
            yield ("FAIL", f"build -i crashed: {(err_o + err_o2).decode()[-500:]}")
        elif rc_r == 0 and out_o != out_r:
            yield ("FAIL", "build -i plain BWT differs")


def server_scenario(rng: random.Random, fmd: str, reads: str) -> list[str]:
    """Route mem through a resident `serve` process (CPU backend) and
    byte-compare with the reference — the socket path the CLI auto-routes to
    (server.sock_path) is sha1(realpath(index))[:12] under $TMPDIR."""
    import hashlib
    import time

    h = hashlib.sha1(os.path.realpath(fmd).encode()).hexdigest()[:12]
    sock = os.path.join(tempfile.gettempdir(), f"rb3jax-serve-{h}.sock")
    fails = []
    srv = subprocess.Popen(
        [sys.executable, "-m", "ropebwt3_jax", "serve", fmd],
        env=ENV, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        for _ in range(600):  # CPU warm takes seconds; compile noise allowed
            if os.path.exists(sock):
                break
            if srv.poll() is not None:
                return [f"SERVER-DIED rc={srv.returncode}"]
            time.sleep(0.2)
        else:
            return ["SERVER-TIMEOUT (socket never appeared)"]
        time.sleep(0.3)  # listener binds before printing ready; settle
        for _ in range(2):
            args = ["mem", "-l", str(rng.choice([1, 13, 31])), "-c", str(rng.choice([1, 2])), fmd, reads]
            rc_r, out_r, _ = run_ref(args)
            rc_o, out_o, err_o = run_ours(args)
            if rc_r != 0:
                continue
            if rc_o != 0:
                fails.append(f"SERVER-ROUTED CRASH {' '.join(args)}\n{err_o.decode()[-1000:]}")
            elif out_r != out_o:
                fails.append(f"SERVER-ROUTED DIFF {' '.join(args)}")
            elif b"[server]" not in err_o and b"routed" not in err_o:
                # the whole point of this scenario is server-routed coverage:
                # a silent fallback to the in-process path must not pass as
                # "server tested" (advisor round 3)
                fails.append(f"SERVER-NOT-ROUTED {' '.join(args)} (no route marker in stderr)")
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=10)
        except Exception:
            srv.kill()
    return fails


def one_iter(seed: int) -> list[str]:
    rng = random.Random(seed)
    fails = []
    d = tempfile.mkdtemp(prefix=f"fuzz{seed}_")
    try:
        fa, reads = make_corpus(rng, d)
        fmd = build_indexes(rng, d, fa)
        if rng.random() < 0.2:
            fails += [f"seed={seed} {m}" for m in server_scenario(rng, fmd, reads)]
        for item in build_scenarios(rng, d, fa, reads):
            if isinstance(item, tuple) and item[0] == "FAIL":
                keep = os.path.join("/tmp", f"fuzz_fail_{seed}")
                shutil.copytree(d, keep, dirs_exist_ok=True)
                fails.append(f"seed={seed} {item[1]} (kept in {keep})")
                continue
            args = list(item)
            rc_r, out_r, err_r = run_ref(args)
            rc_o, out_o, err_o = run_ours(args)
            if rc_r != 0:
                continue
            if rc_o != 0:
                fails.append(f"seed={seed} OURS-CRASHED {' '.join(args)}\n{err_o.decode()[-2000:]}")
            elif out_r != out_o:
                keep = os.path.join("/tmp", f"fuzz_fail_{seed}")
                shutil.copytree(d, keep, dirs_exist_ok=True)
                open(os.path.join(keep, "ref_b.out"), "wb").write(out_r)
                open(os.path.join(keep, "ours_b.out"), "wb").write(out_o)
                fails.append(f"seed={seed} DIFF {' '.join(args)} (kept in {keep})")
        for args in scenarios(rng, fmd, fa, reads):
            if args[0] == "build" and "-L" in args[1]:
                continue  # line-mode build on FASTA input is not meaningful
            args = _maybe_junk(rng, args)
            # rb3jax-only extension flags: stripped from the reference argv
            # (its strict ketopt would abort on them by design)
            ref_args = [a for a in args if not a.startswith(("--engine", "--mesh"))]
            rc_r, out_r, err_r = run_ref(ref_args)
            rc_o, out_o, err_o = run_ours(args)
            if rc_r != 0:
                continue  # reference exits 0 even on errors (main.c:46-82); nonzero = crash, skip
            if rc_o != 0:
                fails.append(f"seed={seed} OURS-CRASHED {' '.join(args)}\n{err_o.decode()[-2000:]}")
                continue
            if out_r != out_o:
                keep = os.path.join("/tmp", f"fuzz_fail_{seed}")
                shutil.copytree(d, keep, dirs_exist_ok=True)
                open(os.path.join(keep, "ref.out"), "wb").write(out_r)
                open(os.path.join(keep, "ours.out"), "wb").write(out_o)
                fails.append(f"seed={seed} DIFF {' '.join(args)} (kept in {keep})")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return fails


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    all_fails = []
    for i in range(n):
        fails = one_iter(seed0 + i)
        tag = "FAIL" if fails else "ok"
        print(f"[fuzz] iter {seed0 + i}: {tag}", flush=True)
        all_fails += fails
    if all_fails:
        print("\n".join(all_fails))
        sys.exit(1)
    print(f"[fuzz] {n} iterations clean")


if __name__ == "__main__":
    main()
