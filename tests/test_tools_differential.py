"""Machine-checked differential for the rb3tools port: the production port
(ropebwt3_jax/tools.py, idiomatic Python, round 2) must byte-match the
literal JS transliteration oracle (tests/js_oracle.py) on BOTH real
reference --all-e2e output and randomized synthetic streams covering every
branch (cs-op mix, gced overflow, score ties at the cutoff, cross-contig
windows, conflict resolution, multi-allele VCFs).  Replaces the round-3
hand-traced fixtures' parity-by-assertion (VERDICT r3 missing-item 3)."""

import random
import subprocess
import sys

import pytest

from . import js_oracle as JS
from .test_tools import e2e_file  # noqa: F401  (fixture reuse)


def _run_tools(args, input=None):
    r = subprocess.run([sys.executable, "-m", "ropebwt3_jax.tools"] + args, input=input, capture_output=True)
    assert r.returncode == 0, r.stderr.decode()
    return r.stdout.decode()


# ---------------------------------------------------------------------------
# real-data differential
# ---------------------------------------------------------------------------


def test_real_e2e_all_tools(e2e_file):  # noqa: F811
    text = open(e2e_file).read()
    assert _run_tools(["call", "100", str(e2e_file)]) == JS.call(text, 100)
    assert _run_tools(["call", "3", "-a2", "-r20", "-d3", "-1", "-c", str(e2e_file)]) == JS.call(
        text, 3, ambi_range=2, drop_score=20, max_gced=3, keep_supp1=True, flag_conflict=True
    )
    assert _run_tools(["mapflt", "1", str(e2e_file)]) == JS.mapflt(text, 1)
    assert _run_tools(["mapflt", "5", "-d2", "-g10", str(e2e_file)]) == JS.mapflt(text, 5, max_diff=2, gap_size=10)
    assert _run_tools(["mapflt2", "2", str(e2e_file), str(e2e_file)]) == JS.mapflt2(text, text, 2)
    assert _run_tools(["uniqmer", str(e2e_file)]) == JS.uniqmer(text)
    assert _run_tools(["uniqmer", "-d3", "-e2", "-E50", str(e2e_file)]) == JS.uniqmer(
        text, within_diff=3, min_exact=2, max_exact=50
    )


# ---------------------------------------------------------------------------
# randomized synthetic streams
# ---------------------------------------------------------------------------

_BASES = "ACGT"


def _rand_cs(rng: random.Random, k: int) -> str:
    """cs string consuming exactly k query positions (like real --all-e2e
    output; a shorter/longer walk would push end_dist below -1 and hit the
    JS's own 'Bug!' throw in the conflict resolver)."""
    ops = []
    left = k
    while left > 12:
        c = rng.random()
        if c < 0.5:
            ln = rng.randrange(1, min(40, left - 8))
            ops.append(f":{ln}")
            left -= ln
        elif c < 0.8:
            a, b = rng.choice("acgt"), rng.choice("acgt")
            ops.append(f"*{a}{b}")
            left -= 1
        elif c < 0.9:
            s = "".join(rng.choice("acgt") for _ in range(rng.randrange(1, min(4, left - 8))))
            ops.append(f"+{s}")
            left -= len(s)
        else:
            s = "".join(rng.choice("acgt") for _ in range(rng.randrange(1, 4)))
            ops.append(f"-{s}")
    ops.append(f":{left}")
    return "".join(ops)


def _rand_e2e(rng: random.Random, n_win: int = 25) -> str:
    lines = []
    st = rng.randrange(1, 50)
    ctg = f"chr{rng.randrange(1, 3)}"
    for _ in range(n_win):
        if rng.random() < 0.1:
            ctg = f"chr{rng.randrange(1, 4)}"
            st = rng.randrange(1, 50)
        k = rng.choice([60, 101])
        en = st + k - 1
        lines.append(f"QS\t{ctg}:{st}-{en}\tACGT")
        scores = sorted((rng.randrange(20, 102) for _ in range(rng.randrange(0, 6))), reverse=True)
        if rng.random() < 0.25 and scores:  # score ties at the cutoff
            scores += [scores[-1]] * rng.randrange(1, 3)
        for sc in scores:
            cnt = rng.randrange(1, 30)
            ed = rng.randrange(0, 8)
            lines.append(f"QH\t{cnt}\t{sc}\t{ed}\t{_rand_cs(rng, k)}")
        lines.append("//")
        st += rng.choice([25, 50, 50, 120])  # overlapping and gapped tiles
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(12))
def test_random_call(tmp_path, seed):
    rng = random.Random(seed)
    text = _rand_e2e(rng)
    p = tmp_path / "r.e2e"
    p.write_text(text)
    max_hap = rng.choice([1, 3, 25])
    args = ["call", str(max_hap)]
    kw = {}
    if rng.random() < 0.5:
        kw["ambi_range"] = rng.randrange(0, 8)
        args += [f"-a{kw['ambi_range']}"]
    if rng.random() < 0.5:
        kw["max_gced"] = rng.randrange(0, 6)
        args += [f"-d{kw['max_gced']}"]
    if rng.random() < 0.4:
        kw["keep_supp1"] = True
        args += ["-1"]
    if rng.random() < 0.4:
        kw["flag_conflict"] = True
        args += ["-c"]
    got = _run_tools(args + [str(p)])
    want = JS.call(text, max_hap, **kw)
    assert got == want, f"seed={seed}"


@pytest.mark.parametrize("seed", range(8))
def test_random_mapflt(tmp_path, seed):
    rng = random.Random(1000 + seed)
    text = _rand_e2e(rng)
    p = tmp_path / "r.e2e"
    p.write_text(text)
    mh, md, gs = rng.choice([1, 2, 10]), rng.randrange(0, 8), rng.choice([0, 10, 50])
    got = _run_tools(["mapflt", str(mh), f"-d{md}", f"-g{gs}", str(p)])
    assert got == JS.mapflt(text, mh, max_diff=md, gap_size=gs), f"seed={seed}"


@pytest.mark.parametrize("seed", range(8))
def test_random_mapflt2(tmp_path, seed):
    rng = random.Random(2000 + seed)
    # paired streams share coordinates (the JS raises otherwise)
    coords = []
    st, ctg = 1, "chr1"
    for _ in range(20):
        if rng.random() < 0.1:
            ctg, st = f"chr{rng.randrange(1, 4)}", rng.randrange(1, 50)
        coords.append((ctg, st, st + 100))
        st += rng.choice([25, 50, 150])

    def stream(r2: random.Random) -> str:
        lines = []
        for ctg, st, en in coords:
            lines.append(f"QS\t{ctg}:{st}-{en}\tACGT")
            for _ in range(r2.randrange(0, 5)):
                lines.append(f"QH\t{r2.randrange(1, 20)}\t{r2.randrange(60, 102)}\t{r2.randrange(0, 9)}\t:101")
            lines.append("//")
        return "\n".join(lines) + "\n"

    ref_t, pan_t = stream(random.Random(seed * 7 + 1)), stream(random.Random(seed * 7 + 2))
    pr, pp = tmp_path / "ref.e2e", tmp_path / "pan.e2e"
    pr.write_text(ref_t)
    pp.write_text(pan_t)
    mh, mr, mp = rng.choice([1, 2, 8]), rng.randrange(0, 5), rng.randrange(3, 9)
    got = _run_tools(["mapflt2", str(mh), f"-r{mr}", f"-p{mp}", str(pr), str(pp)])
    assert got == JS.mapflt2(ref_t, pan_t, mh, max_rdiff=mr, max_pdiff=mp), f"seed={seed}"


@pytest.mark.parametrize("seed", range(8))
def test_random_getsnp(tmp_path, seed):
    rng = random.Random(3000 + seed)
    lines = ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    names = ["chr1", "chr22", "chrX", "12", "scaffold_3", "chrM"]
    for _ in range(40):
        ref = "".join(rng.choice(_BASES) for _ in range(rng.randrange(1, 4)))
        alts = []
        for _ in range(rng.randrange(1, 3)):
            if rng.random() < 0.6:  # same-length (SNP-ish, possibly multi-mismatch)
                alts.append("".join(rng.choice(_BASES) for _ in range(len(ref))))
            else:
                alts.append("".join(rng.choice(_BASES) for _ in range(rng.randrange(1, 5))))
        lines.append(f"{rng.choice(names)}\t{rng.randrange(1, 9999)}\t.\t{ref}\t{','.join(alts)}\t60\tPASS\t.")
    text = "\n".join(lines) + "\n"
    p = tmp_path / "x.vcf"
    p.write_text(text)
    got = _run_tools(["getsnp", str(p)])
    assert got == JS.getsnp(text), f"seed={seed}"
    got_a = _run_tools(["getsnp", "-a", str(p)])
    assert got_a == JS.getsnp(text, auto_only=True), f"seed={seed}"


@pytest.mark.parametrize("seed", range(8))
def test_random_uniqmer(tmp_path, seed):
    rng = random.Random(4000 + seed)
    lines = []
    for i in range(30):
        lines.append(f"QS\tkmer{i}\tACGT")
        for _ in range(rng.randrange(0, 4)):
            lines.append(f"QH\t{rng.randrange(0, 60)}\t{rng.randrange(60, 102)}\t{rng.randrange(0, 7)}\t:101")
        lines.append("//")
    text = "\n".join(lines) + "\n"
    p = tmp_path / "u.e2e"
    p.write_text(text)
    d, e, E = rng.randrange(0, 8), rng.choice([-1, 1, 3]), rng.choice([-1, 5, 40])
    args = ["uniqmer", f"-d{d}"]
    if e > 0:
        args.append(f"-e{e}")
    if E > 0:
        args.append(f"-E{E}")
    got = _run_tools(args + [str(p)])
    assert got == JS.uniqmer(text, within_diff=d, min_exact=e if e > 0 else -1, max_exact=E if E > 0 else -1), f"seed={seed}"
