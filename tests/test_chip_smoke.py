"""chip_smoke.py without a GPU: its corpus generator and comparators, and
that it refuses to run (non-zero exit, no result line) when JAX finds no
GPU or when it stands alone without the checkout.  Its device phases run
only on the card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _fasta(path):
    recs, name = {}, None
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            name = line[1:]
        else:
            recs[name] = line
    return recs


def test_corpus_is_seeded_and_shaped(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    pa = cs.make_corpus(str(a), 5, 3000, seed=3, n_reads=40, n_long=3, long_len=1200)
    pb = cs.make_corpus(str(b), 5, 3000, seed=3, n_reads=40, n_long=3, long_len=1200)
    for k in pa:
        assert open(pa[k], "rb").read() == open(pb[k], "rb").read(), k
    g = _fasta(pa["genomes"])
    assert list(g) == [f"g{i}" for i in range(5)] and all(len(s) == 3000 for s in g.values())
    # haplotypes differ from each other at about DIVERGENCE
    d = np.mean([x != y for x, y in zip(g["g0"], g["g1"])])
    assert 0.5 * cs.DIVERGENCE < d < 4 * cs.DIVERGENCE
    r = _fasta(pa["reads"])
    assert len(r) == 40 and all(len(s) == cs.READ_LEN for s in r.values())
    assert set("".join(r.values())) <= set("ACGT")
    assert list(_fasta(pa["dp"]).items()) == list(r.items())[: cs.N_DP]
    lr = _fasta(pa["long"])
    assert len(lr) == 3 and all(len(s) == 1200 for s in lr.values())


def test_corpus_seed_changes_data(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    pa = cs.make_corpus(str(a), 2, 2000, seed=1, n_reads=5, n_long=1, long_len=500)
    pb = cs.make_corpus(str(b), 2, 2000, seed=2, n_reads=5, n_long=1, long_len=500)
    assert open(pa["genomes"], "rb").read() != open(pb["genomes"], "rb").read()


def test_parse_bed_keeps_order():
    bed = b"r1\t0\t40\t3\nr1\t30\t90\t1\nr2\t5\t60\t8\n"
    assert cs.parse_bed(bed) == {"r1": [(0, 40, 3), (30, 90, 1)], "r2": [(5, 60, 8)]}


@pytest.mark.parametrize(
    "got, want, msg",
    [
        (b"a\nb\n", b"a\nb\n", None),
        (b"a\nc\n", b"a\nb\n", "line 2 differs"),
        (b"a\n", b"a\nb\n", "1 lines != 2 lines"),
    ],
)
def test_compare_bytes(got, want, msg):
    if msg is None:
        cs.compare_bytes("x", got, want)
    else:
        with pytest.raises(AssertionError, match=msg):
            cs.compare_bytes("x", got, want)


def test_compile_summary():
    err = (
        "Finished tracing + transforming step for pjit in 1.5 sec\n"
        "Persistent compilation cache hit for 'jit_step' with key 'k'\n"
        "Finished XLA compilation of jit(step) in 0.250000000 sec\n"
        "Finished XLA compilation of jit(_where) in 0.050000000 sec\n"
    )
    got = cs.compile_summary(err)
    assert "0.30 s over 2 programs" in got and "1 cache hits" in got and "longest jit(step) 0.25 s" in got
    assert cs.compile_summary("no logs here") == "no XLA compilation logged"


def test_compile_summary_reads_a_real_cli_run(tmp_path):
    """A device CLI run on the CPU backend, with the runner's environment,
    logs its compilations on stderr in the form compile_summary parses."""
    fa = tmp_path / "g.fa"
    fa.write_text(">g\n" + "ACGTTGCAAGGCTTAC" * 40 + "\n")
    idx = str(tmp_path / "g.fmd")
    runner = cs.Runner("cpu")
    runner.run(["build", "-do", idx, str(fa)], device=False, timeout=300)
    out, _, err = runner.run(["mem", "-l10", "--engine=jax", idx, str(fa)], device=True, timeout=600)
    assert out.startswith(b"g\t")
    assert "XLA compile or cache load" in cs.compile_summary(err)


def test_compare_ref_against_smem_ref(ref_index, corpus):
    """The native engine's BED passes the plain-reference check; a BED with
    one MEM dropped fails it."""
    from ropebwt3_jax.cli import load_index

    from .conftest import run_ours

    reads = str(corpus / "reads.fa")
    bed = run_ours(["mem", "-l31", str(ref_index), reads])
    f = load_index(str(ref_index))
    assert cs.compare_ref("native", bed, f, reads, 20) > 0
    lines = bed.splitlines(keepends=True)
    with pytest.raises(AssertionError, match="reference"):
        cs.compare_ref("tampered", b"".join(lines[1:]), f, reads, 20)


def test_refuses_without_gpu():
    """On the CPU the device probe reports no GPU: exit non-zero before any
    phase, and no JSON result line."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "[2 " not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_alone(tmp_path):
    """In a directory holding only chip_smoke.py the script exits non-zero
    and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
