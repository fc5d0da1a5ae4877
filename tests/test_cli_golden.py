"""End-to-end CLI golden tests: every command's stdout must byte-match the
reference binary on the same inputs (SURVEY.md §4 test strategy)."""

import os
import subprocess
import sys

import pytest

from .conftest import run_ours, run_ref


def test_build_plain_golden(ref_bin, corpus):
    fa = str(corpus / "genomes.fa")
    assert run_ours(["build", fa]) == run_ref(ref_bin, ["build", fa])


def test_build_toy_two_seqs(ref_bin):
    inp = b"AGG\nAGC\n"
    assert run_ours(["build", "-LR", "-"], input=inp) == run_ref(ref_bin, ["build", "-LR", "-"], input=inp)
    assert run_ours(["build", "-L", "-"], input=inp) == run_ref(ref_bin, ["build", "-L", "-"], input=inp)


def test_build_tree_golden(ref_bin, corpus):
    """`build -T` Newick-style B+-tree dump (build.c:131, mrope.c:187-193).

    Leaf boundaries reflect construction history (like FMR bytes,
    README.md:169-171), so compare the logical BWT — concatenated leaf
    contents — plus exact bytes on a single-leaf input."""
    fa = str(corpus / "genomes.fa")

    def strip(out):  # drop topology characters, keep the BWT symbol stream
        return out.translate(None, b"(),\n")

    assert strip(run_ours(["build", "-LT", fa])) == strip(run_ref(ref_bin, ["build", "-LT", fa]))
    inp = b"TGAACTCTACACAACATATTTTGTCACCAAG\n"
    assert run_ours(["build", "-LT", "-"], input=inp) == run_ref(ref_bin, ["build", "-LT", "-"], input=inp)


def test_build_fmd_golden(ref_bin, corpus, ref_index):
    fa = str(corpus / "genomes.fa")
    assert run_ours(["build", "-d", fa]) == open(ref_index, "rb").read()


def test_build_batched_merge(ref_bin, corpus):
    fa = str(corpus / "genomes.fa")
    assert run_ours(["build", "-m", "20000", fa]) == run_ref(ref_bin, ["build", fa])


def test_merge_cmd_logical(ref_bin, corpus, tmp_path):
    from ropebwt3_jax.cli import load_runs
    import numpy as np

    fa = str(corpus / "genomes.fa")
    h1, h2 = tmp_path / "h1.fa", tmp_path / "h2.fa"
    lines = open(fa).read().strip().split("\n")
    h1.write_text("\n".join(lines[:8]) + "\n")
    h2.write_text("\n".join(lines[8:]) + "\n")
    for h, o in ((h1, "h1.fmd"), (h2, "h2.fmd")):
        (tmp_path / o).write_bytes(run_ref(ref_bin, ["build", "-d", str(h)]))
    (tmp_path / "ref.fmr").write_bytes(run_ref(ref_bin, ["merge", str(tmp_path / "h1.fmd"), str(tmp_path / "h2.fmd")]))
    (tmp_path / "my.fmr").write_bytes(run_ours(["merge", str(tmp_path / "h1.fmd"), str(tmp_path / "h2.fmd")]))
    s1, l1 = load_runs(str(tmp_path / "ref.fmr"))
    s2, l2 = load_runs(str(tmp_path / "my.fmr"))
    assert np.array_equal(s1, s2) and np.array_equal(l1, l2)


def test_build_rlo_rclo(ref_bin, tmp_path):
    import numpy as np

    rng = np.random.default_rng(11)
    fa = tmp_path / "u.fa"
    with open(fa, "w") as f:
        for i in range(30):
            L = int(rng.integers(3, 40))
            f.write(f">u{i}\n" + "".join("ACGTN"[c] for c in rng.integers(0, 5, L)) + "\n")
        f.write(">d1\nACGTACGT\n>d2\nACGTACGT\n>d3\nACGT\n")
    assert run_ours(["build", "-s", str(fa)]) == run_ref(ref_bin, ["build", "-2s", str(fa)])
    assert run_ours(["build", "-r", str(fa)]) == run_ref(ref_bin, ["build", "-2r", str(fa)])


def test_build_checkpoint_and_incremental(ref_bin, corpus, tmp_path):
    lines = open(corpus / "genomes.fa").read().strip().split("\n")
    h1, h2 = tmp_path / "h1.fa", tmp_path / "h2.fa"
    h1.write_text("\n".join(lines[:8]) + "\n")
    h2.write_text("\n".join(lines[8:]) + "\n")
    both = run_ref(ref_bin, ["build", str(h1), str(h2)])
    # -S: final checkpoint must restore to the full BWT (reference reads our FMR)
    ck = tmp_path / "ck.fmr"
    run_ours(["build", "-S", str(ck), str(h1), str(h2)])
    assert run_ref(ref_bin, ["build", "-i", str(ck), "-"], input=b"") == both
    # -i with an FMR base
    fmr1 = tmp_path / "h1.fmr"
    fmr1.write_bytes(run_ours(["build", "-b", str(h1)]))
    assert run_ours(["build", "-i", str(fmr1), str(h2)]) == both


def test_ssa_golden(ref_bin, ref_index):
    assert run_ours(["ssa", str(ref_index)]) == run_ref(ref_bin, ["ssa", str(ref_index)])


def test_ssa_mesh_golden(ref_bin, ref_index):
    """ssa --mesh (LF-walk lanes sharded over dp via shard_map, per-shard
    independent loops, pmax buffer merge): byte-identical SSA dump."""
    ours = run_ours(["ssa", "--mesh=4x2", str(ref_index)])
    assert ours == run_ref(ref_bin, ["ssa", str(ref_index)])


@pytest.mark.parametrize("extra", [[], ["--old-mem"], ["-l31"], ["--gap", "20"], ["--cov"], ["-l31", "-p3"]])
def test_mem_golden(ref_bin, ref_index, corpus, extra):
    args = ["mem", "-l21"] + extra + [str(ref_index), str(corpus / "reads.fa")]
    assert run_ours(args + ["--engine=ref"]) == run_ref(ref_bin, args)


@pytest.mark.parametrize("extra", [[], ["-p3"]])
def test_mem_hybrid_golden(ref_bin, ref_index, corpus, extra):
    """mem --engine=hybrid (device + native concurrently on disjoint read
    slices, adaptive split): byte-identical BED in input order."""
    args = ["mem", "-l21"] + extra + [str(ref_index), str(corpus / "reads.fa")]
    assert run_ours(args + ["--engine=hybrid"]) == run_ref(ref_bin, args)


def test_mem_mesh_golden(ref_bin, ref_index, corpus):
    """mem over a sharded (dp, idx) device mesh (--mesh with --engine=jax):
    byte-identical BED on the 8-device virtual mesh the tests run under."""
    args = ["mem", "-l21", str(ref_index), str(corpus / "reads.fa")]
    assert run_ours(args + ["--engine=jax", "--mesh=4x2"]) == run_ref(ref_bin, args)


def test_build_mesh_golden(ref_bin, corpus, tmp_path):
    """Multi-batch build with the merge rank phase on a sharded (dp, idx)
    mesh (build --mesh): FMD bytes identical to the reference build."""
    ref_fmd = tmp_path / "ref.fmd"
    our_fmd = tmp_path / "ours.fmd"
    fa = str(corpus / "genomes.fa")
    run_ref(ref_bin, ["build", "-do", str(ref_fmd), fa])
    # -m16k forces several batches through merge_plain(mesh=...)
    run_ours(["build", "-m16k", "--mesh=2x4", "-do", str(our_fmd), fa])
    assert our_fmd.read_bytes() == ref_fmd.read_bytes()


def test_mem_toy_readme(ref_bin, tmp_path):
    idx = tmp_path / "toy.fmd"
    seq = b"TGAACTCTACACAACATATTTTGTCACCAAG\n"
    idx.write_bytes(run_ref(ref_bin, ["build", "-Ld", "-"], input=seq))
    q = b"ACTCTACACAAgATATTTTGTCA\n"
    args = ["mem", "-Ll10", str(idx), "-"]
    assert run_ours(args + ["--engine=ref"], input=q) == run_ref(ref_bin, args, input=q)


def test_stat_get_suffix_golden(ref_bin, ref_index, corpus):
    assert run_ours(["stat", str(ref_index)]) == run_ref(ref_bin, ["stat", str(ref_index)])
    ks = [str(ref_index), "0", "3", "9"]
    assert run_ours(["get"] + ks) == run_ref(ref_bin, ["get"] + ks)
    args = ["suffix", str(ref_index), str(corpus / "reads.fa")]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_kount_golden(ref_bin, ref_index):
    args = ["kount", "-k7", "-m4", str(ref_index)]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_fa2line_fa2kmer_golden(ref_bin, corpus):
    fa = str(corpus / "reads.fa")
    assert run_ours(["fa2line", fa]) == run_ref(ref_bin, ["fa2line", fa])
    assert run_ours(["fa2kmer", "-k37", "-w17", fa]) == run_ref(ref_bin, ["fa2kmer", "-k37", "-w17", fa])


def test_fa2line_long_records_golden(ref_bin, corpus):
    """8 kb records take the long-record slice-view fast path (avg record
    >= 256 B in cli.main_fa2line) — golden with and without -R."""
    fa = str(corpus / "genomes.fa")
    assert run_ours(["fa2line", fa]) == run_ref(ref_bin, ["fa2line", fa])
    assert run_ours(["fa2line", "-R", fa]) == run_ref(ref_bin, ["fa2line", "-R", fa])


def test_plain2fmd_golden(ref_bin, corpus, tmp_path):
    plain = run_ref(ref_bin, ["build", str(corpus / "genomes.fa")])
    p = tmp_path / "bwt.txt"
    p.write_bytes(plain)
    assert run_ours(["plain2fmd", str(p)]) == run_ref(ref_bin, ["plain2fmd", str(p)])


def test_version():
    assert run_ours(["version"]).strip() == b"3.10-r281"


def test_usage_stdout_and_exit_parity(ref_bin):
    """No-arg invocations: the stdout portion of the usage text and the exit
    code must match the reference for every command (main.c exits 0 for all
    known commands, search.c:508 prints the Usage line to stdout, etc.)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    cmds = ["mem", "sw", "hapdiv", "build", "merge", "ssa", "plain2fmd",
            "get", "stat", "suffix", "kount", "fa2line", "fa2kmer"]
    for cmd in cmds:
        r = subprocess.run([ref_bin, cmd], capture_output=True)
        o = subprocess.run([sys.executable, "-m", "ropebwt3_jax", cmd], capture_output=True, env=env)
        assert o.returncode == r.returncode, cmd
        ref_out = r.stdout.replace(b"ropebwt3", b"rb3jax")
        assert o.stdout == ref_out, (cmd, o.stdout, ref_out)
    # unknown command: the one nonzero exit in the reference
    r = subprocess.run([ref_bin, "bogus"], capture_output=True)
    o = subprocess.run([sys.executable, "-m", "ropebwt3_jax", "bogus"], capture_output=True, env=env)
    assert o.returncode == r.returncode == 1


def test_mem_pos_min_len1_golden(ref_bin, ref_index, corpus):
    """-l1 -c5 -p: MEMs whose locate returns 0 positions must omit the n_pos
    column (search.c:305; found by scripts/fuzz_diff.py seed 148)."""
    args = ["mem", "-l", "1", "-c", "5", "-p", "7", str(ref_index), str(corpus / "reads.fa")]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_fa2line_native_binary_golden(ref_bin, corpus, tmp_path):
    """The standalone fa2line binary (native/fa2line.cpp, exec'd by the
    bin/rb3jax launcher to skip interpreter+numpy startup) is byte-identical
    to the reference on FASTA, gzipped FASTA, FASTQ, stdin, -R, and edge
    records (empty seq, multi-line, lowercase, N runs, CRLF)."""
    import gzip
    import subprocess

    from ropebwt3_jax.native import ensure_fa2line

    binp = ensure_fa2line()
    assert binp and os.path.exists(binp)

    edge = tmp_path / "edge.fa"
    edge.write_bytes(
        b">empty\n\n>multi\nACGTacgt\nNNNttt\n\n>crlf\nACG\r\nT\r\n>last\nnacgtn"
    )
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"@q1\nACGTN\n+\nIIIII\n@q2\nttagc\n+junk\n!!!!!\n")
    gz = tmp_path / "r.fa.gz"
    gz.write_bytes(gzip.compress((corpus / "reads.fa").read_bytes()))

    def run_bin(args, input=None):
        r = subprocess.run([binp] + args, input=input, capture_output=True)
        return r.stdout

    for fn in (str(corpus / "reads.fa"), str(edge), str(fq), str(gz)):
        for flags in ([], ["-R"]):
            want = run_ref(ref_bin, ["fa2line"] + flags + [fn])
            assert run_bin(flags + [fn]) == want, (fn, flags)
    # stdin
    data = (corpus / "reads.fa").read_bytes()
    assert run_bin(["-"], input=data) == run_ref(ref_bin, ["fa2line", "-"], input=data)


def test_fa2kmer_nonpositive_step_terminates(corpus):
    """fa2kmer with -w <= 0 must terminate with an error instead of spinning
    (fuzz seed 10141: a junk flag spliced as the -w value gave step 0; the
    reference segfaults on the same input, so no golden compare is possible)."""
    r = subprocess.run(
        [sys.executable, "-m", "ropebwt3_jax", "fa2kmer", "-k", "151", "-w", "0", str(corpus / "reads.fa")],
        capture_output=True, timeout=60, env={**os.environ, "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"},
    )
    assert b"step size must be positive" in r.stderr
    assert r.stdout == b""
