"""BWA-SW golden tests: PAF / e2e / all-e2e / hapdiv byte-identical to the
reference, including tie-breaking via khashl bucket order."""

import pytest

from .conftest import run_ours, run_ref


@pytest.fixture(scope="module")
def sw_reads(corpus, tmp_path_factory):
    """A small read set (sw is the slow path; keep CI fast)."""
    d = tmp_path_factory.mktemp("swreads")
    lines = open(corpus / "reads.fa").read().strip().split("\n")
    p = d / "reads8.fa"
    p.write_text("\n".join(lines[:16]) + "\n")
    return p


@pytest.mark.parametrize(
    "args",
    [
        [],
        ["-N5"],
        ["-e"],
        ["--all-e2e"],
        ["-u", "--seq", "-p3"],
        ["-m20", "-A2", "-B5", "-O4", "-E1"],
    ],
)
def test_sw_golden(ref_bin, ref_index, sw_reads, args):
    cmd = ["sw"] + args + [str(ref_index), str(sw_reads)]
    assert run_ours(cmd) == run_ref(ref_bin, cmd)


def test_sw_toy_readme(ref_bin, ref_index):
    q = b"ACCTACAACACCGGTaGGCTACAACGTGG\n"
    cmd = ["sw", "-Lm20", str(ref_index), "-"]
    assert run_ours(cmd, input=q) == run_ref(ref_bin, cmd, input=q)


def test_hapdiv_golden(ref_bin, ref_index, sw_reads):
    cmd = ["hapdiv", str(ref_index), str(sw_reads)]
    assert run_ours(cmd) == run_ref(ref_bin, cmd)


def test_hapdiv_custom_k_w(ref_bin, ref_index, sw_reads):
    cmd = ["hapdiv", "-a61", "-w25", str(ref_index), str(sw_reads)]
    assert run_ours(cmd) == run_ref(ref_bin, cmd)


def test_hapdiv_engine_hybrid_golden(ref_bin, ref_index, sw_reads):
    """hapdiv --engine=hybrid (device + native concurrently on disjoint
    slices) byte-matches the reference."""
    ref_cmd = ["hapdiv", str(ref_index), str(sw_reads)]
    ours_cmd = ["hapdiv", "--engine=hybrid", str(ref_index), str(sw_reads)]
    assert run_ours(ours_cmd) == run_ref(ref_bin, ref_cmd)


@pytest.mark.parametrize("extra", [[], ["-a61", "-w25"], ["-N10"]])
def test_hapdiv_engine_jax_golden(ref_bin, ref_index, sw_reads, extra):
    """hapdiv --engine=jax (device DP, align/hapdiv_jax.py) byte-matches the
    reference end-to-end, including the host fallback for flagged windows."""
    ref_cmd = ["hapdiv"] + extra + [str(ref_index), str(sw_reads)]
    ours_cmd = ["hapdiv", "--engine=jax"] + extra + [str(ref_index), str(sw_reads)]
    assert run_ours(ours_cmd) == run_ref(ref_bin, ref_cmd)


def test_hapdiv_mesh_golden(ref_bin, ref_index, sw_reads):
    """hapdiv --mesh=4x2 (device DP data-parallel over the dp axis, tables
    replicated): byte-identical on the 8-device virtual mesh."""
    ref_cmd = ["hapdiv", str(ref_index), str(sw_reads)]
    ours_cmd = ["hapdiv", "--mesh=4x2", str(ref_index), str(sw_reads)]
    assert run_ours(ours_cmd) == run_ref(ref_bin, ref_cmd)


def test_sw_engine_hybrid_golden(ref_bin, ref_index, sw_reads):
    """sw --engine=hybrid (device + native concurrently on disjoint read
    slices) byte-matches the reference."""
    ref_cmd = ["sw", str(ref_index), str(sw_reads)]
    ours_cmd = ["sw", "--engine=hybrid", str(ref_index), str(sw_reads)]
    assert run_ours(ours_cmd) == run_ref(ref_bin, ref_cmd)


@pytest.mark.parametrize("extra", [[], ["-e"], ["-u", "--seq", "-p3"]])
def test_sw_engine_jax_golden(ref_bin, ref_index, sw_reads, extra):
    """sw --engine=jax (device scoring DP, align/sw_jax.py + host backtrack)
    byte-matches the reference end-to-end, including host fallback for
    flagged/ineligible reads."""
    ref_cmd = ["sw"] + extra + [str(ref_index), str(sw_reads)]
    ours_cmd = ["sw", "--engine=jax"] + extra + [str(ref_index), str(sw_reads)]
    assert run_ours(ours_cmd) == run_ref(ref_bin, ref_cmd)


def test_sw_mesh_golden(ref_bin, ref_index, sw_reads):
    """sw --mesh=4 (device scoring data-parallel over dp, host backtrack):
    byte-identical PAF on the virtual mesh."""
    ref_cmd = ["sw", str(ref_index), str(sw_reads)]
    ours_cmd = ["sw", "--mesh=4", str(ref_index), str(sw_reads)]
    assert run_ours(ours_cmd) == run_ref(ref_bin, ref_cmd)


def test_sw_debug_streams(ref_bin, ref_index, sw_reads):
    """--dbg-dawg/--dbg-sw/--dbg-bt/--dbg-qname stderr traces byte-match."""
    import os
    import subprocess
    import sys

    cmd = ["sw", "--dbg-dawg", "--dbg-sw", "--dbg-bt", "--dbg-qname", str(ref_index), str(sw_reads)]
    ref = subprocess.run([ref_bin, "-t1"][:1] + ["sw", "-t1"] + cmd[1:], capture_output=True, check=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    ours = subprocess.run([sys.executable, "-m", "ropebwt3_jax"] + cmd, capture_output=True, env=env)
    assert ours.returncode == 0, ours.stderr.decode()

    def dbg_lines(b):
        return [l for l in b.decode().split("\n") if l.startswith(("DG\t", "SW\t", "BT\t", "Q\t"))]

    assert dbg_lines(ours.stderr) == dbg_lines(ref.stderr)
    assert ours.stdout == ref.stdout


def test_sw_indel_scoring_cs_golden(ref_bin, ref_index, corpus):
    """Gap-friendly scoring (-A2 -B5 -O3) produces alignments with insertions;
    the inserted base must not leak into rseq/cs (bwa-sw.c:63 writes rseq[rlen]
    before bumping rlen; found by scripts/fuzz_diff.py seed 128)."""
    args = ["sw", "-A", "2", "-B", "5", "-O", "3", "--seq", str(ref_index), str(corpus / "reads.fa")]
    from .conftest import run_ours, run_ref

    assert run_ours(args) == run_ref(ref_bin, args)
