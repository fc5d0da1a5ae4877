"""Edge-case golden tests: N bases, FASTQ/gzip/stdin inputs, min_occ filters,
multi-file queries, short reads, kount over two indexes."""

import gzip
import subprocess

import pytest

from .conftest import run_ours, run_ref


def test_mem_reads_with_N(ref_bin, ref_index, tmp_path):
    p = tmp_path / "nreads.fa"
    p.write_text(">a\nACGTNNNACGTACGTACGTACGTAGCTAGCTAGNCATGCA\n>b\nNNNNNNNNNNNNNNNNNNNNNNNN\n>c\nACGT\n")
    args = ["mem", "-l13", str(ref_index), str(p)]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_mem_min_occ(ref_bin, ref_index, corpus):
    args = ["mem", "-l21", "-c5", str(ref_index), str(corpus / "reads.fa")]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_mem_fastq_and_gzip(ref_bin, ref_index, corpus, tmp_path):
    lines = open(corpus / "reads.fa").read().strip().split("\n")
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i in range(0, 20, 2):
            name, seq = lines[i][1:], lines[i + 1]
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    args = ["mem", "-l21", str(ref_index), str(fq)]
    assert run_ours(args) == run_ref(ref_bin, args)
    gz = tmp_path / "r.fq.gz"
    gz.write_bytes(gzip.compress(fq.read_bytes()))
    args = ["mem", "-l21", str(ref_index), str(gz)]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_mem_multiple_files_seq_ids(ref_bin, ref_index, tmp_path):
    # unnamed line-mode reads across two files: seq%d ids must continue
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text("ACGTACGTACGTACGTACGTACGTACGT\n")
    b.write_text("TTGCATTGCATTGCATTGCATTGCATT\n")
    args = ["mem", "-Ll10", str(ref_index), str(a), str(b)]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_mem_stdin(ref_bin, ref_index):
    inp = b"ACGTACGTACGTACGTACGTACGTACGT\n"
    args = ["mem", "-Ll10", str(ref_index), "-"]
    assert run_ours(args, input=inp) == run_ref(ref_bin, args, input=inp)


def test_mem_short_reads(ref_bin, ref_index):
    inp = b"A\nAC\nACGTACGTACGTACGTACG\n\n"
    args = ["mem", "-Ll19", str(ref_index), "-"]
    assert run_ours(args, input=inp) == run_ref(ref_bin, args, input=inp)


def test_kount_two_indexes(ref_bin, ref_index, corpus, tmp_path):
    # second index from a subset of the corpus
    lines = open(corpus / "genomes.fa").read().strip().split("\n")
    h = tmp_path / "half.fa"
    h.write_text("\n".join(lines[:8]) + "\n")
    idx2 = tmp_path / "half.fmd"
    idx2.write_bytes(run_ref(ref_bin, ["build", "-d", str(h)]))
    args = ["kount", "-k5", "-m3", str(ref_index), str(idx2)]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_build_empty_and_fastq(ref_bin, tmp_path):
    fq = tmp_path / "in.fq"
    fq.write_text("@r1\nACGTACGTAAGG\n+\nIIIIIIIIIIII\n@r2\nTTTTACGT\n+\nIIIIIIII\n")
    assert run_ours(["build", str(fq)]) == run_ref(ref_bin, ["build", str(fq)])


def test_get_out_of_range(ref_bin, ref_index):
    args = ["get", str(ref_index), "999999", "0"]
    assert run_ours(args) == run_ref(ref_bin, args)


def test_suffix_line_mode(ref_bin, ref_index):
    inp = b"GGGGGGGGGGGGGG\nACGTACGTACGT\n"
    args = ["suffix", "-L", str(ref_index), "-"]
    assert run_ours(args, input=inp) == run_ref(ref_bin, args, input=inp)


def test_missing_input_files(ref_bin, ref_index, tmp_path):
    """Missing sequence/input files: stdout and the ERROR stderr line match
    the reference (search.c:571-575 break; build.c:209 continue)."""
    import os
    import subprocess
    import sys

    q = tmp_path / "q.fa"
    q.write_text(">q1\nACGTACGTACGTACGTACGTACGT\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"

    def both(args):
        r = subprocess.run([ref_bin] + args, capture_output=True)
        o = subprocess.run([sys.executable, "-m", "ropebwt3_jax"] + args, capture_output=True, env=env)
        assert o.stdout == r.stdout, args
        ref_err = [l for l in r.stderr.splitlines() if l.startswith(b"ERROR")]
        our_err = [l for l in o.stderr.splitlines() if l.startswith(b"ERROR")]
        assert our_err == ref_err, (args, our_err, ref_err)

    nf = str(tmp_path / "nofile.fa")
    # mem/sw/hapdiv: process q.fa, then report the missing file and stop
    both(["mem", "-l5", str(ref_index), str(q), nf, str(q)])
    both(["sw", "-m1", str(ref_index), str(q), nf])
    both(["hapdiv", "-a11", str(ref_index), nf])
    # build: report and continue with the remaining inputs
    both(["build", nf, str(q)])


def test_batch_nt6_flat_matches_streaming(tmp_path):
    """The two-scatter construction-batch assembler must equal read_batch_nt6
    for every strand combination, including empty records."""
    import numpy as np

    from ropebwt3_jax.seqio import batch_nt6_flat, read_batch_nt6, read_seqs, read_seqs_flat

    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    for trial in range(10):
        recs = [bytes(rng.choice(alpha, int(rng.integers(0, 120)))) for _ in range(int(rng.integers(1, 30)))]
        p = tmp_path / f"b{trial}.fa"
        p.write_bytes(b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(recs)))
        for is_for, is_rev in ((True, True), (True, False), (False, True)):
            wn, want = read_batch_nt6(read_seqs(str(p)), 1 << 62, is_for, is_rev)
            _, flat, offs = read_seqs_flat(str(p))
            gn, got = batch_nt6_flat(flat, offs, is_for, is_rev)
            assert wn == gn and np.array_equal(want, got), (trial, is_for, is_rev)


def test_flat_reader_matches_streaming(tmp_path):
    """read_seqs_flat (vectorized whole-buffer parse) must yield exactly the
    records of the streaming read_seqs for every input shape — multi-line
    FASTA, CRLF, empty sequences, bare '>', FASTQ, leading junk, no trailing
    newline — or return None (fallback) where it cannot."""
    import gzip as _gz

    import numpy as np

    from ropebwt3_jax.nt6 import char2nt6
    from ropebwt3_jax.seqio import read_seqs, read_seqs_flat

    cases = [
        b">a\nACGT\n>b x y\nNNN\nacgt\n",
        b">a\r\nAC\r\nGT\r\n>b\nTTTT",  # CRLF + no trailing newline
        b">\nACGT\n>c\n\nAC\n\n",  # bare '>', empty lines inside a record
        b"junk\nlines\n>a\nACGT\n",  # leading junk is dropped
        b">only_header\n",
        b">e1\n>e2\nAC\n",  # empty record then normal
        b"@q1 desc\nACGT\n+\nIIII\n@q2\nTTnn\n+x\n!!!!\n",  # FASTQ
        b"",
        b">x\n" + b"ACGTN" * 1000 + b"\n",
    ]
    rng = np.random.default_rng(3)
    for _ in range(20):  # random multi-record FASTA soup
        parts = []
        for r in range(int(rng.integers(1, 9))):
            parts.append(b">r%d t\n" % r)
            for _l in range(int(rng.integers(0, 4))):
                ln = int(rng.integers(0, 60))
                parts.append(bytes(rng.choice(np.frombuffer(b"ACGTNacgtn@+>", np.uint8), ln)) + b"\n")
        cases.append(b"".join(parts))
    for ci, case in enumerate(cases):
        for gz in (False, True):
            p = tmp_path / f"c{ci}{'gz' if gz else ''}.fa"
            p.write_bytes(_gz.compress(case) if gz else case)
            for is_line in (False, True):
                want = [(r.name, char2nt6(r.seq).tobytes()) for r in read_seqs(str(p), is_line)]
                got = read_seqs_flat(str(p), is_line)
                if got is None:
                    continue  # fallback is always legal
                names, flat, offs = got
                have = [(names[i], flat[offs[i] : offs[i + 1]].tobytes()) for i in range(len(names))]
                assert have == want, (ci, gz, is_line, case[:80])


def test_write_all_chunking(tmp_path):
    """bufio.write_all must reproduce the input bytes exactly for bytes,
    memoryview, and str inputs across chunk boundaries (large writes are
    chunked to dodge a VM pathology — see ropebwt3_jax/bufio.py)."""
    import numpy as np

    from ropebwt3_jax.bufio import write_all

    data = np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    for chunk in (7, 4096, 1 << 19, 1 << 22):
        for payload in (data, memoryview(data), np.frombuffer(data, np.uint8)):
            p = tmp_path / "b.bin"
            with open(p, "wb") as fp:
                write_all(fp, payload, chunk)
            assert p.read_bytes() == data
    s = "".join(chr(32 + i % 90) for i in range(100_001))
    p = tmp_path / "t.txt"
    with open(p, "w") as fp:
        write_all(fp, s, 1000)
    assert p.read_text() == s


def test_footer_realtime_anchored_at_process_start():
    """The Real-time footer must measure from exec, not from the (lazy)
    import of the log module (misc.c:152-157 anchors at main entry)."""
    import subprocess
    import sys

    code = (
        "import time; time.sleep(1.2); import ropebwt3_jax.log as L;"
        "print(L.realtime())"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env=_scrubbed_env(),
    )
    assert float(out.stdout.strip()) >= 1.2


def _scrubbed_env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    return env
