"""Codec round-trips and byte-exactness vs the reference binary."""

import numpy as np

from ropebwt3_jax.formats import bre, fmd, fmr
from ropebwt3_jax.index.dense import DenseFMIndex
from ropebwt3_jax.nt6 import nt6_to_str

from .conftest import run_ref


def test_fmd_reencode_bytes(ref_index):
    data = open(ref_index, "rb").read()
    h, syms, lens = fmd.decode_runs(data)
    assert fmd.encode_runs(syms, lens) == data


def test_fmd_decode_matches_plain(ref_bin, ref_index, corpus):
    plain = run_ref(ref_bin, ["build", str(corpus / "genomes.fa")]).strip().decode()
    _, syms, lens = fmd.decode_runs(open(ref_index, "rb").read())
    assert nt6_to_str(np.repeat(syms, lens)) == plain


def test_fmr_roundtrip_and_ref_interop(ref_bin, ref_index, tmp_path):
    _, syms, lens = fmd.decode_runs(open(ref_index, "rb").read())
    data = fmr.write_fmr_bytes(fmr.split_runs_into_buckets(syms, lens))
    so, s2, l2 = fmr.read_fmr_bytes(data)
    assert np.array_equal(s2, syms) and np.array_equal(l2, lens)
    # the reference must be able to restore our FMR (logical BWT equality)
    my_fmr = tmp_path / "ours.fmr"
    my_fmr.write_bytes(data)
    plain = run_ref(ref_bin, ["build", "-i", str(my_fmr), "-"], input=b"").strip().decode()
    assert plain == nt6_to_str(np.repeat(syms, lens))


def test_fmr_read_reference_dump(ref_bin, ref_index, corpus, tmp_path):
    ref_fmr = tmp_path / "ref.fmr"
    ref_fmr.write_bytes(run_ref(ref_bin, ["build", "-b", str(corpus / "genomes.fa")]))
    _, s1, l1 = fmr.read_fmr_bytes(ref_fmr.read_bytes())
    _, s2, l2 = fmd.decode_runs(open(ref_index, "rb").read())
    assert np.array_equal(s1, s2) and np.array_equal(l1, l2)


def test_bre_byte_exact(ref_bin, ref_index, corpus):
    ref_bre = run_ref(ref_bin, ["build", "-e", str(corpus / "genomes.fa")])
    _, syms, lens = fmd.decode_runs(open(ref_index, "rb").read())
    assert bre.write_bre_bytes(syms, lens) == ref_bre
    s2, l2 = bre.read_bre_bytes(ref_bre)
    assert np.array_equal(s2, syms) and np.array_equal(l2, lens)


def test_dense_runs_roundtrip(ref_index):
    _, syms, lens = fmd.decode_runs(open(ref_index, "rb").read())
    f = DenseFMIndex.from_runs(syms, lens)
    s2, l2 = f.to_runs()
    assert np.array_equal(s2, syms) and np.array_equal(l2, lens)
