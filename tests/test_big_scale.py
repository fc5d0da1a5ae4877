""">2^31-symbol (int64-index) golden test — gated, uses cached artifacts.

Run:  RB3JAX_SLOW_TESTS=1 python -m pytest tests/test_big_scale.py -x -q

Needs the 2.4 Gsym corpus + index under .bench/big2g (built once by
`python scripts/scale_bench.py gen big2g` + a multi-batch CLI build, ~30 min;
see scripts/scale_bench.py).  Compares our `mem` against the reference binary
on OUR int64 index — exercising the megablock occf layout, int64 SA
positions, and the native engine's int64 paths end-to-end."""

import hashlib
import os
import subprocess
import sys

import pytest

from .conftest import REF_BIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = os.path.join(ROOT, ".bench", "big2g")

pytestmark = pytest.mark.skipif(
    os.environ.get("RB3JAX_SLOW_TESTS") != "1"
    or not os.path.exists(os.path.join(BIG, "idx.fmd"))
    or not os.path.exists(REF_BIN),
    reason="gated: RB3JAX_SLOW_TESTS=1 + cached .bench/big2g artifacts",
)


def test_mem_golden_int64_index():
    fmd = os.path.join(BIG, "idx.fmd")
    reads = os.path.join(BIG, "reads.fa")
    r = subprocess.run([REF_BIN, "mem", "-t4", "-l31", fmd, reads], check=True, capture_output=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    o = subprocess.run(
        [sys.executable, "-m", "ropebwt3_jax", "mem", "-l31", fmd, reads],
        check=True, capture_output=True, env=env, cwd=ROOT,
    )
    assert r.stdout, "reference produced no output"
    assert hashlib.sha256(o.stdout).hexdigest() == hashlib.sha256(r.stdout).hexdigest()


BIG8 = os.path.join(ROOT, ".bench", "big8g")


@pytest.mark.skipif(
    os.environ.get("RB3JAX_SLOW_TESTS") != "1"
    or not os.path.exists(os.path.join(BIG8, "idx.fmd"))
    or not os.path.exists(REF_BIN),
    reason="gated: RB3JAX_SLOW_TESTS=1 + cached .bench/big8g artifacts",
)
def test_mem_golden_8gsym_index():
    """8.0 Gsym (beyond-dense-HBM capacity demo corpus, round 4): our mem
    must byte-match the reference on our own int64 index."""
    fmd = os.path.join(BIG8, "idx.fmd")
    reads = os.path.join(BIG8, "reads.fa")
    r = subprocess.run([REF_BIN, "mem", "-t4", "-l31", fmd, reads], check=True, capture_output=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    o = subprocess.run(
        [sys.executable, "-m", "ropebwt3_jax", "mem", "-l31", fmd, reads],
        check=True, capture_output=True, env=env, cwd=ROOT,
    )
    assert r.stdout, "reference produced no output"
    assert hashlib.sha256(o.stdout).hexdigest() == hashlib.sha256(r.stdout).hexdigest()
