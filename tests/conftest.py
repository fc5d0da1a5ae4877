import os
import shutil
import subprocess
import sys

# The device paths run here on the CPU backend, which they accept only when
# it is pinned by name (ropebwt3_jax.require_device), with an 8-device virtual
# mesh for the sharding tests.  Both settings must be in the environment
# before JAX starts a backend; conftest is imported before any test module,
# and the CLI subprocesses inherit them.
os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
if "jax" in sys.modules:  # a plugin imported jax before us: pin its config too
    sys.modules["jax"].config.update("jax_platforms", "cpu")

import numpy as np
import pytest

# tests marked `slow` (compile-cliff / daemon-lifecycle / 2-process-build
# cases whose feature is also covered by a fast sibling) run only with
# RB3JAX_SLOW_TESTS=1 — keeps the default suite short


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RB3JAX_SLOW_TESTS") == "1":
        return
    skip = pytest.mark.skip(reason="slow (set RB3JAX_SLOW_TESTS=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


REF_SRC = "/root/reference"
REF_BIN_DIR = "/tmp/rb3_ref_bin"
REF_BIN = os.path.join(REF_BIN_DIR, "ropebwt3")


def _ref_bin_or_none():
    """Reference ropebwt3 binary, compiled once from the read-only checkout;
    None when the source is absent."""
    if not os.path.exists(REF_BIN):
        if not os.path.isdir(REF_SRC):
            return None
        shutil.copytree(REF_SRC, REF_BIN_DIR, dirs_exist_ok=True)
        subprocess.run(["make", "-j8"], cwd=REF_BIN_DIR, check=True, capture_output=True)
    return REF_BIN


@pytest.fixture(scope="session")
def ref_bin():
    b = _ref_bin_or_none()
    if b is None:
        pytest.skip("reference source not available")
    return b


def run_ref(ref_bin, args, input=None):
    r = subprocess.run([ref_bin] + args, input=input, capture_output=True, check=True)
    return r.stdout


def run_ours(args, input=None, extra_env=None):
    env = dict(os.environ)
    if extra_env:
        env.update(extra_env)
    r = subprocess.run([sys.executable, "-m", "ropebwt3_jax"] + args, input=input, capture_output=True, env=env)
    assert r.returncode == 0, r.stderr.decode()
    return r.stdout


@pytest.fixture(scope="session")
def golden():
    """golden(args) -> the expected stdout of a CLI command: the reference
    binary's when its source is available, else our default host engine's
    (native SMEM / DP), which is byte-golden against the binary wherever the
    binary runs (test_cli_golden.py)."""
    b = _ref_bin_or_none()

    def run(args, input=None):
        return run_ref(b, args, input) if b is not None else run_ours(args, input)

    return run


@pytest.fixture(scope="session")
def corpus(tmp_path_factory):
    """Small synthetic pangenome + mutated reads."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(42)
    base = rng.integers(0, 4, 8000)
    fa = d / "genomes.fa"
    with open(fa, "w") as f:
        for i in range(8):
            s = base.copy()
            mut = rng.random(len(s)) < 0.01
            s[mut] = rng.integers(0, 4, mut.sum())
            f.write(f">s{i}\n" + "".join("ACGT"[c] for c in s) + "\n")
    reads = d / "reads.fa"
    genome = "".join("ACGT"[c] for c in base)
    with open(reads, "w") as f:
        for i in range(60):
            st = rng.integers(0, len(genome) - 150)
            r = list(genome[st : st + 150])
            for j in range(len(r)):
                if rng.random() < 0.03:
                    r[j] = "ACGT"[rng.integers(0, 4)]
            f.write(f">r{i}\n{''.join(r)}\n")
    return d


@pytest.fixture(scope="session")
def ref_index(corpus):
    """FMD (+ssa +len.gz) for the corpus, built by the reference binary when
    its source is available, else by the in-repo builder (`build -do` +
    `ssa`, byte-golden against the binary in test_cli_golden.py)."""
    import gzip

    fmd = corpus / "idx.fmd"
    fa = str(corpus / "genomes.fa")
    b = _ref_bin_or_none()
    if b is not None:
        subprocess.run([b, "build", "-do", str(fmd), fa], check=True, capture_output=True)
        subprocess.run([b, "ssa", "-o", str(fmd) + ".ssa", str(fmd)], check=True, capture_output=True)
    else:
        run_ours(["build", "-do", str(fmd), fa])
        run_ours(["ssa", "-o", str(fmd) + ".ssa", str(fmd)])
    with gzip.open(str(fmd) + ".len.gz", "wt") as f:
        name = None
        for line in open(corpus / "genomes.fa"):
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split()[0]
            elif line and name:
                f.write(f"{name}\t{len(line)}\n")
                name = None
    return fmd
