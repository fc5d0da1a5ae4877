"""Two-process jax.distributed run of the sharded SMEM step (CPU devices).

Exercises parallel/launch.py end-to-end: coordinator bring-up from env vars,
a global (dp, idx) mesh spanning both processes, ShardedIndex construction
with cross-process shardings, and one packed SMEM step whose per-process
local output shards must match the host reference FSM.  This is the
cluster-free stand-in for real multi-host (SURVEY.md §4: "multi-host tests
via jax.distributed with CPU devices")."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np

from ropebwt3_jax.parallel.launch import init_distributed, global_mesh

init_distributed()  # JAX_COORDINATOR_ADDRESS / _NUM_PROCESSES / _PROCESS_ID

import jax

assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

from jax.sharding import NamedSharding, PartitionSpec as P

from ropebwt3_jax.construct.sa import gsa_bwt
from ropebwt3_jax.index.dense import DenseFMIndex
from ropebwt3_jax.ops import smem_ref
from ropebwt3_jax.parallel.mesh import ShardedIndex, make_mesh
from ropebwt3_jax.parallel.smem_sharded import smem_sharded_fn

# --- tiny double-strand corpus, same on both processes -----------------
rng = np.random.default_rng(7)
base = rng.integers(1, 5, 512).astype(np.uint8)
seqs = []
for i in range(6):
    s = base.copy()
    mut = rng.random(s.size) < 0.02
    s[mut] = rng.integers(1, 5, int(mut.sum()))
    seqs.append(s)
    seqs.append(np.where(s[::-1] % 5 == 0, s[::-1], 5 - s[::-1]).astype(np.uint8))  # revcomp
cat = np.concatenate([np.concatenate([s, [0]]) for s in seqs]).astype(np.uint8)
bwt = gsa_bwt(cat, backend="numpy")
f = DenseFMIndex.from_bwt(bwt)

mesh = global_mesh(dp=2, idx=4)
sidx = ShardedIndex.from_dense(f, mesh)

Q, L = 8, 128
reads = np.zeros((Q, L), np.uint8)
qlen = np.full((Q,), 100, np.int32)
for i in range(Q):
    st = int(rng.integers(0, base.size - 100))
    r = base[st : st + 100].copy()
    mut = rng.random(100) < 0.03
    r[mut] = rng.integers(1, 5, int(mut.sum()))
    reads[i, :100] = r

step = smem_sharded_fn(sidx, min_occ=1, min_len=21, max_mems=32, max_iters=4 * L + 64)
qd = jax.device_put(reads, NamedSharding(mesh, P("dp", None)))
qld = jax.device_put(qlen, NamedSharding(mesh, P("dp")))
mems, n_mem, _ = step(qd, qld)

# host reference on the same reads
exp = [smem_ref.smem_tg(f, reads[i, :100], min_occ=1, min_len=21) for i in range(Q)]

# verify THIS process's addressable shards only (global fetch needs allgather)
for shard in n_mem.addressable_shards:
    rows = range(*shard.index[0].indices(Q))
    got = np.asarray(shard.data)
    for li, gi in enumerate(rows):
        assert got[li] == len(exp[gi]), (gi, got[li], len(exp[gi]))
for shard in mems.addressable_shards:
    rows = range(*shard.index[0].indices(Q))
    got = np.asarray(shard.data)
    for li, gi in enumerate(rows):
        want = sorted((m.start, m.end, m.size) for m in exp[gi])
        have = sorted((int(r[0]), int(r[1]), int(r[2])) for r in got[li][: len(exp[gi])])
        assert want == have, (gi, want, have)

print(f"OK process {jax.process_index()}", flush=True)
"""


def test_two_process_sharded_smem(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()
    w = tmp_path / "worker.py"
    w.write_text(WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            # repo root: makes the package importable from a script-mode
            # worker (sys.path[0] is the script dir, not cwd)
            PYTHONPATH=root,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_COORDINATOR_ADDRESS=addr,
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen([sys.executable, str(w)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    outs = [p.communicate(timeout=300) for p in procs]
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{err.decode()[-3000:]}"
        assert f"OK process {pid}" in out.decode(), out.decode()


def _spawn_two(cmd_argv, extra_env=None, per_proc_argv=None):
    """Run the CLI command under 2-process jax.distributed (4 CPU devices
    each, 8 global); returns [(rc, stdout, stderr)] per process."""
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            PYTHONPATH=root,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_COORDINATOR_ADDRESS=addr,
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            RB3JAX_CACHE="0",  # both processes share the cwd; no sidecar races
        )
        if extra_env:
            env.update(extra_env)
        argv = cmd_argv if per_proc_argv is None else per_proc_argv[pid]
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "ropebwt3_jax"] + argv,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=root,
            )
        )
    outs = [p.communicate(timeout=600) for p in procs]
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def test_two_process_cli_mem_mesh(ref_bin, ref_index, corpus):
    """End-to-end `mem --engine=jax --mesh=2x4` under 2-process
    jax.distributed: process 0's BED must byte-match the reference; process 1
    is silent (VERDICT r3 item 6)."""
    want = subprocess.run(
        [ref_bin, "mem", "-l13", str(ref_index), str(corpus / "reads.fa")],
        capture_output=True, check=True,
    ).stdout
    res = _spawn_two(["mem", "-l13", "--engine=jax", "--mesh=2x4", str(ref_index), str(corpus / "reads.fa")])
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, f"process {pid} failed:\n{err.decode()[-3000:]}"
    assert res[0][1] == want, "process 0 BED differs from the reference"
    assert res[1][1] == b"", "process 1 must not write stdout"


def _sw_reads8(corpus, tmp_path):
    """First 8 corpus reads (sw is the slow path; keep the 2-proc runs fast)."""
    lines = open(corpus / "reads.fa").read().strip().split("\n")
    p = tmp_path / "reads8.fa"
    p.write_text("\n".join(lines[:16]) + "\n")
    return p


def test_two_process_cli_sw_mesh(ref_bin, ref_index, corpus, tmp_path):
    """End-to-end `sw --mesh` under 2-process jax.distributed (VERDICT r4
    item 6): process 0's PAF byte-matches the reference; process 1 silent."""
    reads = _sw_reads8(corpus, tmp_path)
    want = subprocess.run([ref_bin, "sw", str(ref_index), str(reads)], capture_output=True, check=True).stdout
    res = _spawn_two(["sw", "--mesh=8", str(ref_index), str(reads)])
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, f"process {pid} failed:\n{err.decode()[-3000:]}"
    assert res[0][1] == want, "process 0 PAF differs from the reference"
    assert res[1][1] == b"", "process 1 must not write stdout"


def test_two_process_cli_hapdiv_mesh(ref_bin, ref_index, corpus, tmp_path):
    """End-to-end `hapdiv --mesh` under 2-process jax.distributed."""
    reads = _sw_reads8(corpus, tmp_path)
    want = subprocess.run([ref_bin, "hapdiv", str(ref_index), str(reads)], capture_output=True, check=True).stdout
    res = _spawn_two(["hapdiv", "--mesh=8", str(ref_index), str(reads)])
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, f"process {pid} failed:\n{err.decode()[-3000:]}"
    assert res[0][1] == want, "process 0 output differs from the reference"
    assert res[1][1] == b"", "process 1 must not write stdout"


def test_two_process_cli_ssa_mesh(ref_bin, ref_index, tmp_path):
    """End-to-end `ssa --mesh` under 2-process jax.distributed: both
    processes write their own SSA file; bytes must match the reference's."""
    want_ssa = str(ref_index) + ".ssa"  # built by the ref_index fixture
    outs = [str(tmp_path / f"p{pid}.ssa") for pid in range(2)]
    res = _spawn_two(
        None,
        per_proc_argv=[["ssa", "--mesh=2x4", "-o", outs[pid], str(ref_index)] for pid in range(2)],
    )
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, f"process {pid} failed:\n{err.decode()[-3000:]}"
    want = open(want_ssa, "rb").read()
    for pid in range(2):
        assert open(outs[pid], "rb").read() == want, f"process {pid} SSA differs"


@pytest.mark.slow  # ~2 min; single-process build --mesh golden covers the
# sharded merge (test_cli_golden.test_build_mesh_golden)
def test_two_process_cli_build_mesh(ref_bin, corpus, tmp_path):
    """End-to-end `build --mesh=2x4` (sharded merge rank) under 2-process
    jax.distributed: each process writes its own FMD; both must byte-match
    the reference single-process build."""
    fa = str(corpus / "genomes.fa")
    want_fmd = tmp_path / "ref.fmd"
    subprocess.run([ref_bin, "build", "-do", str(want_fmd), fa], check=True, capture_output=True)
    outs = [str(tmp_path / f"p{pid}.fmd") for pid in range(2)]
    res = _spawn_two(
        None,
        per_proc_argv=[["build", "-m6k", "-do", outs[pid], "--mesh=2x4", fa] for pid in range(2)],
    )
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, f"process {pid} failed:\n{err.decode()[-3000:]}"
    want = open(want_fmd, "rb").read()
    for pid in range(2):
        got = open(outs[pid], "rb").read()
        assert got == want, f"process {pid} FMD differs from the reference"
