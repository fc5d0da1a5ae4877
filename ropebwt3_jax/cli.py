"""Command-line interface mirroring ropebwt3 (main.c:22-44) with identical
stdout formats: build, merge, ssa, plain2fmd, mem/sw/hapdiv/search/suffix,
get, stat, kount, fa2line, fa2kmer, version.
"""

from __future__ import annotations

import getopt
import os
import re
import sys

import numpy as np

from . import __version__
from .bufio import write_all
from .index.dense import DenseFMIndex
from .nt6 import COMP_TABLE, NT6_TABLE, char2nt6, nt6_to_str, revcomp
from .seqio import batch_nt6_flat, iter_flat_batches, read_batch_nt6, read_seqs, read_sid

REF_VERSION = "3.10-r281"  # ropebwt3 version whose formats/outputs we match


def atoi(s: str) -> int:
    """C atoi semantics: optional whitespace/sign, leading digits, 0 on
    garbage — reference option values go through atoi (e.g. build.c:143),
    so `-l -q9` must parse as 0, not crash."""
    m = re.match(r"[ \t\n\r]*([+-]?[0-9]+)", s or "")
    return int(m.group(1)) if m else 0


def parse_num(s: str) -> int:
    """rb3_parse_num (misc.c:7-16): strtod prefix + optional K/M/G suffix,
    rounding with +0.499; garbage parses as 0."""
    m = re.match(r"[ \t\n\r]*([+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)(.?)", s or "")
    if not m:
        return 0
    x = float(m.group(1))
    suf = m.group(2)
    if suf in ("G", "g"):
        x *= 1e9
    elif suf in ("M", "m"):
        x *= 1e6
    elif suf in ("K", "k"):
        x *= 1e3
    return int(x + 0.499)


def _err(msg: str) -> int:
    print(f"ERROR: {msg}", file=sys.stderr)
    return 1


def seq_openable(fn: str) -> bool:
    """Whether rb3_seq_open would succeed (io.c:42-58): gzopen of the path, or
    stdin for '-'.  Callers print the reference's per-command error line."""
    if fn == "-":
        return True
    try:
        open(fn, "rb").close()
        return True
    except OSError:
        return False


class KetoptUnknown(Exception):
    """Raised in strict mode on an unknown option / missing argument."""


def ketopt(
    argv: list[str], ostr: str, longopts: list[str] = (), strict: bool = False
) -> tuple[list[tuple[str, str]], list[str]]:
    """ketopt.h-compatible option parsing (permuting; ketopt.h:57-121).

    Unlike gnu_getopt, unknown options and options with a missing argument are
    silently skipped — ketopt returns '?' / ':' for them and most reference
    commands' switches ignore those — so e.g. `merge -do out` behaves as
    `merge -o out`.  main_search (mem/sw/hapdiv/search, search.c:487-491) and
    fa2kmer (main.c:262-266) instead print "ERROR: unknown option" and abort;
    `strict=True` reproduces that (prints the message, raises KetoptUnknown).
    `longopts` uses the getopt convention ("name=" = has argument);
    unambiguous prefixes of long names are accepted like ketopt.  Returned
    pairs use getopt's ("-x", arg) / ("--name", arg) shape."""

    def bad():
        if strict:
            print("ERROR: unknown option", file=sys.stderr)
            raise KetoptUnknown()
    lo = [(s[:-1], True) if s.endswith("=") else (s, False) for s in longopts]
    opts: list[tuple[str, str]] = []
    args: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-") or a == "-":
            args.append(a)
            i += 1
            continue
        if a.startswith("--"):
            if a == "--":
                args.extend(argv[i + 1 :])
                break
            j = a.find("=", 2)
            name = a[2:] if j < 0 else a[2:j]
            exact = [o for o in lo if o[0] == name]
            partial = [o for o in lo if o[0].startswith(name) and o[0] != name]
            o = exact[0] if len(exact) == 1 else (partial[0] if not exact and len(partial) == 1 else None)
            if o is not None:
                arg = "" if j < 0 else a[j + 1 :]
                if o[1] and j < 0:
                    if i + 1 < len(argv):
                        i += 1
                        arg = argv[i]
                    else:
                        o = None  # ketopt ':' (missing argument) — skipped
                        bad()
                if o is not None:
                    opts.append(("--" + o[0], arg))
            else:
                bad()
            i += 1
            continue
        pos = 1
        while pos < len(a):
            c = a[pos]
            pos += 1
            k = ostr.find(c)
            if k < 0:
                bad()
                continue  # ketopt '?' (unknown option) — skipped
            if k + 1 < len(ostr) and ostr[k + 1] == ":":
                if pos < len(a):
                    opts.append(("-" + c, a[pos:]))
                elif i + 1 < len(argv):
                    i += 1
                    opts.append(("-" + c, argv[i]))
                else:
                    bad()  # ketopt ':' (missing argument) — skipped
                pos = len(a)
            else:
                opts.append(("-" + c, ""))
        i += 1
    return opts, args


# Per-command option help mirroring the reference's usage text (main.c:380-450,
# build.c:108-134, search.c:507-550); descriptions and defaults are kept
# identical where the flag is honored, with rb3jax-specific options appended.
_SEARCH_COMMON = """\
  -t INT      number of threads [4]
  -p INT      output up to INT positions [0]
  -L          one sequence per line in the input
  -K NUM      query batch size [100m]
  -M          use mmap to load FMD"""

_SW_SCORING = """\
  -N INT      keep up to INT hits per DAWG node [25]
  -m INT      min alignment score [30]
  -A INT      match score [1]
  -B INT      mismatch penalty [3]
  -O INT      gap open penalty [5]
  -E INT      gap extension penalty; a k-long gap costs O+k*E [2]
  -C NUM      size of the ranking cache [65536]
  -y INT      ignore secondary hits scored INT lower than the best [-1]"""

_USAGE = {
    "build": """Usage: rb3jax build [options] <in.fa> [...]
Options:
  Algorithm:
    -m NUM      batch size [7G]
    -t INT      total number of threads [4]
    -p INT      #threads for sais and run sais and merge together (more RAM) [0]
    -l INT      leaf block size in B+-tree [512]
    -n INT      max number children per internal node [64]
    -2          use the ropebwt2 algorithm (libsais by default)
    -s          build BWT in the reverse lexicographical order (RLO; force -2)
    -r          build BWT in RCLO (force -2)
  Input:
    -i FILE     read existing index from FILE []
    -L          one sequence per line in the input
    -F          no forward strand
    -R          no reverse strand
  Output:
    -o FILE     output to FILE [stdout]
    -d          dump in the fermi-delta format (FMD)
    -b          dump in the ropebwt format (FMR)
    -e          dump in the BRE format
    -T          output the index in the Newick format (for debugging)
    -S FILE     save the current index to FILE after each input file []
  Device:
    --mesh=DPxIDX  run the merge rank phase over a device mesh: LF lanes
                over DP devices, occ rows over IDX devices []""",
    "mem": f"""Usage: rb3jax mem [options] <idx.fmr> <seq.fa> [...]
Options:
  -l INT      min MEM length [19]
  -c INT      min interval size [1]
  --old-mem   use the original MEM algorithm (for testing)
  --gap=NUM   output regions >=NUM that are not covered by MEMs [0]
  --cov       output breadth of coverage
{_SEARCH_COMMON}
  --engine=STR  SMEM engine: auto (native), jax (device), native, py,
                hybrid (device + native concurrently on disjoint slices) [auto]
  --mesh=DPxIDX shard over a device mesh with --engine=jax: reads over DP
                devices, occ tables over IDX devices (e.g. --mesh=4x2) []
  --occ=STR     device occ rows: auto, dense, rb (run-aware compressed,
                the beyond-device-memory capacity format) [auto]""",
    "sw": f"""Usage: rb3jax sw [options] <idx.fmr> <seq.fa> [...]
Options:
{_SW_SCORING}
  -e          end-to-end mode (forcing -k to 1)
  -j INT      min MEM length to initiate alignment [0]
  -k INT      require INT-mer match at the end of alignment [11]
  -b          align both strands (effective with --all-e2e)
  -u          write unmapped queries to PAF
  --seq       write reference sequence to the rs tag
  --all-e2e   write all end-to-end hits in a compact format (forcing -e)
  -g INT      cap the number of --all-e2e output to INT (forcing --all-e2e)
  --no-ssa    ignore the sampled suffix array
{_SEARCH_COMMON}
  --engine=STR  DP engine: auto (native host), jax (device scoring +
                host backtrack), hybrid (device + native concurrently)
                [auto]
  --mesh=N      run the device DP data-parallel over N devices (reads over
                the dp axis, tables replicated; implies --engine=jax) []""",
    "hapdiv": f"""Usage: rb3jax hapdiv [options] <idx.fmr> <seq.fa> [...]
Options:
  -a INT      annotate sliding INT-mers [101]
  -w INT      k-mer step size for annotation [50]
{_SW_SCORING}
{_SEARCH_COMMON}
  --engine=STR  DP engine: auto (native host), jax (device DP),
                hybrid (device + native concurrently) [auto]
  --mesh=N      run the device DP data-parallel over N devices (windows over
                the dp axis, tables replicated; implies --engine=jax) []""",
    "search": "Usage: rb3jax search [options] <idx.fmr> <seq.fa> [...]",
    "merge": """Usage: rb3jax merge [options] <base.fmr> <other1.fmr> [...]
Options:
  -t INT     number of threads [1]
  -o FILE    output FMR to FILE [stdout]
  -S FILE    save the current index to FILE after each input file []""",
    "ssa": """Usage: rb3jax ssa [options] <in.fmd>
Options:
  -t INT     number of threads [4]
  -s INT     sample rate one SA per 2**INT bases [8]
  -o FILE    output to file [stdout]
  --mesh=DPxIDX  generate on a device mesh: LF-walk lanes shard over the
                 dp axis, each shard walking its lanes independently []""",
    "plain2fmd": "Usage: rb3jax plain2fmd [-o output.fmd] <in.txt>",
    "get": "Usage: rb3jax get <idx.fmr> <int> [...]",
    "stat": "Usage: rb3jax stat [-M] <idx.fmd>",
    "suffix": """Usage: rb3jax suffix [options] <idx.fmr> <seq.fa> [...]
Options:
  -L        one sequence per line in the input""",
    "kount": """Usage: rb3jax kount [options] <in1.fmd> [in2.fmd [...]]
Options:
  -k INT       k-mer length [51]
  -m INT       min k-mer occurrence [100]""",
    "fa2line": """Usage: rb3jax fa2line [options] <seq.fa> [...]
Options:
  -R        no reverse strand""",
    "fa2kmer": """Usage: rb3jax fa2kmer [options] <seq.fa> [...]
Options:
  -k INT      k-mer size [151]
  -w INT      step size [50]""",
}


# Number of leading help lines the reference prints to STDOUT (the rest go to
# stderr): search-family/suffix/fa2line/fa2kmer print the Usage line on stdout
# (search.c:508, main.c:179/227/269), merge prints everything except -S on
# stdout (main.c:98-102), get/stat/plain2fmd are stdout-only, and
# build/ssa/kount are stderr-only (build.c:170, ssa.c:261, main.c:360).
_UNKNOWN_CMD = 127  # sentinel: the only case where the reference exits nonzero

_USAGE_STDOUT_LINES = {
    "build": 0, "ssa": 0, "kount": 0,
    "mem": 1, "sw": 1, "hapdiv": 1, "search": 1,
    "suffix": 1, "fa2line": 1, "fa2kmer": 1,
    "merge": 4,
    "get": 1, "stat": 1, "plain2fmd": 1,
}


def _usage(cmd: str) -> int:
    lines = _USAGE[cmd].split("\n")
    n_out = _USAGE_STDOUT_LINES[cmd]
    if n_out:
        print("\n".join(lines[:n_out]))
    if lines[n_out:]:
        print("\n".join(lines[n_out:]), file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# Index loading
# ---------------------------------------------------------------------------


class IndexLoadError(Exception):
    pass


def load_runs(fn: str):
    """Auto-detect FMD/FMR/BRE by magic; return (syms, lens)."""
    from .formats import bre, fmd, fmr

    try:
        with open(fn, "rb") as fp:
            data = fp.read()
    except OSError as e:
        raise IndexLoadError(f"failed to load BWT from file \"{fn}\": {e.strerror}") from e
    if data[:4] == b"RLD\x03":
        _, syms, lens = fmd.decode_runs(data)
        return syms, lens
    if data[:3] == b"RB\x02":
        _, syms, lens = fmr.read_fmr_bytes(data)
        return syms, lens
    if data[:4] == b"BRE\x01":
        return bre.read_bre_bytes(data)
    raise IndexLoadError(f"failed to load BWT from file \"{fn}\": unrecognized format")


def load_index(fn: str, load_ssa: bool = False, load_sid: bool = False) -> DenseFMIndex:
    import os

    from . import log

    # Dense-table sidecar (the analog of the reference's mmap -M,
    # rld0.c:322-341): on by default, the first query load writes
    # `<index>.dense` and later loads are a single mmap.  RB3JAX_CACHE=0
    # disables both reading and writing it.
    from .index.sidecar import read_sidecar, write_sidecar

    cache_fn = fn + ".dense"
    use_cache = os.environ.get("RB3JAX_CACHE", "1") != "0"
    f = None
    if use_cache and os.path.exists(cache_fn) and os.path.getmtime(cache_fn) >= os.path.getmtime(fn):
        f = read_sidecar(cache_fn)
        if f is not None and getattr(f, "_sidecar_version", 2) == 1:
            # one-time upgrade to the v2 layout (2 MiB-aligned sections →
            # file-backed hugepage mapping, +17% native SMEM at 1.34G)
            try:
                write_sidecar(cache_fn, f)
                f = read_sidecar(cache_fn) or f
            except OSError:
                pass
    if f is None:
        syms, lens = load_runs(fn)
        f = DenseFMIndex.from_runs(syms, lens)
        if use_cache:
            try:
                write_sidecar(cache_fn, f)
            except OSError:
                pass
    log.info("loaded the BWT", func="load_index")
    if load_ssa and os.path.exists(fn + ".ssa"):
        from .formats.ssa import read_ssa

        f.ssa = read_ssa(fn + ".ssa")
        if f.ssa.m != int(f.acc[1]):
            print("ERROR: number of sequences do not match between BWT and sampled suffix array", file=sys.stderr)
            f.ssa = None
    if load_ssa and load_sid and os.path.exists(fn + ".len.gz"):
        sid = read_sid(fn + ".len.gz")
        if sid.n_seq * 2 != int(f.acc[1]):
            print("ERROR: number of sequences do not match between BWT and the sequence list", file=sys.stderr)
        else:
            f.sid = sid
    return f


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def main_build(argv: list[str]) -> int:
    from .construct import gsa_bwt, merge_plain

    opts, args = ketopt(argv, "l:n:m:t:2sri:LFRo:dbTS:p:e", ["mesh="])
    fmt = "plain"
    batch_size = 7_000_000_000
    user_m = False
    is_line = False
    is_for, is_rev = True, True
    fn_in = fn_tmp = None
    block_len, max_nodes = 512, 64
    use_rb2 = False
    sort_order = 0
    out_fn = None
    sais_threads = 0
    mesh = None
    for o, a in opts:
        if o == "--mesh":
            # DPxIDX device mesh: the merge rank phase runs sharded (LF lanes
            # over dp, occ rows over idx; parallel/merge_sharded.py)
            from .parallel.mesh import make_mesh

            dd, _, ii = a.lower().partition("x")
            mesh = make_mesh(int(dd), int(ii) if ii else 1)
        elif o == "-p":
            sais_threads = atoi(a)
        elif o == "-m":
            batch_size = parse_num(a)
            user_m = True
        elif o == "-l":
            block_len = atoi(a)
        elif o == "-n":
            max_nodes = atoi(a)
        elif o == "-2":
            use_rb2 = True
        elif o in ("-s", "-r"):
            use_rb2, sort_order = True, (1 if o == "-s" else 2)
        elif o == "-i":
            fn_in = a
        elif o == "-L":
            is_line = True
        elif o == "-F":
            is_for = False
        elif o == "-R":
            is_rev = False
        elif o == "-o":
            out_fn = a
        elif o == "-d":
            fmt = "fmd"
        elif o == "-b":
            fmt = "fmr"
        elif o == "-T":
            fmt = "tree"
        elif o == "-e":
            fmt = "bre"
        elif o == "-S":
            fn_tmp = a
    if not args and fn_in is None:
        return _usage("build")
    del use_rb2  # the sais path and the rb2 IO-order path produce the same BWT

    f: DenseFMIndex | None = None
    if fn_in is not None:
        if sort_order != 0:
            return _err("-s/-r cannot be combined with -i yet")
        f = load_index(fn_in)

    from . import log

    if not user_m and sort_order == 0:
        # auto-batching: the host SA-IS goes superlinear past its cache knee
        # (measured: 64M batch 7.5 s, 120M 16 s, 240M 62 s single vs 49 s at
        # -m60m, byte-equal), while total merge work grows with batch COUNT —
        # split large single batches at ~total/6, clamped to the measured
        # good range (2.4G was built at -m320m).  File sizes approximate
        # symbols (gzip inputs underestimate and may stay single-batch).
        try:
            est = sum(os.path.getsize(fn) for fn in args if fn != "-" and os.path.exists(fn))
        except OSError:
            est = 0
        est *= int(is_for) + int(is_rev)
        if est > 160_000_000:
            batch_size = min(max(est // 6, 48_000_000), 320_000_000)
            log.info("auto batch size %d for ~%d input symbols (pass -m to override)", batch_size, est, func="main_build")

    def batches():
        nonlocal n_batches
        for fn in args:
            if not seq_openable(fn):
                # build.c:209: report and move on to the next input
                print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
                continue
            strands = int(is_for) + int(is_rev)
            fb = iter_flat_batches(fn, is_line, max(1, batch_size // strands))
            if fb is not None:
                # vectorized reader + two-scatter batch assembly (no
                # per-record Python loop); batch boundaries may differ
                # slightly from the streaming reader's, which cannot change
                # any output (merge is order-preserving)
                for _names, bflat, boffs in fb:
                    n_seq, seq = batch_nt6_flat(bflat, boffs, is_for, is_rev)
                    if n_seq == 0:
                        continue
                    n_batches += 1
                    log.info("read %d symbols", len(seq), func="main_build")
                    if sort_order != 0:
                        if n_batches > 1:
                            raise IndexLoadError("-s/-r only supported within a single batch; raise -m")
                        seq = _sort_units(seq, sort_order)
                    yield seq
                yield None  # file boundary (for -S checkpointing)
                continue
            records = read_seqs(fn, is_line)
            while True:
                n_seq, seq = read_batch_nt6(records, batch_size, is_for, is_rev)
                if n_seq == 0:
                    break
                n_batches += 1
                log.info("read %d symbols", len(seq), func="main_build")
                if sort_order != 0:
                    if n_batches > 1:
                        raise IndexLoadError("-s/-r only supported within a single batch; raise -m")
                    seq = _sort_units(seq, sort_order)
                yield seq
            yield None  # file boundary (for -S checkpointing)

    # the first batch's raw BWT is kept as-is: dense occ tables are only
    # needed when further batches merge into it (or for -i), so a
    # single-batch build skips the table build entirely
    pending: np.ndarray | None = None

    def absorb(bwt):
        nonlocal f, pending
        log.info("constructed partial BWT for %d symbols", len(bwt), func="main_build")
        if f is None and pending is None:
            pending = bwt
        else:
            if pending is not None:
                f = DenseFMIndex.from_bwt(pending)
                pending = None
                log.info("encoded the partial BWT for %d symbols", f.n, func="main_build")
            f = merge_plain(f, bwt, mesh=mesh)
            log.info("merged the partial BWT for %d symbols", len(bwt), func="main_build")

    def checkpoint():
        if fn_tmp and (f is not None or pending is not None):
            from .formats.fmr import write_fmr

            syms, lens = _runs_of_bwt(pending) if pending is not None else f.to_runs()
            write_fmr(fn_tmp, syms, lens)
            log.info("saved the current index to '%s'", fn_tmp, func="main_build")

    n_batches = 0
    if sais_threads > 0:
        # overlapped pipeline (analog of build -p / kt_pipeline, build.c:55-83):
        # suffix-sort the next batch while merging the current one
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as ex:
            fut = None
            for seq in batches():
                if seq is None:
                    if fut is not None:
                        absorb(fut.result())
                        fut = None
                    checkpoint()
                    continue
                nf = ex.submit(gsa_bwt, seq)
                if fut is not None:
                    absorb(fut.result())
                fut = nf
            if fut is not None:
                absorb(fut.result())
                checkpoint()
    else:
        for seq in batches():
            if seq is None:
                checkpoint()
                continue
            absorb(gsa_bwt(seq))
    if f is None and pending is None:
        return 1
    _dump_index(pending if pending is not None else f, fmt, out_fn)
    return 0


def _sort_units(seq: np.ndarray, sort_order: int) -> np.ndarray:
    """Reorder the 0-terminated units of a batch for RLO/RCLO construction.

    The legacy inserter (mrope.c:300-385) places sentinels so sequences sort
    in reverse-lexicographic order (RLO, -s) or reverse-complement-lex order
    (RCLO, -r); since our GSA builder orders sentinels by position, permuting
    the units reproduces the same BWT."""
    from .nt6 import revcomp

    ends = np.flatnonzero(seq == 0)
    starts = np.concatenate(([0], ends[:-1] + 1))
    units = [seq[s:e] for s, e in zip(starts, ends)]
    if sort_order == 1:  # RLO
        keys = [u[::-1].tobytes() for u in units]
    else:  # RCLO
        keys = [revcomp(u).tobytes() for u in units]
    order = sorted(range(len(units)), key=lambda t: keys[t])
    zero = np.zeros(1, dtype=np.uint8)
    return np.concatenate([x for t in order for x in (units[t], zero)])


def _runs_of_bwt(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode a raw BWT array (same as DenseFMIndex.to_runs)."""
    if len(bwt) == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(bwt[1:] != bwt[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(bwt)]))
    return bwt[starts].copy(), (ends - starts).astype(np.int64)


def _dump_index(f: "DenseFMIndex | np.ndarray", fmt: str, out_fn: str | None) -> None:
    if isinstance(f, np.ndarray):
        raw = f
        syms, lens = _runs_of_bwt(raw)
    else:
        raw = f.bwt[: f.n]
        syms, lens = f.to_runs()
    out = sys.stdout.buffer if out_fn is None else open(out_fn, "wb")
    try:
        if fmt == "plain":
            write_all(out, nt6_to_str(raw).encode() + b"\n")
        elif fmt == "fmd":
            from .formats.fmd import encode_runs

            write_all(out, encode_runs(syms, lens))
        elif fmt == "fmr":
            from .formats.fmr import split_runs_into_buckets, write_fmr_bytes

            write_all(out, write_fmr_bytes(split_runs_into_buckets(syms, lens)))
        elif fmt == "bre":
            from .formats.bre import write_bre_bytes

            write_all(out, write_bre_bytes(syms, lens))
        elif fmt == "tree":
            from .formats.fmr import split_runs_into_buckets, _pack_leaves, rle_decode_block

            chunks = []
            for bs, bl in split_runs_into_buckets(syms, lens):
                leaves = _pack_leaves(bs, bl, 512)
                inner = ",".join("".join(nt6_to_str(np.repeat(c, l)) for c, l in rle_decode_block(d)) for d, _ in leaves)
                chunks.append("(" + inner + ")")
            write_all(out, ("".join(chunks) + "\n").encode())
    finally:
        if out_fn is not None:
            out.close()


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def main_merge(argv: list[str]) -> int:
    from .construct.merge import merge_plain

    opts, args = ketopt(argv, "t:o:S:")
    out_fn = fn_tmp = None
    for o, a in opts:
        if o == "-o":
            out_fn = a
        elif o == "-S":
            fn_tmp = a
    if len(args) < 2:
        return _usage("merge")
    f = load_index(args[0])
    from .formats.fmr import write_fmr

    for fn in args[1:]:
        syms, lens = load_runs(fn)
        seq2 = np.repeat(syms, lens)
        f = merge_plain(f, seq2)
        if fn_tmp:
            s, l = f.to_runs()
            write_fmr(fn_tmp, s, l)
    s, l = f.to_runs()
    write_fmr(out_fn if out_fn else "-", s, l)
    return 0


# ---------------------------------------------------------------------------
# ssa
# ---------------------------------------------------------------------------


def main_ssa(argv: list[str]) -> int:
    from .formats.ssa import write_ssa
    from .ssa_ops import ssa_gen

    opts, args = ketopt(argv, "t:s:o:", ["mesh="])
    ssa_shift, out_fn, mesh = 8, None, None
    for o, a in opts:
        if o == "-s":
            ssa_shift = atoi(a)
        elif o == "--mesh":
            from .parallel.mesh import make_mesh

            dd, _, ii = a.lower().partition("x")
            mesh = make_mesh(int(dd), int(ii) if ii else 1)
        elif o == "-o":
            out_fn = a
    if not args:
        return _usage("ssa")
    f = load_index(args[0])
    sa = None
    if mesh is not None:
        from .ssa_ops import ssa_gen_device

        sa = ssa_gen_device(f, ssa_shift, mesh=mesh)
    if sa is None:
        try:
            from .ssa_ops import ssa_gen_native

            sa = ssa_gen_native(f, ssa_shift)
        except Exception:
            pass
    if sa is None:
        if int(f.acc[1]) >= 2048 and f.n < (1 << 31) - (1 << 20):
            from .ssa_ops import ssa_gen_device

            try:
                sa = ssa_gen_device(f, ssa_shift)
            except Exception:
                sa = ssa_gen(f, ssa_shift)
        else:
            sa = ssa_gen(f, ssa_shift)
    write_ssa(out_fn if out_fn else "-", sa)
    return 0


# ---------------------------------------------------------------------------
# plain2fmd
# ---------------------------------------------------------------------------


def main_plain2fmd(argv: list[str]) -> int:
    from .formats.fmd import FMDEncoder

    opts, args = ketopt(argv, "o:")
    out_fn = None
    for o, a in opts:
        if o == "-o":
            out_fn = a
    if not args:
        return _usage("plain2fmd")
    enc = FMDEncoder()
    for fn in args:
        fp = sys.stdin.buffer if fn == "-" else open(fn, "rb")
        data = fp.read()
        if fn != "-":
            fp.close()
        a = np.frombuffer(data, dtype=np.uint8)
        # '\n' and '$' -> 0, otherwise nt6 (main.c:320-326)
        codes = NT6_TABLE[a].copy()
        codes[(a == ord("\n")) | (a == ord("$"))] = 0
        # run-length encode
        if len(codes):
            change = np.flatnonzero(codes[1:] != codes[:-1]) + 1
            starts = np.concatenate(([0], change))
            ends = np.concatenate((change, [len(codes)]))
            enc.put_runs(codes[starts], ends - starts)
    enc.finish()
    out = sys.stdout.buffer if out_fn is None else open(out_fn, "wb")
    write_all(out, enc.dump_bytes())
    if out_fn is not None:
        out.close()
    return 0


# ---------------------------------------------------------------------------
# get / stat / suffix / kount
# ---------------------------------------------------------------------------


def main_get(argv: list[str]) -> int:
    opts, args = ketopt(argv, "")
    if len(args) < 2:
        _usage("get")
        return 0
    f = load_index(args[0])
    for s in args[1:]:
        k = atoi(s)  # atol in the reference (main.c:155): garbage parses as 0
        if 0 <= k < f.n:
            seq, r = f.retrieve(k)
            print(f">{k} {r}")
            print(nt6_to_str(seq))
    return 0


def main_stat(argv: list[str]) -> int:
    opts, args = ketopt(argv, "M")
    if not args:
        _usage("stat")
        return 0
    f = load_index(args[0])
    a = f.acc
    print(f"{a[1]} sequences")
    print(f"{a[6]} symbols")
    print(f"{f.n_runs} runs")
    print(f"{a[2]-a[1]} A")
    print(f"{a[3]-a[2]} C")
    print(f"{a[4]-a[3]} G")
    print(f"{a[5]-a[4]} T")
    print(f"{a[6]-a[5]} N")
    return 0


def main_suffix(argv: list[str]) -> int:
    opts, args = ketopt(argv, "L")
    is_line = any(o == "-L" for o, _ in opts)
    if len(args) < 2:
        _usage("suffix")
        return 0
    f = load_index(args[0])
    acc = f.acc.astype(np.int64)

    def flush(batch: list[tuple[str, np.ndarray]]) -> None:
        """Backward-search all reads lock-step (one batched rank per step for
        the whole batch, main.c main_suffix semantics) and print per read:
        name, start of the longest matching suffix, length, interval size."""
        m = len(batch)
        lens = np.fromiter((len(q) for _, q in batch), np.int64, m)
        Lmax = int(lens.max()) if m else 0
        qpad = np.zeros((m, max(1, Lmax)), np.uint8)
        for t, (_, q) in enumerate(batch):
            qpad[t, : len(q)] = q
        k = np.zeros(m, np.int64)
        l = np.full(m, int(f.acc[6]), np.int64)
        i = lens - 1
        last = np.zeros(m, np.int64)
        active = i >= 0
        while active.any():
            ids = np.nonzero(active)[0]
            r = f.rank1a_fast(np.concatenate([k[ids], l[ids]]))
            c = qpad[ids, i[ids]].astype(np.int64)
            na = len(ids)
            ar = np.arange(na)
            nk = acc[c] + r[:na][ar, c]
            nl = acc[c] + r[na:][ar, c]
            k[ids], l[ids] = nk, nl
            alive = nl - nk > 0
            last[ids[alive]] = (nl - nk)[alive]
            i[ids[alive]] -= 1
            active[ids[~alive]] = False
            active &= i >= 0
        for t, (name, q) in enumerate(batch):
            print(f"{name}\t{i[t]+1}\t{len(q)}\t{last[t]}")

    rec_num = 0
    batch: list[tuple[str, np.ndarray]] = []
    for fn in args[1:]:
        if not seq_openable(fn):
            # the reference crashes here (main.c main_suffix has no NULL
            # check); a clean error is strictly better
            print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
            continue
        fb = iter_flat_batches(fn, is_line, 1 << 62)
        if fb is not None:
            for names, bflat, boffs in fb:
                for i in range(len(names)):
                    rec_num += 1
                    batch.append((names[i] if names[i] else f"seq{rec_num}", bflat[boffs[i] : boffs[i + 1]]))
                    if len(batch) >= 20000:
                        flush(batch)
                        batch = []
            continue
        for rec in read_seqs(fn, is_line):
            rec_num += 1
            batch.append((rec.name if rec.name else f"seq{rec_num}", char2nt6(rec.seq)))
            if len(batch) >= 20000:
                flush(batch)
                batch = []
    flush(batch)
    return 0


def main_kount(argv: list[str]) -> int:
    opts, args = ketopt(argv, "k:m:")
    depth, min_occ = 51, 100
    for o, a in opts:
        if o == "-k":
            depth = atoi(a)
        elif o == "-m":
            min_occ = atoi(a)
    if not args:
        return _usage("kount")
    idx = [load_index(fn) for fn in args]
    n = len(idx)
    if depth <= 0:
        return 0
    # Level-order vectorized expansion of the reference's k-mer DFS: the node
    # set is identical (a branch survives when ANY index reaches min_occ),
    # with one batched rank per level per index instead of a scalar rank per
    # node (~100x on pangenome-scale tries).  Emission is re-sorted into the
    # reference's exact DFS order: children are pushed ascending and popped
    # off a stack (descending) at every internal level, while the final level
    # prints ascending — i.e. lexicographic with the first-chosen symbol
    # descending down to the last-chosen ascending.
    ks = [np.zeros(1, np.int64) for _ in idx]
    ls = [np.full(1, int(f.acc[6]), np.int64) for f in idx]
    chars = np.zeros((1, 0), np.uint8)  # (nodes, level) chosen symbols
    leaf_occ = None
    for d in range(depth):
        rr = [f.rank1a_fast(np.concatenate([ks[i], ls[i]])) for i, f in enumerate(idx)]
        oks = [r[: len(r) // 2] for r in rr]
        ols = [r[len(r) // 2 :] for r in rr]
        occ = [ol - ok for ok, ol in zip(oks, ols)]  # (nodes, 6) each
        keep = occ[0][:, 1:5] >= min_occ
        for i in range(1, n):
            keep |= occ[i][:, 1:5] >= min_occ  # (nodes, 4)
        node_i, a_i = np.nonzero(keep)
        a = (a_i + 1).astype(np.int64)
        chars = np.concatenate([chars[node_i], (a_i + 1).astype(np.uint8)[:, None]], axis=1)
        if d == depth - 1:
            leaf_occ = np.stack([occ[i][node_i, a] for i in range(n)], axis=1)
            break
        for i, f in enumerate(idx):
            ks[i] = f.acc[a] + oks[i][node_i, a]
            ls[i] = f.acc[a] + ols[i][node_i, a]
        if len(node_i) == 0:
            return 0
    if leaf_occ is None or len(chars) == 0:
        return 0
    # np.lexsort: last key is primary -> first-chosen symbol descending, ...,
    # last level ascending
    keys = [chars[:, depth - 1]] + [-(chars[:, j].astype(np.int16)) for j in range(depth - 2, -1, -1)]
    order = np.lexsort(keys)
    strs = np.frombuffer(b"$ACGTN", np.uint8)[chars[:, ::-1]]
    w = sys.stdout.write
    for t in order:
        w(strs[t].tobytes().decode() + "\t" + "\t".join(str(int(c)) for c in leaf_occ[t]) + "\n")
    return 0


# ---------------------------------------------------------------------------
# fa2line / fa2kmer
# ---------------------------------------------------------------------------


def main_fa2line(argv: list[str]) -> int:
    opts, args = ketopt(argv, "R")
    no_rev = any(o == "-R" for o, _ in opts)
    # opportunistically (re)build the standalone binary the bin/rb3jax
    # launcher execs on SUBSEQUENT runs (hash-cached; ~1 s once)
    try:
        from .native import ensure_fa2line

        ensure_fa2line()
    except Exception:
        pass
    if not args:
        _usage("fa2line")
        return 0
    tab = np.frombuffer(b"\nACGTX", dtype=np.uint8)
    for fn in args:
        if not seq_openable(fn):
            print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
            continue
        fb = iter_flat_batches(fn, False, 1 << 26)
        if fb is not None:
            for _names, bflat, boffs in fb:
                nrec = len(boffs) - 1
                if nrec and len(bflat) >= (nrec << 8):
                    # long records: two whole-buffer maps + per-record slice
                    # views beat the interleaving scatter (record i's rc line
                    # is a contiguous window of the globally reversed buffer)
                    fwd = tab[bflat]
                    parts: list[bytes] = []
                    if no_rev:
                        for i in range(nrec):
                            parts += [fwd[boffs[i] : boffs[i + 1]].tobytes(), b"\n"]
                    else:
                        crev = tab[COMP_TABLE[bflat]][::-1]
                        T = len(bflat)
                        for i in range(nrec):
                            parts += [
                                fwd[boffs[i] : boffs[i + 1]].tobytes(), b"\n",
                                crev[T - boffs[i + 1] : T - boffs[i]].tobytes(), b"\n",
                            ]
                    write_all(sys.stdout.buffer, b"".join(parts))
                    continue
                # the [fwd, 0][, rc, 0] construction layout IS the fa2line
                # output under the "\nACGTX" map (separators = line breaks)
                _, seq = batch_nt6_flat(bflat, boffs, True, not no_rev)
                write_all(sys.stdout.buffer, tab[seq].tobytes())
            continue
        for rec in read_seqs(fn, False):
            s = char2nt6(rec.seq)
            sys.stdout.buffer.write(tab[s].tobytes() + b"\n")
            if not no_rev:
                sys.stdout.buffer.write(tab[revcomp(s)].tobytes() + b"\n")
    return 0


def main_fa2kmer(argv: list[str]) -> int:
    try:
        opts, args = ketopt(argv, "k:w:", strict=True)
    except KetoptUnknown:
        return 1
    kmer, step = 151, 50
    for o, a in opts:
        if o == "-k":
            kmer = atoi(a)
        elif o == "-w":
            step = atoi(a)
    if not args:
        _usage("fa2kmer")
        return 0
    if step <= 0:
        # the reference walks i += step unguarded and segfaults on a negative
        # seq[i] read (main.c fa2kmer loop); ours must not hang (fuzz 10141)
        print(f"ERROR: step size must be positive, got {step}", file=sys.stderr)
        return 1
    for fn in args:
        if not seq_openable(fn):
            print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
            continue
        buf: list[bytes] = []
        for rec in read_seqs(fn, False):
            seq, L = rec.seq, len(rec.seq)
            name = (rec.name or "").encode()
            i = 0
            while i < L:
                en = L if i + step + kmer > L else i + kmer
                buf.append(b">%s:%d-%d\n%s\n" % (name, i + 1, en, seq[i:en]))
                if en == L:
                    break
                i += step
            if len(buf) >= 65536:
                write_all(sys.stdout.buffer, b"".join(buf))
                buf.clear()
        write_all(sys.stdout.buffer, b"".join(buf))
    return 0


# ---------------------------------------------------------------------------
# mem / search / sw / hapdiv
# ---------------------------------------------------------------------------

_LONG_OPTS = ["no-ssa", "seq", "gap=", "cov", "old-mem", "all-e2e", "no-kalloc", "dbg-dawg", "dbg-sw", "dbg-qname", "dbg-bt", "engine=", "mesh=", "occ="]


def main_search(argv: list[str], cmd: str, _preloaded=None) -> int:
    """_preloaded: (index_path, DenseFMIndex, engine-or-None) — the resident
    server (server.py) re-enters here with its warm index/engine."""
    try:
        opts, args = ketopt(argv, "Ll:c:t:K:MdN:A:B:O:E:C:m:k:uj:ey:a:w:p:bg:", _LONG_OPTS, strict=True)
    except KetoptUnknown:
        return 1
    is_line = False
    algo = "mem_tg"
    min_len, min_occ = 19, 1
    min_gap_len = 0
    max_pos = 0
    write_cov = False
    no_ssa = False
    engine = "auto"
    mesh_spec = None
    occ = "auto"
    batch_size = 100_000_000
    hapdiv_k, hapdiv_w = 101, 50
    sw_opts = {
        "n_best": 25, "min_sc": 30, "match": 1, "mis": 3, "gap_open": 5, "gap_ext": 2,
        "end_len": 11, "min_mem_len": 0, "e2e_drop": -1, "r2cache_size": 0x10000,
        "max_pos": 0, "e2e": False, "keep_rs": False, "write_all": False, "max_all_out": 0,
        "both_dir": False, "write_unmap": False,
    }
    for o, a in opts:
        if o == "-L":
            is_line = True
        elif o == "-a":
            algo, hapdiv_k = "hapdiv", atoi(a)
        elif o == "-w":
            algo, hapdiv_w = "hapdiv", atoi(a)
        elif o == "-d":
            algo = "sw"
        elif o == "-l":
            min_len = atoi(a)
        elif o == "-c":
            min_occ = atoi(a)
        elif o == "-g":
            sw_opts["max_all_out"] = atoi(a)
            sw_opts["write_all"] = True
            sw_opts["e2e"] = True
            sw_opts["end_len"] = 1
            no_ssa = True
        elif o == "-K":
            batch_size = parse_num(a)
        elif o == "-p":
            max_pos = sw_opts["max_pos"] = atoi(a)
        elif o == "-N":
            sw_opts["n_best"] = atoi(a)
        elif o == "-A":
            sw_opts["match"] = atoi(a)
        elif o == "-B":
            sw_opts["mis"] = atoi(a)
        elif o == "-O":
            sw_opts["gap_open"] = atoi(a)
        elif o == "-E":
            sw_opts["gap_ext"] = atoi(a)
        elif o == "-C":
            sw_opts["r2cache_size"] = parse_num(a)
        elif o == "-m":
            sw_opts["min_sc"] = atoi(a)
        elif o == "-k":
            sw_opts["end_len"] = atoi(a)
        elif o == "-j":
            sw_opts["min_mem_len"] = atoi(a)
        elif o == "-e":
            sw_opts["e2e"] = True
            sw_opts["end_len"] = 1
        elif o == "-y":
            sw_opts["e2e_drop"] = atoi(a)
        elif o == "-u":
            sw_opts["write_unmap"] = True
        elif o == "-b":
            sw_opts["both_dir"] = True
        elif o == "--no-ssa":
            no_ssa = True
        elif o == "--seq":
            sw_opts["keep_rs"] = True
        elif o == "--gap":
            min_gap_len = parse_num(a)
        elif o == "--cov":
            write_cov = True
        elif o == "--old-mem":
            algo = "mem_ori"
        elif o == "--all-e2e":
            sw_opts["write_all"] = True
            sw_opts["e2e"] = True
            sw_opts["end_len"] = 1
            no_ssa = True
        elif o == "--engine":
            engine = a
        elif o == "--mesh":
            mesh_spec = a
        elif o == "--occ":
            # device occ row format: dense fused rows (speed) or rb
            # run-aware compressed rows (ops/runblock.py, capacity); auto
            # picks rb once dense rows would crowd the device's memory
            # limit (ops/smem.auto_occ)
            if a not in ("auto", "dense", "rb"):
                raise getopt.GetoptError(f"invalid --occ value '{a}' (auto|dense|rb)")
            occ = a
        elif o in ("--dbg-dawg", "--dbg-sw", "--dbg-qname", "--dbg-bt"):
            from .align import bwasw as _bw

            _bw.dbg_flag |= {"--dbg-dawg": 1, "--dbg-sw": 2, "--dbg-qname": 4, "--dbg-bt": 8}[o]

    if min_gap_len > 0:
        max_pos = 0
    load_all = False
    if cmd == "sw":
        algo = "sw"
        load_all = not no_ssa
    elif cmd == "hapdiv":
        algo = "hapdiv"
        sw_opts["end_len"] = 1
        sw_opts["e2e"] = True
    elif cmd == "mem":
        if max_pos > 0:
            load_all = True
    if algo == "sw" and cmd == "search":
        load_all = load_all or not no_ssa

    if len(args) < 2:
        return _usage(cmd)

    if _preloaded is not None:
        srv_path, f, srv_eng = _preloaded
        import os as _os

        if _os.path.realpath(args[0]) != _os.path.realpath(srv_path):
            return _err(f"server holds '{srv_path}', not '{args[0]}'")
    else:
        srv_eng = None
        # a resident server (rb3jax serve) holding this index answers mem
        # requests with its engine and programs already warm; route there
        route_srv = (algo == "mem_tg" and engine in ("auto", "server", "hybrid")) or (
            # device sw/hapdiv engines pay their compiles once per process;
            # a resident server holds them warm.  auto stays local (the
            # native host engine needs no warmup)
            algo in ("sw", "hapdiv") and engine in ("jax", "hybrid", "server")
        )
        if cmd != "search" and route_srv:
            from .server import client_run, server_available

            if server_available(args[0]):
                try:
                    return client_run(args[0], argv, cmd=cmd)
                except Exception as e:
                    if engine == "server":
                        return _err(f"server request failed: {e}")
            elif engine == "server":
                return _err(f"no server for '{args[0]}' (start one: rb3jax serve {args[0]})")
            elif engine == "auto" and algo == "mem_tg":
                # opt-in (RB3JAX_AUTO_SERVE=1): spawn the warm-engine daemon
                # in the background; THIS request continues locally
                from .server import maybe_autospawn

                maybe_autospawn(args[0])
        f = load_index(args[0], load_ssa=load_all, load_sid=load_all)
    if max_pos > 0 and (f.ssa is None or f.sid is None):
        return _err("failed to load suffix array samples or sequence names/lengths")
    if not f.is_symmetric():
        return _err("BWT doesn't contain both strands")

    if algo in ("sw", "hapdiv"):
        from .align.cli_hooks import run_sw_cli, run_hapdiv_cli

        if algo == "sw":
            return run_sw_cli(f, args[1:], is_line, sw_opts, engine=engine, dev_cache=srv_eng, mesh_spec=mesh_spec)
        return run_hapdiv_cli(f, args[1:], is_line, sw_opts, hapdiv_k, hapdiv_w, engine=engine, dev_cache=srv_eng, mesh_spec=mesh_spec)

    return _run_mem(f, args[1:], is_line, algo, min_occ, min_len, min_gap_len, write_cov, max_pos, engine, batch_size, mesh_spec, jax_eng=srv_eng, occ=occ)


def _emit_hybrid(emit_flat, names, offs, nd, fd, fnat):
    """Emit one hybrid batch in input order: device slice (reads 0..nd-1)
    first, then the native slice."""
    if fd is not None:
        cd, rd = fd.result()
        emit_flat(names[:nd], offs[: nd + 1], cd, rd)
    cn, rn = fnat.result()
    emit_flat(names[nd:], offs[nd:] - offs[nd], cn, rn)


def _run_mem(f, files, is_line, algo, min_occ, min_len, min_gap_len, write_cov, max_pos, engine, batch_size, mesh_spec=None, jax_eng=None, occ="auto") -> int:
    out = sys.stdout
    if mesh_spec and engine == "auto":
        engine = "jax"  # --mesh only means anything on the sharded engine
    if jax_eng is not None and algo == "mem_tg":
        if engine in ("auto", "server"):
            # server-side: device and native host engines share each batch
            # (hybrid); pure device if the native lib is missing
            from .ops.smem_native import native_smem_lib

            engine = "hybrid" if native_smem_lib() is not None else "jax"
        elif engine != "hybrid":
            engine = "jax"  # resident server engine (server.py)
        if hasattr(jax_eng, "engine_for"):
            jax_eng = jax_eng.engine_for(min_occ, min_len)
    else:
        jax_eng = None
    seq_id = 0
    native_batch = None
    if engine in ("auto", "native", "hybrid") and algo == "mem_tg":
        from .ops.smem_native import native_smem_lib, smem_tg_batch_native

        if native_smem_lib() is not None:
            native_batch = smem_tg_batch_native
        elif engine in ("native", "hybrid"):
            raise RuntimeError("native SMEM engine unavailable")
    # device engine, created lazily and only when asked for (--engine=jax or
    # hybrid, or by the resident server); failing to build it is an error
    _jax_state: dict = {"eng": jax_eng if algo == "mem_tg" else None, "wanted": engine in ("jax", "hybrid") and algo == "mem_tg"}

    def jax_engine():
        if _jax_state["eng"] is None and _jax_state["wanted"]:
            from .ops.smem import BatchedSmemTG

            mesh = None
            if mesh_spec:
                # --mesh DPxIDX (e.g. 4x2): reads data-parallel over dp,
                # occ tables sharded over idx (parallel/mesh.py)
                from .parallel.mesh import make_mesh

                dd, _, ii = mesh_spec.lower().partition("x")
                mesh = make_mesh(int(dd), int(ii) if ii else 1)
            _jax_state["eng"] = BatchedSmemTG(f, min_occ=min_occ, min_len=min_len, mesh=mesh, occ=occ)
        return _jax_state["eng"]

    from .ops import smem_ref

    for fn in files:
        if not seq_openable(fn):
            # search.c:571-575: report and stop processing further files
            print(f"ERROR: failed to load the sequence file '{fn}'", file=sys.stderr)
            break
        batch: list = []

        def emit_flat(names, offs, counts, rows):
            """Vectorized-reader fast path: BED lines are written from the
            raw (counts, rows) arrays — no per-read arrays or Mem objects."""
            nonlocal seq_id
            counts_l = counts.tolist()
            if min_gap_len > 0 or write_cov:
                # reuse the Mem-list writer for the rarer report modes
                from .ops.smem_ref import Mem

                rows_l = rows.tolist()
                all_mems, k = [], 0
                for c in counts_l:
                    all_mems.append([Mem(*r) for r in rows_l[k : k + c]])
                    k += c
                write_records([(names[i], int(offs[i + 1] - offs[i])) for i in range(len(names))], all_mems, None)
                return
            pos_iter = None
            if max_pos > 0:
                from .ssa_ops import ssa_multi, ssa_multi_batch

                reqs = [(int(lo), int(lo + sz), max_pos) for _, _, sz, lo, _ in rows.tolist()]
                got = ssa_multi_batch(f, f.ssa, reqs)
                if got is None:  # native locate unavailable: per-request walk
                    got = [ssa_multi(f, f.ssa, lo, hi, cap) for lo, hi, cap in reqs]
                pos_iter = iter(got)
            rows_l = rows.tolist()
            k = 0
            buf: list[str] = []
            for i, c in enumerate(counts_l):
                seq_id += 1
                nm = names[i] if names[i] else f"seq{seq_id}"
                for r in rows_l[k : k + c]:
                    if pos_iter is None:
                        buf.append(f"{nm}\t{r[0]}\t{r[1]}\t{r[2]}\n")
                    else:
                        buf.append(_mem_line(nm, r[0], r[1], r[2], r[3], next(pos_iter)) + "\n")
                k += c
                if len(buf) >= 65536:
                    write_all(out, "".join(buf))
                    buf.clear()
            write_all(out, "".join(buf))

        def _mem_line(nm, st, en, sz, lo, pos):
            line = f"{nm}\t{st}\t{en}\t{sz}"
            if pos:  # n_pos column only when > 0 (search.c:305)
                line += f"\t{len(pos)}"
            for sid, p in pos:
                rlen = int(f.sid.lens[sid >> 1])
                pp = rlen - (p + (en - st)) if sid & 1 else p
                line += f"\t{f.sid.names[sid>>1]}:{'+-'[sid&1]}:{pp}"
            return line

        def write_records(names_lens, all_mems, pos_iter):
            nonlocal seq_id
            for (name, L), mems in zip(names_lens, all_mems):
                seq_id += 1
                nm = name if name else f"seq{seq_id}"
                if min_gap_len > 0:
                    last = 0
                    gaps = []
                    for m in mems:
                        if m.start > last:
                            if m.start - last >= min_gap_len:
                                gaps.append((last, m.start))
                            last = m.end
                        else:
                            last = max(last, m.end)
                    if L - last >= min_gap_len:
                        gaps.append((last, L))
                    for st, en in gaps:
                        out.write(f"{nm}\t{st}\t{en}\t{L}\n")
                elif write_cov:
                    st0 = en0 = cov = 0
                    for m in mems:
                        if m.start > en0:
                            cov += en0 - st0
                            st0, en0 = m.start, m.end
                        else:
                            en0 = max(en0, m.end)
                    cov += en0 - st0
                    if cov > 0:
                        out.write(f"{nm}\t{L}\t{cov}\n")
                else:
                    for m in mems:
                        if max_pos > 0:
                            if pos_iter is not None:
                                pos = next(pos_iter)
                            else:
                                from .ssa_ops import ssa_multi

                                pos = ssa_multi(f, f.ssa, m.lo, m.lo + m.size, max_pos)
                        else:
                            pos = None
                        if pos is None:
                            out.write(f"{nm}\t{m.start}\t{m.end}\t{m.size}\n")
                        else:
                            out.write(_mem_line(nm, m.start, m.end, m.size, m.lo, pos) + "\n")

        def flush(batch):
            if not batch:
                return
            qs = [q for _, q in batch]
            # auto = the native host engine (the Python reference without
            # it); the device engine runs only when asked for
            if jax_engine() is not None:
                all_mems = jax_engine().run(qs)
            elif native_batch is not None:
                all_mems = native_batch(f, qs, min_occ, min_len)
            else:
                fn_algo = smem_ref.smem_tg if algo == "mem_tg" else smem_ref.smem_orig
                all_mems = [fn_algo(f, q, min_occ, min_len) for _, q in batch]
            pos_iter = None
            if max_pos > 0 and min_gap_len == 0 and not write_cov:
                # batch every MEM's multi-locate through the native core
                from .ssa_ops import ssa_multi_batch

                reqs = [(m.lo, m.lo + m.size, max_pos) for mems in all_mems for m in mems]
                got = ssa_multi_batch(f, f.ssa, reqs)
                if got is not None:
                    pos_iter = iter(got)
            write_records([(name, len(q)) for name, q in batch], all_mems, pos_iter)

        batches = None
        if native_batch is not None and engine in ("native", "auto", "hybrid"):
            from .seqio import iter_flat_batches

            batches = iter_flat_batches(fn, is_line, batch_size)
        if batches is not None and engine == "hybrid":
            # device and native engines run CONCURRENTLY on disjoint read
            # slices of each flat batch (same scheme as hapdiv --engine=
            # hybrid): the native DP releases the GIL on its threads while
            # the device chews its share; the split adapts to measured rates.
            import os as _os
            import time as _t

            from concurrent.futures import ThreadPoolExecutor

            from .ops.smem_native import smem_tg_flat_native

            share = float(_os.environ.get("RB3JAX_MEM_SPLIT", "0.35"))
            jax_engine()  # a device engine that cannot be built fails here
            rates = {"dev": None, "nat": None}

            def dev_run(flat, offs, nd):
                t0 = _t.perf_counter()
                qs = [flat[offs[i] : offs[i + 1]] for i in range(nd)]
                mems = jax_engine().run(qs)
                counts = np.fromiter((len(l) for l in mems), np.int64, nd)
                rows = np.array(
                    [[m.start, m.end, m.size, m.lo, m.lo_rc] for l in mems for m in l],
                    np.int64,
                ).reshape(-1, 5)
                rates["dev"] = nd / max(_t.perf_counter() - t0, 1e-6)
                return counts, rows

            def nat_run(flat, offs, nd):
                t0 = _t.perf_counter()
                sub = np.ascontiguousarray(flat[offs[nd] :])
                counts, rows = smem_tg_flat_native(f, sub, np.ascontiguousarray(offs[nd:] - offs[nd]), min_occ, min_len)
                rates["nat"] = (len(offs) - 1 - nd) / max(_t.perf_counter() - t0, 1e-6)
                return counts, rows

            with ThreadPoolExecutor(2) as ex:
                pend = None
                for names, flat, offs in batches:
                    nd = int(len(names) * share)
                    fd = ex.submit(dev_run, flat, offs, nd) if nd else None
                    fnat = ex.submit(nat_run, flat, offs, nd)
                    if pend is not None:
                        _emit_hybrid(emit_flat, *pend)
                    pend = (names, offs, nd, fd, fnat)
                    if rates["dev"] and rates["nat"]:
                        share = min(0.8, max(0.05, rates["dev"] / (rates["dev"] + rates["nat"])))
                if pend is not None:
                    _emit_hybrid(emit_flat, *pend)
            continue
        if batches is not None:
            # pipeline: the native call releases the GIL, so batch i's emit
            # (Python formatting + writes) overlaps batch i+1's compute
            from concurrent.futures import ThreadPoolExecutor

            from .ops.smem_native import smem_tg_flat_native

            with ThreadPoolExecutor(1) as ex:
                pend = None
                for names, flat, offs in batches:
                    nxt = (names, offs, ex.submit(smem_tg_flat_native, f, flat, offs, min_occ, min_len))
                    if pend is not None:
                        counts, rows = pend[2].result()
                        emit_flat(pend[0], pend[1], counts, rows)
                    pend = nxt
                if pend is not None:
                    counts, rows = pend[2].result()
                    emit_flat(pend[0], pend[1], counts, rows)
            continue
        tot = 0
        for rec in read_seqs(fn, is_line):
            q = char2nt6(rec.seq)
            batch.append((rec.name, q))
            tot += len(q)
            if tot >= batch_size:
                flush(batch)
                batch, tot = [], 0
        flush(batch)
    return 0


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import os as _os

    if _os.environ.get("JAX_COORDINATOR_ADDRESS"):
        # multi-host run (SURVEY §2.6): bring up jax.distributed before any
        # backend touch; meshes then span all processes and only process 0
        # writes stdout (see _primary_process)
        from .parallel.launch import init_distributed

        init_distributed()
        import jax as _jax

        if _jax.process_index() > 0:
            # SPMD: every process computes identically; only process 0 owns
            # the output stream (stderr logs stay per-process); raw fd 1 also
            # moves to stderr so native-library prints (gloo) stay out
            sys.stdout.flush()
            _os.dup2(2, 1)
            sys.stdout = open(_os.devnull, "w")
        else:
            # gloo (the CPU collective backend) prints a connection banner
            # straight to fd 1 at the first collective; keep a private dup
            # for the CLI's output and point raw fd 1 at stderr so stray
            # native prints cannot pollute the byte-exact stdout contract
            sys.stdout.flush()
            _out_fd = _os.dup(1)
            _os.dup2(2, 1)
            sys.stdout = _os.fdopen(_out_fd, "w")
    try:
        ret = _dispatch(argv)
        if ret == 0 and len(argv) > 1:
            from . import log

            log.footer(argv, REF_VERSION)
    except IndexLoadError as e:
        ret = _err(str(e))
    except BrokenPipeError:
        ret = 0
    except getopt.GetoptError as e:
        ret = _err(str(e))
    # The reference's main() discards the subcommand's return value and exits 0
    # for every known command, errors included (main.c:46-82: only "unknown
    # command" returns 1); command failures are signalled on stderr alone.
    # Mirror that unless RB3JAX_STRICT_EXIT=1 asks for real exit codes.
    import os

    if os.environ.get("RB3JAX_STRICT_EXIT") == "1":
        return ret
    return 0 if ret != _UNKNOWN_CMD else 1


def _dispatch(argv: list[str]) -> int:
    if not argv:
        print("""Usage: rb3jax <command> <arguments>
Commands:
  Search:
    sw         find local alignment
    mem        find maximal exact matches
    hapdiv     haplotype diversity with sliding k-mers
    suffix     find the longest matching suffix
  Construction:
    build      construct a BWT
    merge      merge BWTs
    plain2fmd  convert BWT in plain text to FMD
    ssa        generate sampled suffix array
  Miscellaneous:
    get        retrieve the i-th sequence from BWT
    stat       basic statistics of BWT
    kount      count (high-occurrence) k-mers
    fa2line    convert FASTX to lines
    fa2kmer    extract k-mers from FASTX
    version    print the version number""")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in ("search", "sw", "mem", "hapdiv"):
        return main_search(rest, cmd)
    if cmd == "serve":
        # rb3jax extension (not in the reference command list, which must
        # byte-match): resident device engine server — see server.py
        from .server import main_serve

        return main_serve(rest)
    if cmd == "build":
        return main_build(rest)
    if cmd == "merge":
        return main_merge(rest)
    if cmd == "ssa":
        return main_ssa(rest)
    if cmd == "stat":
        return main_stat(rest)
    if cmd == "suffix":
        return main_suffix(rest)
    if cmd == "get":
        return main_get(rest)
    if cmd == "kount":
        return main_kount(rest)
    if cmd == "fa2line":
        return main_fa2line(rest)
    if cmd == "fa2kmer":
        return main_fa2kmer(rest)
    if cmd == "plain2fmd":
        return main_plain2fmd(rest)
    if cmd == "version":
        print(REF_VERSION)
        return 0
    print(f"ERROR: unknown command '{cmd}'", file=sys.stderr)
    return _UNKNOWN_CMD


if __name__ == "__main__":
    sys.exit(main())
