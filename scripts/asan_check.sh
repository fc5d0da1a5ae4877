#!/bin/bash
# AddressSanitizer pass over the native fast paths (the analog of the
# reference's `make asan=1`, Makefile:10-13): rebuilds the three C++ libs
# with -fsanitize=address into a scratch dir and runs the native-heavy test
# files under LD_PRELOAD'd libasan.
#
# Usage: scripts/asan_check.sh [pytest args...]
set -euo pipefail
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
SCRATCH="$(mktemp -d /tmp/rb3t_asan.XXXXXX)"
trap 'rm -rf "$SCRATCH"' EXIT

cp -r "$ROOT/ropebwt3_jax" "$SCRATCH/ropebwt3_jax"
cp -r "$ROOT/tests" "$SCRATCH/tests"
rm -f "$SCRATCH"/ropebwt3_jax/native/_*.so

for src in rld_codec bwasw_core sais; do
  g++ -O1 -g -fsanitize=address -fno-omit-frame-pointer -march=native \
      -std=c++17 -shared -fPIC -pthread \
      -o "$SCRATCH/ropebwt3_jax/native/_${src}.so" \
      "$SCRATCH/ropebwt3_jax/native/${src}.cpp"
done

LIBASAN="$(g++ -print-file-name=libasan.so)"
cd "$SCRATCH"
# RB3JAX_TEST_REEXEC=1 + the full scrubbed env up front: tests/conftest.py
# otherwise re-execs pytest with PYTHONPATH="" and the scratch (asan) tree
# would silently lose to the installed one.
RB3JAX_TEST_REEXEC=1 \
LD_PRELOAD="$LIBASAN" \
ASAN_OPTIONS="detect_leaks=0:abort_on_error=1" \
PYTHONPATH="$SCRATCH" JAX_PLATFORMS=cpu \
XLA_FLAGS="--xla_force_host_platform_device_count=8" \
python -m pytest tests/test_native_sw.py tests/test_ssa_props.py \
    tests/test_formats.py -q -x \
    --deselect tests/test_ssa_props.py::test_ssa_gen_device_matches_host \
    "$@"
# jax-touching tests are excluded: the prebuilt jaxlib CPU backend aborts
# under an LD_PRELOAD'ed ASan runtime (inside XLA compilation, not our code);
# the native .so entry points are all covered by the files above.
echo "[asan] native libs clean"
