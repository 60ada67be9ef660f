#!/usr/bin/env bash
# Full-suite runner: four fresh pytest processes instead of one.
#
# Why: XLA:CPU segfaults inside backend_compile when a large render
# graph compiles after enough jit/LLVM state has accumulated in ONE
# process (~200+ tests; the same compiles succeed in a fresh process,
# MALLOC_CHECK_ sees no heap corruption, and the crash point moves as
# the suite grows — an upstream accumulation bug, not this repo's
# code; zero-egress image, so this runner + the conftest note stand in
# for an upstream issue link).  Chunking bounds per-process test count
# structurally at ~half the observed crash horizon, instead of relying
# on tests/conftest.py's in-process cache-flush heuristic (still kept
# as defense for direct `pytest tests/` invocations).
#
# Cost: a few cross-chunk graph recompiles (the CPU suite runs with the
# persistent compilation cache off — see conftest.py for why).
#
# Usage:
#   tools/run_tests.sh              # full suite, 4 fresh processes
#   tools/run_tests.sh -m "not slow"   # extra args forwarded to pytest
set -u
cd "$(dirname "$0")/.."

# grouped to balance wall-clock (heavy compile families spread out);
# every tests/test_*.py must appear in exactly one chunk
CHUNK1="tests/test_analysis.py tests/test_aot.py tests/test_batch_extract.py \
tests/test_bucket.py tests/test_chip_smoke.py tests/test_compat.py \
tests/test_compile_cache.py tests/test_engine.py tests/test_envelope.py \
tests/test_flag_fuzz.py"
CHUNK2="tests/test_golden.py tests/test_gpu.py tests/test_graph_budget.py \
tests/test_gui_editor.py tests/test_io_editor.py tests/test_mp3.py \
tests/test_native.py tests/test_ops.py tests/test_resampler.py"
CHUNK3="tests/test_parallel.py tests/test_phrase.py tests/test_plan.py \
tests/test_precision.py \
tests/test_ref_upstream.py tests/test_server.py tests/test_sndcodec.py"
CHUNK4="tests/test_resample_oracle.py tests/test_universal.py \
tests/test_universal_cover.py"

# guard: a new test file not listed above must fail loudly, not silently
# skip
listed=$(echo $CHUNK1 $CHUNK2 $CHUNK3 $CHUNK4 | tr ' ' '\n' | sort)
actual=$(ls tests/test_*.py | sort)
if [ "$listed" != "$actual" ]; then
  echo "run_tests.sh: chunk lists are out of date with tests/:" >&2
  diff <(echo "$listed") <(echo "$actual") >&2
  exit 2
fi

rc=0
i=0
for chunk in "$CHUNK1" "$CHUNK2" "$CHUNK3" "$CHUNK4"; do
  i=$((i + 1))
  echo "=== chunk $i/4: $chunk"
  python -m pytest $chunk -q "$@"
  c=$?
  # pytest exit 5 = no tests collected (possible when forwarding -m/-k
  # filters); treat as success for filtered runs
  if [ $c -ne 0 ] && [ $c -ne 5 ]; then
    rc=$c
    echo "=== chunk $i FAILED (exit $c)"
  fi
done
echo "=== run_tests.sh done, exit $rc"
exit $rc
