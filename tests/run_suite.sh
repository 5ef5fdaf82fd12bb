#!/usr/bin/env bash
# Crash-isolated suite runner: a single upstream XLA-CPU compile segfault
# (observed once, non-reproducible) would void a one-process run. This runs the
# suite as independent pytest PROCESSES per group, survives any group
# crashing (segfault/abort), and prints a partial report: a crashed group is
# reported as CRASH(rc) and every other group still completes.
#
# Usage: tests/run_suite.sh            # full suite, grouped
#        tests/run_suite.sh fast      # skip the slow 10x10k golden group
#
# Exit status: 0 iff every group passed.

set -u
cd "$(dirname "$0")/.."

MODE="${1:-full}"

# group name | pytest selection
# The 10x10k golden matrix gets its own group: it is the longest and the
# most likely to be the only thing a rerun needs.
SUITE=(
  "kernels|tests/test_hmm.py tests/test_hmm_blocked.py"
  "triton|tests/test_hmm_pallas.py tests/test_hmm_pallas_fused.py"
  "ops|tests/test_ops.py tests/test_maf.py tests/test_ld_path.py"
  "lbfgsb|tests/test_lbfgsb.py"
  "io|tests/test_native_io.py tests/test_glsource.py tests/test_checkpoint.py tests/test_gsl_fixture.py tests/test_tools.py tests/test_compile_cache.py"
  "compat|tests/test_em_compat.py tests/test_opt_compat.py"
  "sharding|tests/test_sharding.py tests/test_sharded_driver.py"
  "site_sharding|tests/test_site_sharding.py"
  "distributed|tests/test_distributed.py"
  "streaming|tests/test_streaming.py tests/test_restart.py"
  "wide_bf16|tests/test_wide_n.py tests/test_bf16.py"
  "golden_small|tests/test_golden.py -k not 10k and not 20ind"
  "golden_10k|tests/test_golden.py -k 10k or 20ind"
)

declare -a NAMES RCS
overall=0
for entry in "${SUITE[@]}"; do
  name="${entry%%|*}"
  sel="${entry#*|}"
  if [ "$MODE" = "fast" ] && [ "$name" = "golden_10k" ]; then
    continue
  fi
  echo
  echo "=== group: $name ==="
  # shellcheck disable=SC2086 -- the selection is intentionally word-split;
  # -k expressions are the single token after -k
  if [[ "$sel" == *" -k "* ]]; then
    files="${sel%% -k *}"
    kexpr="${sel#* -k }"
    python -m pytest -q $files -k "$kexpr"
  else
    python -m pytest -q $sel
  fi
  rc=$?
  NAMES+=("$name")
  RCS+=("$rc")
  [ "$rc" -ne 0 ] && overall=1
done

echo
echo "=== suite report ==="
for i in "${!NAMES[@]}"; do
  rc="${RCS[$i]}"
  case "$rc" in
    0) st="PASS" ;;
    1) st="FAIL" ;;
    *) st="CRASH(rc=$rc)" ;;
  esac
  printf '  %-14s %s\n' "${NAMES[$i]}" "$st"
done
if [ "$overall" -ne 0 ]; then
  echo "=== suite: FAILURES above (groups are independent processes; rerun"
  echo "    just the failed group with its pytest selection) ==="
fi
exit "$overall"
