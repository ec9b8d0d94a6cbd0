#!/usr/bin/env bash
# TSAN and ASAN runs over the C++ host runtime of entreepy_tpu_torch
# (entreepy_tpu_torch/runtime/native.cpp). Builds it instrumented into a
# temporary directory, preloads the sanitizer runtime, points the port's
# loader at the build (ENTREEPY_NATIVE_LIB) and runs
# tools/_sanitize_torch_driver.py, which reaches all 12 entry points. Exits
# non-zero on any sanitizer report.
#
#   tools/sanitize_torch.sh            # both sanitizers
#   tools/sanitize_torch.sh tsan|asan  # one of them
set -euo pipefail
cd "$(dirname "$0")/.."
SRC=entreepy_tpu_torch/runtime/native.cpp
PY=${PYTHON:-python3}
OUT=$(mktemp -d "${TMPDIR:-/tmp}/entreepy_torch_sanitize.XXXXXX")
trap 'rm -rf "$OUT"' EXIT

run_one() {
  local kind=$1 flag=$2 runtime_so
  runtime_so=$(g++ -print-file-name=lib${kind}.so)
  echo "== ${kind}: building =="
  g++ -O1 -g -fsanitize="$flag" -shared -fPIC -pthread \
      -o "$OUT/native_${kind}.so" "$SRC"
  echo "== ${kind}: running driver =="
  local env_extra=()
  if [ "$kind" = tsan ]; then
    # PyTorch's CPU ops on one thread: their OpenMP (libgomp) barriers are
    # invisible to TSAN, which then reports races inside libtorch that are
    # not there. The runtime under test threads with std::thread, unaffected.
    env_extra=(TSAN_OPTIONS="halt_on_error=1 exitcode=66" OMP_NUM_THREADS=1)
  else
    # leak detection off: the long-lived python interpreter is not what is tested
    env_extra=(ASAN_OPTIONS="detect_leaks=0:halt_on_error=1:exitcode=66:verify_asan_link_order=0")
  fi
  env "${env_extra[@]}" \
      LD_PRELOAD="$runtime_so" \
      ENTREEPY_NATIVE_LIB="$OUT/native_${kind}.so" \
      "$PY" tools/_sanitize_torch_driver.py
  echo "== ${kind}: clean =="
}

case "${1:-all}" in
  tsan) run_one tsan thread ;;
  asan) run_one asan address ;;
  all)  run_one tsan thread; run_one asan address ;;
  *) echo "usage: $0 [tsan|asan|all]" >&2; exit 2 ;;
esac
