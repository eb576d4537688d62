#!/usr/bin/env bash
# Run chip_smoke.py from two checkouts in turns (A, B, B, A) on one GPU and
# print one JSON line per run: its exit code and wall seconds (the kernels'
# build included).
#
#   bash scripts/chip_smoke_ab.sh <checkout A> <checkout B> <output dir>
#
# Run n of checkout X writes <output dir>/X<n>.{json,out,err}. A checkout's
# hpcs_torch/_build is deleted after each of its runs, so every run builds
# the kernels from its own sources. Exits 1 if any run failed.
set -u
a=$(realpath "$1")
b=$(realpath "$2")
mkdir -p "$3"
out=$(realpath "$3")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
for run in A1 B1 B2 A2; do
  case $run in A*) dir=$a ;; *) dir=$b ;; esac
  start=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py --json "$out/$run.json" > "$out/$run.out" 2> "$out/$run.err")
  rc=$?
  echo "{\"run\": \"$run\", \"checkout\": \"$dir\", \"rc\": $rc, \"seconds\": $(( $(date +%s) - start ))}"
  [ $rc -eq 0 ] || status=1
  rm -rf "$dir/hpcs_torch/_build"
done
exit $status
