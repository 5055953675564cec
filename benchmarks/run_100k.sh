#!/usr/bin/env bash
# Config-4 at its stated scale: one COMPLETE 100k-sequence DNA DSV
# all-vs-all (~5 G pairs) with filter, checkpointing, full HDF5 writeback,
# and one deliberate SIGKILL/resume.  Mirrors benchmarks/soak_resume.sh at
# a larger scale.
#
# Usage: benchmarks/run_100k.sh [dir]   (dataset at $D/dna100k.csv)
set -uo pipefail
D=${1:-/root/scale100k}
CSV="$D/dna100k.csv"
[ -f "$CSV" ] || { echo "missing $CSV"; exit 1; }
rm -f "$D"/out.h5 "$D"/ck "$D"/ck.scores

ARGS=(-i "$CSV" -o "$D/out.h5" -m nuc44 -a ga -s 10 -e 1 -f 0.9 -z 1
      -k "$D/ck" -B -F -P)

echo "[run_100k] phase 1: start $(date -u +%FT%TZ)"
seqalign-tpu "${ARGS[@]}" > "$D/run1.log" 2>&1 &
PID=$!
echo "[run_100k] run1 pid $PID; SIGKILL after >=25 journal commits"
while :; do
  sleep 60
  n=$(grep -c '' "$D/ck" 2>/dev/null || echo 0)
  echo "  $(date -u +%T) journal lines: $n"
  [ "$n" -ge 25 ] && break
  kill -0 "$PID" 2>/dev/null || { echo "run1 exited before kill point"; break; }
done
if kill -0 "$PID" 2>/dev/null; then
  kill -9 "$PID"
  wait "$PID" 2>/dev/null || true
  echo "[run_100k] killed run1 mid-align at $(date -u +%FT%TZ)"
fi

echo "[run_100k] phase 2: resume $(date -u +%FT%TZ)"
seqalign-tpu "${ARGS[@]}" > "$D/run2.log" 2>&1
rc=$?
echo "[run_100k] resume finished rc=$rc at $(date -u +%FT%TZ)"
grep -i resum "$D/run2.log" || true
tail -30 "$D/run2.log"
