#!/usr/bin/env bash
# Kill/resume soak: run the CLI with checkpointing on a synthetic DNA set,
# SIGKILL it mid-align, resume, and verify sampled scores + sequence
# round-trip against an independent Gotoh (scripts/verify_soak.py).
#
# Mirrors the reference's crash-recovery contract (checkpoint journal +
# score store, /root/reference/src/core/checkpoint.c): a resumed run must
# skip committed pair blocks and produce a byte-identical similarity matrix.
#
# IMPORTANT: kill the CLI's own PID.  Wrapping the launch in `timeout` and
# killing `$!` kills the wrapper, orphans the aligner, and two live runs
# then race on the output file and the device.  Launch directly so `$!` IS
# the aligner.  Without a GPU, add -C to both runs.
set -euo pipefail
D=${1:-/tmp/soak}
N=${2:-20000}
mkdir -p "$D"
if [ ! -f "$D/in.csv" ]; then
  python - "$D/in.csv" "$N" <<'EOF'
import sys, numpy as np
rng = np.random.default_rng(11)
with open(sys.argv[1], "w") as f:
    f.write("id,sequence\n")
    for i in range(int(sys.argv[2])):
        L = int(rng.integers(60, 500))
        f.write(f"{i},{''.join(rng.choice(list('ATGC'), L))}\n")
EOF
fi
rm -f "$D"/out.h5 "$D"/ck "$D"/ck.scores

seqalign-tpu -i "$D/in.csv" -o "$D/out.h5" -m nuc44 -a ga -s 10 -e 1 \
  -k "$D/ck" -F -P > "$D/run1.log" 2>&1 &
PID=$!
echo "run1 pid $PID; waiting for >=20 journal commits..."
while :; do
  sleep 10
  n=$(grep -c '' "$D/ck" 2>/dev/null || echo 0)
  echo "  journal lines: $n"
  [ "$n" -ge 20 ] && break
  kill -0 "$PID" 2>/dev/null || { echo "run1 exited early"; exit 1; }
done
kill -9 "$PID"
wait "$PID" 2>/dev/null || true
echo "killed run1 mid-align (journal had $n lines)"

seqalign-tpu -i "$D/in.csv" -o "$D/out.h5" -m nuc44 -a ga -s 10 -e 1 \
  -k "$D/ck" -F -P > "$D/run2.log" 2>&1
grep -i resum "$D/run2.log"
python "$(dirname "$0")/../scripts/verify_soak.py" "$D"
