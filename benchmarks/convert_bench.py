"""Tri->square conversion benchmark for the sorted-coordinate spill store:
measures OutputStore.rows_sorted_window throughput.

Two regimes:
  --n 1000000          sparse 2 TB memmap rehearsal (the config-5 shape this
                       image can hold: holes read as zeros, so this measures
                       the ACCESS PATTERN + index math + assembly cost, an
                       upper bound on what a dense store adds at disk BW);
  --n 50000 --dense    dense in-disk store (fits this image), real IO.

Prints JSON lines with cells/s per window and the aggregate.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from sequencealigner_tpu.io.output import OutputStore


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rows", type=int, default=2048,
                    help="sorted rows to convert (work limit)")
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--dense", action="store_true",
                    help="sequentially materialize the whole store first "
                         "(real disk IO; use with --n that fits disk)")
    ap.add_argument("--start-frac", type=float, default=0.5,
                    help="start window at this fraction of sorted rows "
                         "(mid-triangle is the representative regime)")
    args = ap.parse_args()

    n = args.n
    rng = np.random.default_rng(0)
    perm = rng.permutation(n).astype(np.int64)
    st = OutputStore(n, triangular=True, spill=True, perm=perm)
    if args.dense:
        t0 = time.perf_counter()
        total = st.matrix.shape[0]
        step = 64 << 20
        pat = np.arange(step, dtype=np.int32) % 251 - 125
        for off in range(0, total, step):
            m = min(step, total - off)
            st.matrix[off : off + m] = pat[:m]
        st.sync()
        print(json.dumps(dict(phase="dense_fill", elems=total,
                              seconds=round(time.perf_counter() - t0, 2))),
              flush=True)
    s_base = int(n * args.start_frac)
    total_cells = 0
    t0 = time.perf_counter()
    for s0 in range(s_base, min(s_base + args.rows, n), args.window):
        s1 = min(s0 + args.window, n)
        tw = time.perf_counter()
        targets, block = st.rows_sorted_window(s0, s1)
        dt = time.perf_counter() - tw
        cells = (s1 - s0) * n
        total_cells += cells
        print(json.dumps(dict(phase="window", s0=s0, rows=s1 - s0,
                              cells=cells, seconds=round(dt, 3),
                              mcells_per_s=round(cells / dt / 1e6, 1))),
              flush=True)
    dt = time.perf_counter() - t0
    print(json.dumps(dict(phase="total", n=n, rows=args.rows,
                          cells=total_cells, seconds=round(dt, 2),
                          mcells_per_s=round(total_cells / dt / 1e6, 1))),
          flush=True)


if __name__ == "__main__":
    main()
