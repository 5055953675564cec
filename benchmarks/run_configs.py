#!/usr/bin/env python3
"""Benchmark runner over the BASELINE.json configs.

Prints one JSON line per config: {"config", "algo", "n", "gcups",
"pairs_per_sec", "seconds"}.  Sizes are scaled by --scale so the suite is
usable both for quick regression checks and full-size runs; config 5
(multi-host) needs a pod launcher and is exercised functionally by
tests/test_parallel.py instead.

Usage: python benchmarks/run_configs.py [--scale 1.0] [--configs 1,2,3,4]
"""

import argparse
import json
import zlib
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PROTEIN = b"ARNDCQEGHILKMFPSTWYV"
DNA = b"ATGC"


def make_set(rng, n, lo, hi, alphabet, lut):
    from sequencealigner_tpu.io.input import SequenceSet

    seqs = [
        rng.choice(np.frombuffer(alphabet, np.uint8),
                   int(rng.integers(lo, hi + 1)))
        for _ in range(n)
    ]
    return SequenceSet.from_list(seqs, lut)


def run_config(name, algo, matrix_name, n, lo, hi, alphabet, gaps,
               filter_threshold=0.0):
    from sequencealigner_tpu import matrices
    from sequencealigner_tpu import filter as filt
    from sequencealigner_tpu.engine import Engine

    m = matrices.get(matrix_name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    ss = make_set(rng, n, lo, hi, alphabet, m.lut)
    if filter_threshold:
        ss, _ = filt.filter_sequences(ss, filter_threshold, progress=False)
    eng = Engine(algo, m.matrix, gaps)
    eng.align_all(ss, None, progress=False)  # warmup/compile
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        stats = eng.align_all(ss, None, progress=False)
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    print(json.dumps({
        "config": name,
        "algo": algo,
        "matrix": matrix_name,
        "n": ss.num,
        "pairs": stats.pairs,
        "gcups": round(stats.cells / best / 1e9, 3),
        "pairs_per_sec": round(stats.pairs / best),
        "seconds": round(best, 3),
    }), flush=True)


def main():
    from sequencealigner_tpu import ui

    ui.configure(quiet=True)
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0,
                    help="sequence-count multiplier")
    ap.add_argument("--configs", default="1,2,3,4")
    args = ap.parse_args()
    want = {int(x) for x in args.configs.split(",")}
    s = args.scale

    if 1 in want:  # NW linear, BLOSUM62, ~1k short protein all-vs-all
        run_config("1_nw_protein_short", "nw", "blosum62",
                   int(1024 * s), 24, 64, PROTEIN, (-4, 0, 0))
    if 2 in want:  # SW local + similarity prefilter
        run_config("2_sw_protein_filtered", "sw", "blosum62",
                   int(1024 * s), 24, 64, PROTEIN, (0, -10, -1),
                   filter_threshold=0.9)
    if 3 in want:  # Gotoh affine with matrix selection (the headline config)
        run_config("3_ga_pam250", "ga", "pam250",
                   int(1024 * s), 24, 64, PROTEIN, (0, -10, -1))
    if 4 in want:  # DNA mixed-length buckets (DSV-scale input)
        run_config("4_dna_mixed", "ga", "nuc44",
                   int(4096 * s), 64, 1024, DNA, (0, -10, -1))


if __name__ == "__main__":
    main()
