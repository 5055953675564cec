#!/usr/bin/env python3
"""GPU DP kernel vs the plain XLA scan, end to end through Engine.align_all.

Workloads are chip_smoke.py's (same generators and seed): 4,096 long-tailed
proteins under GA/BLOSUM62, NW and SW on 1,024 of them, and 128 DNA
sequences of 1.5-6 kb under GA/nuc44.  For each workload, on one GPU:

- kernel, full workload: one cold run (its compile seconds reported
  separately), then the median of --runs warm runs;
- both scorers on the same truncated workload (``limit_pairs``: the first
  combos of the schedule, shortest first), sized so a warm XLA run takes
  about --xla-seconds; cold run, then the median of --runs warm runs each.

Stats-only runs (no output store): the time covers scheduling, dispatch,
the device work and the score fetch.  Prints the card's name and power
limit, then one JSON line per measurement, each naming the device.

Usage: python benchmarks/kernel_vs_xla.py [--runs 5] [--xla-seconds 6]
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def measure(eng, ss, runs, clock, limit=None):
    c0 = clock.total
    t0 = time.perf_counter()
    cold = eng.align_all(ss, None, progress=False, limit_pairs=limit)
    cold_s = time.perf_counter() - t0
    compile_s = clock.total - c0
    times = []
    for _ in range(runs):
        st = eng.align_all(ss, None, progress=False, limit_pairs=limit)
        times.append(st.seconds)
    med = statistics.median(times)
    return {
        "pairs": st.pairs, "cells": st.cells, "cold_s": round(cold_s, 4),
        "compile_s": round(compile_s, 3), "median_s": med,
        "min_s": min(times), "max_s": max(times),
        "pairs_per_s": st.pairs / med, "gcups": st.cells / med / 1e9,
        "cold_pairs": cold.pairs,
    }


def pairs_within_cells(ss, budget: float) -> int:
    """Pairs, in schedule order, whose DP cells fit ``budget`` (>= 1)."""
    from sequencealigner_tpu.scheduler import Schedule

    sched = Schedule.build(ss.lengths)
    ls = sched.lengths_sorted.astype(np.float64)
    pairs = 0
    for a, b in sched.combos():
        ba, bb = sched.buckets[a], sched.buckets[b]
        la, lb = ls[ba.start : ba.end], ls[bb.start : bb.end]
        n = sched.combo_pair_count(a, b)
        cells = (la.sum() ** 2 - (la * la).sum()) / 2 if a == b else (
            la.sum() * lb.sum())
        if cells >= budget:
            pairs += int(n * budget / cells)
            break
        pairs += n
        budget -= cells
    return max(1, pairs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--xla-seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()

    import jax

    import chip_smoke as cs
    from sequencealigner_tpu import matrices
    from sequencealigner_tpu.engine import Engine
    from sequencealigner_tpu.io.input import SequenceSet

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: the default device is {dev.platform}", file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(json.dumps({"card": smi.stdout.strip() or smi.stderr.strip()}),
          flush=True)
    clock = cs.CompileClock()
    rng = np.random.default_rng(args.seed)
    prot = cs.protein_seqs(rng, cs.N_PROT)
    dna = cs.dna_seqs(rng, cs.N_DNA)
    b62, nuc = matrices.get("blosum62"), matrices.get("nuc44")
    workloads = [
        ("ga_proteins", "ga", b62, prot),
        ("nw_proteins_1k", "nw", b62, prot[: cs.N_PROT_SUB]),
        ("sw_proteins_1k", "sw", b62, prot[: cs.N_PROT_SUB]),
        ("ga_dna", "ga", nuc, dna),
    ]
    for name, algo, m, seqs in workloads:
        ss = SequenceSet.from_list(seqs, m.lut)
        kern = Engine(algo, m.matrix, cs.GAPS[algo], device_kind="gpu")
        xla = Engine(algo, m.matrix, cs.GAPS[algo], device_kind="gpu")
        xla.scorer = "xla"  # the plain reference scorer on the same GPU
        full = measure(kern, ss, args.runs, clock)
        print(json.dumps({"workload": name, "scorer": "kernel",
                          "scope": "full", **full, "device": device}),
              flush=True)
        # Size the truncated workload from a short warm XLA probe's cell
        # rate and the schedule's cells in order.
        probe_pairs = pairs_within_cells(ss, 2e9)
        for _ in range(2):
            probe = xla.align_all(ss, None, progress=False,
                                  limit_pairs=probe_pairs)
        limit = pairs_within_cells(ss, probe.gcups * 1e9 * args.xla_seconds)
        for label, eng in (("xla", xla), ("kernel", kern)):
            r = measure(eng, ss, args.runs, clock, limit=limit)
            print(json.dumps({"workload": name, "scorer": label,
                              "scope": f"limit_pairs={limit}", **r,
                              "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
