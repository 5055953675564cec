#!/usr/bin/env python3
"""Benchmark: prints ONE JSON line with the headline metric.

Headline: DP cell updates per second (GCUPS) on the all-vs-all alignment
path, measured on the first GPU with a warmed-up in-process engine, on the
shape of config 3 in BASELINE.json's ``configs`` list: Gotoh affine,
BLOSUM62, ~1k short protein sequences all-vs-all.  Exits non-zero without a
GPU; the line names the device it ran on.

vs_baseline: the reference publishes no numbers, so the denominator is
measured here: the throughput of bench_baseline_c (a reimplementation of
the reference's OpenMP CPU path, same recurrences, compiled -O3
-march=native) when available, else a nominal 1.0 GCUPS.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_SEQS = int(os.environ.get("BENCH_SEQS", 1024))
LEN_LO, LEN_HI = 24, 64
ALGO, GAPS = "ga", (0, -10, -1)


def make_dataset(rng, n):
    from sequencealigner_tpu.io.input import SequenceSet
    from sequencealigner_tpu import matrices

    m = matrices.get("blosum62")
    seqs = [
        rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8),
                   int(rng.integers(LEN_LO, LEN_HI + 1)))
        for _ in range(n)
    ]
    return SequenceSet.from_list(seqs, m.lut), m


def measure_gpu(ss, m):
    from sequencealigner_tpu.engine import Engine

    eng = Engine(ALGO, m.matrix, GAPS, device_kind="gpu")
    # Warmup: compiles every bucket-combo executable.
    eng.align_all(ss, None, progress=False)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        stats = eng.align_all(ss, None, progress=False)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return stats.cells / dt / 1e9, stats.pairs / dt


def measure_c_baseline(tmpdir: Path) -> float | None:
    """GCUPS of the C comparator (reference-equivalent OpenMP CPU path)."""
    src = Path(__file__).parent / "native" / "baseline_cpu.c"
    if not src.exists():
        return None
    exe = tmpdir / "baseline_cpu"
    try:
        subprocess.run(
            ["gcc", "-O3", "-march=native", "-fopenmp", "-o", str(exe), str(src)],
            check=True, capture_output=True,
        )
        best = 0.0
        for _ in range(3):
            out = subprocess.run(
                [str(exe)], check=True, capture_output=True, text=True
            )
            best = max(best, float(json.loads(out.stdout.strip())["gcups"]))
        return best
    except Exception:
        return None


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: the default device is {dev.platform}", file=sys.stderr)
        return 1
    rng = np.random.default_rng(20260816)
    ss, m = make_dataset(rng, N_SEQS)
    gcups, pairs_per_sec = measure_gpu(ss, m)

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        base = measure_c_baseline(Path(td))
    vs = gcups / base if base else gcups / 1.0

    print(json.dumps({
        "metric": "gcups_allvsall_ga_blosum62",
        "value": round(gcups, 3),
        "unit": "GCUPS",
        "vs_baseline": round(vs, 3),
        "pairs_per_sec": round(pairs_per_sec, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
