#!/usr/bin/env python3
"""Scale validation for BASELINE configs 4 and 5.

Config 4 at its stated scale — 100k+ mixed-length DNA — exercising the REAL
production machinery end to end:
  - deterministic similarity prefilter at n = 100k (device-reduced)
  - triangular + disk-spill OutputStore (the n^2 full matrix would be 40 GB)
  - the align path on a TRUNCATED pair slice (the full 5e9-pair space is
    ~1.5e15 DP cells; sustained-rate numbers come from a multi-minute
    slice), with fill_pairs scatter into the spill store
  - chunked triangular->square HDF5 conversion on a row window

Config 5 rehearsal at n = 1M: schedule + store-plan + sparse spill store +
scatter + read-back + chunked HDF5 row-window conversion with a truncated
pair space.  A 1M x 1M matrix is 4 TB; like the reference (whose own docs
stop at 50k sequences = 10 GB, README.md:246), full materialization needs
either -W or a sharded multi-host store — the spill memmap is a SPARSE file,
so a truncated fill stays within disk.

Usage: python benchmarks/scale_run.py [--n 100000] [--pair-budget-cells 2e12]
       [--skip-filter] [--rehearse-1m] [--hdf5-rows 4096]
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DNA = b"ATGC"


def log(**kw):
    print(json.dumps(kw), flush=True)


def make_dna(rng, n, lo=64, hi=1024):
    from sequencealigner_tpu.io.input import SequenceSet
    from sequencealigner_tpu import matrices

    m = matrices.get("nuc44")
    lens = rng.integers(lo, hi + 1, n)
    total = int(lens.sum())
    data = rng.choice(np.frombuffer(DNA, np.uint8), total).astype(np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return SequenceSet(data=data, offsets=offsets, lut=m.lut), m


def config4(n, pair_budget_cells, skip_filter, hdf5_rows, tmp):
    from sequencealigner_tpu import filter as filt
    from sequencealigner_tpu.engine import Engine
    from sequencealigner_tpu.io.output import OutputStore
    from sequencealigner_tpu.io import hdf5_io

    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    ss, m = make_dna(rng, n)
    log(phase="dataset", n=n, total_chars=int(ss.offsets[-1]),
        seconds=round(time.perf_counter() - t0, 2))

    # Config 4 specifies DSV input: round-trip the set through a real CSV
    # file and the production loader (native fast path when available).
    from sequencealigner_tpu.io import input as sio

    csv = tmp / "c4.csv"
    with open(csv, "wb") as f:
        f.write(b"id,sequence\n")
        for k in range(ss.num):
            f.write(str(k).encode() + b"," + ss.get_bytes(k) + b"\n")
    t0 = time.perf_counter()
    ss2 = sio.load(str(csv), m.lut, gap_pen=0)
    dt = time.perf_counter() - t0
    assert ss2.num == ss.num and bytes(ss2.data) == bytes(ss.data)
    log(phase="dsv_parse", rows=n, file_bytes=csv.stat().st_size,
        seconds=round(dt, 2), mb_per_sec=round(csv.stat().st_size / dt / 1e6))
    ss = ss2

    if not skip_filter:
        t0 = time.perf_counter()
        fss, dropped = filt.filter_sequences(ss, 0.9, progress=False)
        dt = time.perf_counter() - t0
        log(phase="filter", n=n, dropped=dropped, seconds=round(dt, 2),
            seqs_per_sec=round(n / dt))

    t0 = time.perf_counter()
    # this host's 125 GB RAM would fit the 40 GB full matrix; force the
    # beyond-RAM representation so the triangular+spill path is what's tested
    store = OutputStore.plan(ss.num, force_triangular=True,
                             persist_path=str(tmp / "c4.scores"))
    log(phase="store_plan", triangular=store.triangular, spill=store.spill,
        elements=int(store.matrix.shape[0]),
        seconds=round(time.perf_counter() - t0, 2))

    eng = Engine("ga", m.matrix, (0, -10, -1))
    # derive a pair cap from the cell budget (avg cells/pair from lengths)
    avg_cells = float(ss.lengths.astype(np.float64).mean() ** 2)
    limit = max(1, int(pair_budget_cells / avg_cells))
    # First pass compiles every bucket-combo executable (cached across runs);
    # the timed pass measures the sustained rate a full-space run would see.
    eng.align_all(ss, store, progress=False, limit_pairs=limit)
    t0 = time.perf_counter()
    stats = eng.align_all(ss, store, progress=False, limit_pairs=limit)
    dt = time.perf_counter() - t0
    log(phase="align_truncated", pairs=stats.pairs, cells=stats.cells,
        seconds=round(dt, 2), gcups=round(stats.cells / dt / 1e9, 2),
        pairs_per_sec=round(stats.pairs / dt),
        total_pairs_space=ss.num * (ss.num - 1) // 2)

    # The truncated slice above covers the SMALLEST buckets (combo order is
    # ascending): also measure the big-bucket rate that dominates a full run
    # (>=80% of the pair space's cells are in the 512-1024 buckets).
    rng2 = np.random.default_rng(6)
    ss_big, _ = make_dna(rng2, min(n, 20_000), lo=512, hi=1024)
    limit_big = max(1, int(pair_budget_cells / float(
        ss_big.lengths.astype(np.float64).mean() ** 2)))
    eng.align_all(ss_big, None, progress=False, limit_pairs=limit_big)
    t0 = time.perf_counter()
    stats_b = eng.align_all(ss_big, None, progress=False, limit_pairs=limit_big)
    dt = time.perf_counter() - t0
    log(phase="align_truncated_large", n=ss_big.num, pairs=stats_b.pairs,
        cells=stats_b.cells, seconds=round(dt, 2),
        gcups=round(stats_b.cells / dt / 1e9, 2),
        pairs_per_sec=round(stats_b.pairs / dt))

    # scatter throughput, standalone (10M random pairs)
    npairs = 10_000_000
    i = rng.integers(0, ss.num - 1, npairs).astype(np.int64)
    j = rng.integers(1, ss.num, npairs).astype(np.int64)
    i, j = np.minimum(i, j - 1), np.maximum(i + 1, j)
    sc = rng.integers(-100, 100, npairs).astype(np.int32)
    store.fill_pairs(i, j, sc)  # first touch: page-fault/zero cost, excluded
    t0 = time.perf_counter()
    store.fill_pairs(i, j, sc)
    dt = time.perf_counter() - t0
    log(phase="fill_pairs", pairs=npairs, seconds=round(dt, 2),
        pairs_per_sec=round(npairs / dt))

    # chunked triangular -> square HDF5 conversion, row window
    t0 = time.perf_counter()
    out = tmp / "c4.h5"
    hdf5_io.write(str(out), store, ss, compression=1, progress=False,
                  max_rows=hdf5_rows)
    dt = time.perf_counter() - t0
    log(phase="hdf5_rows", rows=hdf5_rows, dim=ss.num, seconds=round(dt, 2),
        bytes_written=out.stat().st_size,
        cells_per_sec=round(hdf5_rows * ss.num / dt))


def rehearse_1m(tmp):
    from sequencealigner_tpu.scheduler import Schedule
    from sequencealigner_tpu.io.output import OutputStore

    n = 1_000_000
    rng = np.random.default_rng(5)
    lengths = rng.integers(64, 1025, n).astype(np.int32)
    t0 = time.perf_counter()
    sched = Schedule.build(lengths)
    log(phase="1m_schedule", n=n, buckets=len(sched.buckets),
        total_pairs=sched.total_pairs(),
        seconds=round(time.perf_counter() - t0, 2))

    # store plan: must pick triangular + spill (sorted-coordinate layout);
    # the spill memmap is a sparse file, so a truncated fill allocates only
    # the touched blocks.
    t0 = time.perf_counter()
    store = OutputStore.plan(n, persist_path=str(tmp / "m1.scores"),
                             perm=sched.order)
    assert store.triangular and store.spill and store.pos is not None
    log(phase="1m_store_planned", triangular=store.triangular,
        spill=store.spill, permuted=store.pos is not None,
        seconds=round(time.perf_counter() - t0, 2))
    # The production write pattern: the engine flushes consecutive
    # superblocks of one bucket combo, whose sorted-coordinate offsets
    # ascend monotonically — in the sorted layout that is a sequential
    # stream into the cold memmap.  Reproduce it exactly (combo-local
    # linear ids -> original (i, j) through the schedule, then fill).
    from sequencealigner_tpu.scheduler import linear_to_pair, pair_count

    bi = max(range(len(sched.buckets)), key=lambda k: sched.buckets[k].count)
    bb = sched.buckets[bi]
    total = 20_000_000
    batch = 4_000_000
    s0 = pair_count(bb.count) // 3
    t0 = time.perf_counter()
    filled = 0
    while filled < total:
        lin = np.arange(s0 + filled, s0 + filled + batch, dtype=np.int64)
        rk, rc = linear_to_pair(lin)
        ok_ = sched.order[bb.start + rk]
        oc = sched.order[bb.start + rc]
        oi, oj = np.minimum(ok_, oc), np.maximum(ok_, oc)
        sc = (lin & 0x7FF).astype(np.int32) - 1000
        store.fill_pairs(oi, oj, sc)
        filled += batch
    dt = time.perf_counter() - t0
    log(phase="1m_fill_engine_order", pairs=total, seconds=round(dt, 2),
        pairs_per_sec=round(total / dt),
        bucket_rows=bb.count, combo_pairs=pair_count(bb.count))
    # Contrast: fully random scatter (the r2 failure mode) stays available
    # for regression tracking but on a small budget.
    npairs = 500_000
    t0 = time.perf_counter()
    i = rng.integers(0, n - 1, npairs).astype(np.int64)
    j = rng.integers(1, n, npairs).astype(np.int64)
    i, j = np.minimum(i, j - 1), np.maximum(i + 1, j)
    sc = rng.integers(-1000, 1000, npairs).astype(np.int32)
    store.fill_pairs(i, j, sc)
    log(phase="1m_scatter_random", pairs=npairs,
        seconds=round(time.perf_counter() - t0, 2))
    back = store.read_pairs(i[::1000], j[::1000])
    ok = np.mean(back == sc[::1000]) > 0.95  # dup/overlap writes may differ
    store.sync()
    du = Path(tmp / "m1.scores").stat().st_blocks * 512
    log(phase="1m_store", elements=int(store.matrix.shape[0]),
        logical_bytes=int(store.matrix.shape[0]) * 4,
        disk_bytes_actually_allocated=du, scattered_pairs=npairs,
        readback_ok=bool(ok), seconds=round(time.perf_counter() - t0, 2))


def filter_smoke_1m(nseg: int = 6):
    """n=1M filter HBM-residency proof + segment rate (weak #6 close-out):
    the WHOLE prior-row working set goes device-resident in bucketed form
    (~input bytes, not n*lmax), then nseg real segments run and the full-
    filter time is projected (the complete n^2 filter at 1M is long by
    design)."""
    import time

    from sequencealigner_tpu import filter as flt
    from sequencealigner_tpu.io.input import SequenceSet
    from sequencealigner_tpu import matrices
    import jax

    n = 1_000_000
    rng = np.random.default_rng(9)
    m = matrices.get("blosum62")
    lens = rng.integers(20, 51, n)
    alpha = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    # Low-entropy pool so some drops actually happen.
    pool = [rng.choice(alpha, int(l)) for l in rng.integers(20, 51, 2000)]
    seqs = [pool[k][: lens[i]] if (k := int(rng.integers(0, 4000))) < 2000
            else rng.choice(alpha, int(lens[i])) for i in range(n)]
    ss = SequenceSet.from_list(seqs, m.lut)

    from sequencealigner_tpu.scheduler import Schedule

    t0 = time.perf_counter()
    sched = Schedule.build(ss.lengths)
    bargs = []
    resident = 0
    block = 512
    for b in sched.buckets:
        rows = sched.order[b.start : b.end]
        cnt = len(rows)
        cpad = -(-cnt // block) * block
        mat = np.full((cpad, b.edge), -1, dtype=np.int8)
        mat[:cnt] = flt._pack_codes(ss, rows, b.edge)
        lensb = np.zeros(cpad, np.int32)
        lensb[:cnt] = ss.lengths[rows]
        orig = np.full(cpad, n, np.int32)
        orig[:cnt] = rows
        for a in (mat, lensb, orig):
            resident += a.nbytes
            bargs.append(jax.device_put(a))
    jax.block_until_ready(bargs[-3])
    log(phase="1m_filter_resident", n=n, buckets=len(sched.buckets),
        device_bytes=resident, seconds=round(time.perf_counter() - t0, 2))

    lmax = int(ss.max_len)
    S = block * max(1, min(flt.SEG_BLOCKS,
                           flt.SEG_OH_BYTES // (block * lmax * 48)))
    kept = np.ones(n + 1, np.uint8)
    kept[n] = 0
    t0 = time.perf_counter()
    done = 0
    for j0 in range(0, nseg * S, S):
        cols = np.full((S, lmax), -1, dtype=np.int8)
        cols[:S] = flt._pack_codes(
            ss, np.arange(j0, j0 + S, dtype=np.int64), lmax)
        collens = ss.lengths[j0 : j0 + S].astype(np.int32)
        killed, sim = flt._filter_segment(
            jax.device_put(cols), jax.device_put(collens),
            jax.device_put(kept), np.float32(0.9), np.int32(j0), *bargs,
            block=block,
        )
        np.asarray(killed)
        done += S
        if j0 == 0:  # first segment pays compile; restart the clock
            t0 = time.perf_counter()
            done = 0
    dt = time.perf_counter() - t0
    rate = done / dt if done else 0.0
    log(phase="1m_filter_smoke", segments=nseg - 1, candidates=done,
        seconds=round(dt, 2), candidates_per_sec=round(rate),
        projected_full_filter_hours=round(n / max(rate, 1) / 3600, 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--pair-budget-cells", type=float, default=2e12)
    ap.add_argument("--skip-filter", action="store_true")
    ap.add_argument("--rehearse-1m", action="store_true")
    ap.add_argument("--filter-smoke-1m", action="store_true")
    ap.add_argument("--hdf5-rows", type=int, default=4096)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()

    from sequencealigner_tpu import ui

    ui.configure(quiet=True)
    tmp = Path(args.workdir or tempfile.mkdtemp(prefix="seqalign-scale-"))
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        if args.rehearse_1m:
            rehearse_1m(tmp)
        elif args.filter_smoke_1m:
            filter_smoke_1m()
        else:
            config4(args.n, args.pair_budget_cells, args.skip_filter,
                    args.hdf5_rows, tmp)
    finally:
        import shutil

        if args.workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
