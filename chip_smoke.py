#!/usr/bin/env python3
"""Smoke test of the all-vs-all alignment path on an NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py               # one GPU: phases 0-3
    python3 chip_smoke.py --four-cards  # four GPUs: phase 0 and phase 4 only

Everything runs in this one process (a second JAX process could not get
the card's memory).  Data and weights-free inputs come from --seed.

0. Device report: JAX's platform, device kind and count, and the card's
   name and power limit from nvidia-smi.  No GPU -> exit 1.
1. Build: compile and register the Hopper DP kernel (set-up seconds).
2. Kernel vs plain reference on the card: the kernel against the XLA scan
   (ops/xla_dp.py) compiled for the GPU, all three algorithms, ragged
   lengths, shapes from 32x32 to 2048x1536 across the kernel's register
   chunk boundaries and past the XLA scan's streaming threshold; short pairs
   against the NumPy oracle; then ``pytest -m gpu``.  Tolerance 0.
3. The CLI end to end (``cli.run``, in process): 4,096 proteins with a
   long-tailed (log-normal, Swiss-Prot-like) length distribution under
   GA/BLOSUM62, NW and SW on 1,024 of them, one filtered run, and 128 DNA
   sequences of 1.5-6 kb under GA/nuc44.  Each output is checked for
   symmetry, and 4,096 sampled pairs plus every pair of the longest
   sequence are recomputed with the XLA scan on the GPU (exact equality).
4. (--four-cards) Engine.align_all on a four-GPU mesh and on one GPU over
   the multi-bucket protein set; the two matrices must be bit-equal.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
AMINO = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
DNA = np.frombuffer(b"ACGT", np.uint8)
GAPS = {"nw": (-4, 0, 0), "ga": (0, -10, -1), "sw": (0, -10, -1)}
#: Log-normal protein lengths clipped to 24-2,000 residues, mean near 350
#: (the shape of UniProtKB/Swiss-Prot's published length statistics).
PROT_MU, PROT_SIGMA, PROT_MIN, PROT_MAX = 5.61, 0.7, 24, 2000
N_PROT, N_PROT_SUB, N_DNA = 4096, 1024, 128
DNA_MIN, DNA_MAX = 1500, 6000
N_SAMPLES = 4096
#: (Lc, Lk) for the kernel-vs-reference phase: register chunks of 16/24/32
#: rows and their crossings, up to the long end; (1100, 1000) and larger
#: are past the XLA scan's streaming threshold.
KERNEL_SHAPES = [(32, 32), (40, 17), (64, 24), (100, 65), (200, 97),
                 (384, 256), (1100, 1000), (2048, 1536)]


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


class CompileClock:
    """Sums JAX's compile-time events (tracing, lowering, backend compile,
    persistent-cache reads) so each phase can report its compile seconds."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **kwargs) -> None:
        if event.startswith("/jax/core/compile/") or event.endswith(
            "cache_retrieval_time_sec"
        ):
            self.total += duration


# ---------------------------------------------------------------------------
# Data


def protein_seqs(rng, n: int) -> list[np.ndarray]:
    lens = np.clip(np.rint(rng.lognormal(PROT_MU, PROT_SIGMA, n)),
                   PROT_MIN, PROT_MAX).astype(int)
    return [rng.choice(AMINO, int(k)) for k in lens]


def dna_seqs(rng, n: int) -> list[np.ndarray]:
    return [rng.choice(DNA, int(k)) for k in rng.integers(DNA_MIN, DNA_MAX + 1, n)]


def write_fasta(path: Path, seqs) -> Path:
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">s%d\n" % i + s.tobytes() + b"\n")
    return path


# ---------------------------------------------------------------------------
# The plain reference on the card


def reference_scores(ss, I, J, algo, sub, gaps):
    """Scores of pairs (I[t], J[t]) of ``ss`` by the XLA scan on the default
    device, in groups padded to the scheduler's length edges."""
    from sequencealigner_tpu.ops import scorer, xla_dp
    from sequencealigner_tpu.scheduler import bucket_edges

    lens = ss.lengths.astype(np.int64)
    longer = lens[I] >= lens[J]
    c = np.where(longer, I, J)
    k = np.where(longer, J, I)
    order = np.lexsort((lens[k], lens[c]))
    sub_p = xla_dp.padded_submatrix(sub)
    g = np.array(gaps, np.int32)
    out = np.empty(len(I), np.int64)

    def edge(n):
        return bucket_edges(int(n))[-1]

    pos = 0
    while pos < len(order):
        Lc = edge(lens[c[order[min(pos + 511, len(order) - 1)]]])
        Lk = edge(lens[k[order[pos : pos + 512]]].max())
        B = int(max(32, min(512, (1 << 28) // (Lc * Lk))))
        B = 1 << (B.bit_length() - 1)
        idx = order[pos : pos + B]
        Lc = edge(lens[c[idx]].max())
        Lk = edge(lens[k[idx]].max())
        s1 = np.full((B, Lc), xla_dp.PAD, np.int8)
        s2 = np.full((B, Lk), xla_dp.PAD, np.int8)
        l1 = np.zeros(B, np.int32)
        l2 = np.zeros(B, np.int32)
        for r, t in enumerate(idx):
            a, b = c[t], k[t]
            s1[r, : lens[a]] = ss.lut[ss.data[ss.offsets[a] : ss.offsets[a + 1]]]
            s2[r, : lens[b]] = ss.lut[ss.data[ss.offsets[b] : ss.offsets[b + 1]]]
            l1[r], l2[r] = lens[a], lens[b]
        got = scorer.score_block("xla", s1, s2, l1, l2, sub_p, g,
                                 algo=algo, Lc=Lc, Lk=Lk)
        out[idx] = np.asarray(got)[: len(idx)]
        pos += len(idx)
    return out


# ---------------------------------------------------------------------------
# Phases


def phase_device(want_count: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[0] jax devices: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    check(d.platform == "gpu", f"no GPU: JAX's default device is {d.platform}")
    check(len(devs) >= want_count, f"need {want_count} GPUs, have {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"[0] card: {line.strip()}")
    return d


def phase_build():
    from sequencealigner_tpu.ops import gpu_dp

    secs = gpu_dp.ensure_registered()
    log(f"[1] kernel build+register (set-up): {secs:.1f} s "
        f"({gpu_dp.library_path().name})")


def phase_kernel(rng, clock: CompileClock):
    import jax

    from sequencealigner_tpu import matrices
    from sequencealigner_tpu.ops import gpu_dp, oracle, scorer, xla_dp

    m = matrices.get("blosum62")
    sub_p = xla_dp.padded_submatrix(m.matrix)
    kern = jax.jit(gpu_dp.align_block, static_argnames=("algo", "Lc", "Lk"))
    n_oracle = 0
    t0, c0 = time.perf_counter(), clock.total
    for Lc, Lk in KERNEL_SHAPES:
        B = int(min(2048, max(64, (1 << 27) // (Lc * Lk))))
        l1 = rng.integers(1, Lc + 1, B).astype(np.int32)
        l2 = rng.integers(1, Lk + 1, B).astype(np.int32)
        l1[0], l2[0] = Lc, Lk
        s1 = np.full((B, Lc), xla_dp.PAD, np.int8)
        s2 = np.full((B, Lk), xla_dp.PAD, np.int8)
        for b in range(B):
            s1[b, : l1[b]] = rng.integers(0, 20, l1[b])
            s2[b, : l2[b]] = rng.integers(0, 20, l2[b])
        for algo, gaps in GAPS.items():
            g = np.array(gaps, np.int32)
            got = np.asarray(kern(s1, s2, l1, l2, sub_p, g, algo=algo, Lc=Lc, Lk=Lk))
            want = np.asarray(scorer.score_block(
                "xla", s1, s2, l1, l2, sub_p, g, algo=algo, Lc=Lc, Lk=Lk))
            diff = int(np.abs(got.astype(np.int64) - want).max())
            msg = f"[2] {algo} {Lc}x{Lk} B={B}: max |kernel - xla_dp| = {diff}"
            if Lc <= 64:
                for b in range(8):
                    ref = oracle.align_score(
                        algo, s1[b, : l1[b]], s2[b, : l2[b]], m.matrix,
                        gap=gaps[0], opn=gaps[1], ext=gaps[2])
                    check(got[b] == ref, f"{algo} {Lc}x{Lk} pair {b}: "
                          f"kernel {got[b]} != oracle {ref}")
                n_oracle += 8
                msg += ", 8 pairs == oracle"
            log(msg)
            check(diff == 0, f"kernel differs from xla_dp at {algo} {Lc}x{Lk}")
    check(n_oracle >= 20, "too few oracle checks")
    log(f"[2] {n_oracle} pairs checked against ops/oracle.py; "
        f"{time.perf_counter() - t0:.1f} s ({clock.total - c0:.1f} s compiling)")

    import pytest

    os.environ["JAX_PLATFORMS"] = "cuda,cpu"  # conftest keeps this process's
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests")])
    log(f"[2] pytest -m gpu: exit {int(rc)}")
    check(int(rc) == 0, "pytest -m gpu failed")


def run_cli(name, fasta, argv, algo, sub, rng, clock: CompileClock, write: bool):
    """One CLI run in process; verifies its matrix against the reference."""
    from sequencealigner_tpu import cli
    from sequencealigner_tpu.engine import Engine
    from sequencealigner_tpu.io.output import OutputStore

    seen = {}
    orig = Engine.align_all

    def capture(self, ss, store, **kw):
        if store is None:  # -W: keep the scores in memory for the check
            store = OutputStore(ss.num, triangular=True, spill=False)
        stats = orig(self, ss, store, **kw)
        seen.update(ss=ss, store=store, stats=stats, engine=self)
        return stats

    out = WORK / f"{name}.h5"
    out.unlink(missing_ok=True)
    io_args = ["-o", str(out)] if write else ["-W"]
    c0 = clock.total
    Engine.align_all = capture
    try:
        rc = cli.run(["-i", str(fasta), *io_args, *argv, "-F", "-P", "-B"])
    finally:
        Engine.align_all = orig
    check(rc == 0, f"{name}: CLI exit {rc}")
    compile_s = clock.total - c0
    ss, stats, eng = seen["ss"], seen["stats"], seen["engine"]
    check(eng.scorer == "kernel" and eng.platform == "gpu",
          f"{name}: aligned with the {eng.scorer} scorer on {eng.platform}")
    n = ss.num
    if write:
        import h5py

        with h5py.File(out) as f:
            mat = f["/similarity_matrix"][...]
        check(mat.shape == (n, n), f"{name}: matrix shape {mat.shape}")
        check(np.array_equal(mat, mat.T), f"{name}: matrix not symmetric")
        check(not mat.diagonal().any(), f"{name}: nonzero diagonal")
        lookup = lambda I, J: mat[I, J]
    else:
        rows = seen["store"].rows(0, n)
        check(np.array_equal(rows, rows.T), f"{name}: store not symmetric")
        lookup = seen["store"].read_pairs
    I = rng.integers(0, n, N_SAMPLES)
    J = rng.integers(0, n - 1, N_SAMPLES)
    J = np.where(J >= I, J + 1, J)  # i != j
    top = int(np.argmax(ss.lengths))
    rest = np.delete(np.arange(n), top)
    I = np.r_[I, np.full(n - 1, top)]
    J = np.r_[J, rest]
    lo, hi = np.minimum(I, J), np.maximum(I, J)
    t0 = time.perf_counter()
    want = reference_scores(ss, lo, hi, algo, sub, GAPS[algo])
    got = np.asarray(lookup(lo, hi), np.int64)
    bad = int((got != want).sum())
    log(f"[3] {name}: n={n} pairs={stats.pairs} in {stats.seconds:.3f} s: "
        f"{stats.pairs_per_sec:.1f} pairs/s, {stats.gcups:.3f} GCUPS, "
        f"compile {compile_s:.1f} s; {len(I)} sampled pairs "
        f"(incl. all {n - 1} of the longest, {ss.lengths[top]} long) vs "
        f"xla_dp: {bad} differ ({time.perf_counter() - t0:.1f} s)")
    check(bad == 0, f"{name}: {bad} pairs differ from the reference")


def phase_cli(rng, clock: CompileClock):
    from sequencealigner_tpu import matrices
    from sequencealigner_tpu.scheduler import Schedule

    try:
        import h5py  # noqa: F401
        write = True
        log("[3] h5py present: checking the HDF5 output files")
    except ImportError:
        write = False
        log("[3] h5py missing: runs use -W and check the in-memory store")
    WORK.mkdir(parents=True, exist_ok=True)
    prot = protein_seqs(rng, N_PROT)
    lens = np.array([len(s) for s in prot])
    sched = Schedule.build(lens)
    log(f"[3] proteins: n={len(prot)} mean length {lens.mean():.1f}, "
        f"max {lens.max()}, {len(sched.buckets)} buckets, "
        f"{len(sched.combos())} combos, {sched.total_pairs()} pairs")
    full = write_fasta(WORK / "proteins.fasta", prot)
    sub = write_fasta(WORK / "proteins_1k.fasta", prot[:N_PROT_SUB])
    dna = write_fasta(WORK / "dna.fasta", dna_seqs(rng, N_DNA))
    b62 = matrices.get("blosum62").matrix
    nuc = matrices.get("nuc44").matrix
    affine = ["-s", "10", "-e", "1"]
    runs = [
        ("ga_proteins", full, ["-m", "blosum62", "-a", "ga", *affine], "ga", b62),
        ("nw_proteins_1k", sub, ["-m", "blosum62", "-a", "nw", "-p", "4"], "nw", b62),
        ("sw_proteins_1k", sub, ["-m", "blosum62", "-a", "sw", *affine], "sw", b62),
        ("ga_proteins_1k_filter", sub,
         ["-m", "blosum62", "-a", "ga", *affine, "-f", "0.9"], "ga", b62),
        ("ga_dna", dna, ["-m", "nuc44", "-a", "ga", *affine], "ga", nuc),
    ]
    for name, fasta, argv, algo, mat in runs:
        run_cli(name, fasta, argv, algo, mat, rng, clock, write)


def phase_four_cards(rng, clock: CompileClock):
    from sequencealigner_tpu import matrices
    from sequencealigner_tpu.engine import Engine, make_mesh
    from sequencealigner_tpu.io.input import SequenceSet
    from sequencealigner_tpu.io.output import OutputStore
    from sequencealigner_tpu.scheduler import Schedule

    m = matrices.get("blosum62")
    ss = SequenceSet.from_list(protein_seqs(rng, N_PROT), m.lut)
    log(f"[4] proteins: n={ss.num}, "
        f"{len(Schedule.build(ss.lengths).buckets)} buckets")
    mats = []
    for ndev in (4, 1):
        mesh = make_mesh("gpu", ndev)
        check(mesh.devices.size == ndev, f"mesh of {mesh.devices.size} GPUs")
        store = OutputStore(ss.num, triangular=True, spill=False)
        eng = Engine("ga", m.matrix, GAPS["ga"], mesh=mesh)
        c0 = clock.total
        stats = eng.align_all(ss, store, progress=False)
        log(f"[4] {ndev} GPU(s): {stats.pairs} pairs in {stats.seconds:.3f} s "
            f"({stats.pairs_per_sec:.1f} pairs/s, {stats.gcups:.3f} GCUPS, "
            f"compile {clock.total - c0:.1f} s)")
        mats.append(np.asarray(store.matrix))
    same = np.array_equal(mats[0], mats[1])
    log(f"[4] 4-GPU and 1-GPU matrices bit-equal: {same}")
    check(same, "4-GPU matrix differs from the 1-GPU matrix")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh comparison (phase 4)")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)
    try:
        import jax

        import sequencealigner_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the aligner ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    try:
        dev = phase_device(4 if args.four_cards else 1)
        clock = CompileClock()
        phase_build()
        if args.four_cards:
            phase_four_cards(rng, clock)
        else:
            phase_kernel(rng, clock)
            phase_cli(rng, clock)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
