"""Cold-compile budget of the engine's executable set.

The reference compiles ONCE, at build time (`/root/reference/CMakeLists.txt`);
this framework compiles one executable per dispatch shape at first run,
amortized by JAX's persistent compilation cache.  This harness measures
that budget directly, without paying for the alignment around it:

1. **Capture** — run the real engine over the 50k-scale DNA mix
   (`scale_run.make_dna`, same rng) on the CPU backend, with the engine's
   scorer set to the one the target platform uses ("kernel" for a GPU) and
   the dispatch entry point (`_score_stack`) stubbed to record its
   (static-key, arg-shape) signatures and return zeros.  This enumerates the
   EXACT executable set a cold run compiles.
2. **Compile** — on the default backend, `.lower().compile()` each unique
   signature once against a FRESH compilation-cache directory, timing each.

Emits JSON lines.

Usage: python benchmarks/cold_compile.py [--n 50000] [--max-seconds 1800]
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def log(**kw):
    print(json.dumps(kw), flush=True)


def capture_keys(n: int, kind: str):
    """Enumerate the dispatch signatures of a full n-sequence run (CPU)."""
    import jax

    from benchmarks.scale_run import make_dna
    from sequencealigner_tpu import engine as eng_mod

    rng = np.random.default_rng(4)  # scale_run's config-4 dataset
    ss, m = make_dna(rng, n)

    sigs = {}

    def stub_stack(bc, bk, lc, lk, starts, sub_p, gaps, **st):
        key = (tuple(sorted(st.items())), tuple(
            (tuple(a.shape), str(a.dtype))
            for a in (bc, bk, lc, lk, starts, sub_p, gaps)
        ))
        sigs[key] = sigs.get(key, 0) + 1
        dt = np.int16 if st["int16_ok"] else np.int32
        return jax.numpy.zeros((starts.shape[0] - 1, st["Wloc"]), dt)

    real_stack = eng_mod._score_stack
    eng_mod._score_stack = stub_stack
    try:
        eng = eng_mod.Engine("ga", m.matrix, (0, -10, -1),
                             mesh=eng_mod.make_mesh("cpu", 1))
        eng.scorer = kind
        t0 = time.perf_counter()
        st = eng.align_all(ss, None, progress=False)
        log(phase="capture", n=n, scorer=kind, pairs=st.pairs,
            dispatches=sum(sigs.values()), unique_executables=len(sigs),
            capture_seconds=round(time.perf_counter() - t0, 1))
    finally:
        eng_mod._score_stack = real_stack
    return sigs


def compile_all(sigs, max_seconds: float):
    import jax
    from sequencealigner_tpu import engine as eng_mod
    from sequencealigner_tpu.ops import gpu_dp

    dev = jax.devices()[0]
    fresh = tempfile.mkdtemp(prefix="xla-cold-")
    jax.config.update("jax_compilation_cache_dir", fresh)
    log(phase="compile_setup", backend=dev.platform, kind=dev.device_kind,
        cache_dir=fresh)
    if dev.platform == "gpu":
        log(phase="kernel_build", seconds=round(gpu_dp.ensure_registered(), 1))

    rows = []
    t_start = time.perf_counter()
    truncated = False
    for (st, shapes), count in sorted(sigs.items()):
        static = dict(st)
        avals = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
        t0 = time.perf_counter()
        eng_mod._score_stack.lower(*avals, **static).compile()
        dt = time.perf_counter() - t0
        rows.append((dt, static, shapes[4][0][0], count))
        if time.perf_counter() - t_start > max_seconds:
            truncated = True
            break
    total = time.perf_counter() - t_start
    done = len(rows)
    rows.sort(key=lambda r: -r[0])
    log(phase="compile", executables_compiled=done,
        executables_total=len(sigs), truncated=truncated,
        total_compile_seconds=round(total, 1),
        mean_seconds=round(total / max(done, 1), 2),
        slowest=[dict(seconds=round(dt, 1), **{
            kk: vv for kk, vv in st.items()
            if kk in ("kind", "algo", "Lc", "Lk", "Wloc", "mode")
        }, stack=nblk - 1) for dt, st, nblk, _ in rows[:6]])
    if truncated and done:
        est = total / done * len(sigs)
        log(phase="estimate", projected_total_seconds=round(est, 1))
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--max-seconds", type=float, default=1800)
    ap.add_argument("--capture-only", action="store_true")
    args = ap.parse_args()

    import jax

    kind = "kernel" if jax.devices()[0].platform == "gpu" else "xla"
    sigs = capture_keys(args.n, kind)
    if args.capture_only:
        return
    compile_all(sigs, args.max_seconds)


if __name__ == "__main__":
    main()
