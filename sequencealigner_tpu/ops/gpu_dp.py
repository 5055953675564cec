"""GPU scorer: the Hopper DP kernel (native/dp_hopper.cu) through jax.ffi.

Same contract as ``xla_dp.align_block``: per-pair codes, true lengths, the
padded substitution table and the gap triple in; (B,) int32 scores out.  The
wrapper narrows codes to int8, lays them out pair-minor ((L, B): a warp's 32
threads read 32 consecutive bytes per column), pads the rows to a multiple
of the kernel's register chunk and the pairs to whole thread blocks (padding
pairs have length 0, cost no work and are sliced off), and asks XLA for the
chunk-crossing scratch as a second result.  The kernel has no length cap.

The shared library is compiled from the tracked source with ``nvcc`` at first
use on a GPU (``ensure_registered``), into ``build/`` at the repository
root, under a name keyed by a hash of the source and the command line.  A
missing compiler or a failed build raises with the compiler's message; there
is no fallback.  ``python -m sequencealigner_tpu.ops.gpu_dp`` builds it
ahead of time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .xla_dp import PAD

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "dp_hopper.cu"
BUILD_DIR = ROOT / "build"
TARGET = "seqalign_dp"
#: Pairs per thread block (kThreads in the .cu source).
THREADS = 128
#: Register-chunk heights the kernel is instantiated for (template R).
CHUNK_ROWS = (16, 24, 32)
ALGO_IDS = {"nw": 0, "ga": 1, "sw": 2}


def chunk_rows(Lk: int) -> int:
    """Rows per register chunk: the smallest instantiation that holds a
    whole Lk-row pair, else the largest (rows past a pair's length in its
    last chunk are wasted work)."""
    return next((r for r in CHUNK_ROWS if Lk <= r), CHUNK_ROWS[-1])


def nvcc_command(nvcc: str, src: Path, out: Path, include_dir: str) -> list[str]:
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", include_dir,
        "-o", str(out), str(src),
    ]


def library_path(src: Path = SOURCE) -> Path:
    """Build output, keyed by the source and the command line."""
    cmd = nvcc_command("nvcc", src, Path("out"), "inc")
    key = hashlib.sha256(src.read_bytes() + " ".join(cmd).encode())
    return BUILD_DIR / f"libseqalign_dp-{key.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if not cand.exists():
            raise RuntimeError(
                "nvcc not found (PATH or $CUDA_HOME/bin): the GPU DP kernel "
                "cannot be built"
            )
        nvcc = str(cand)
    return nvcc


def build() -> Path:
    """Compile the kernel library if this source has not been built yet."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = nvcc_command(find_nvcc(), SOURCE, tmp, jax.ffi.include_dir())
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the GPU DP kernel failed ({' '.join(cmd)}):\n"
            f"{r.stderr}{r.stdout}"
        )
    tmp.replace(so)
    return so


@functools.cache
def ensure_registered() -> float:
    """Build (if needed), load and register the FFI target once per
    process; returns the seconds it took (set-up time)."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build()))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.SeqalignDp), platform="CUDA"
    )
    return time.perf_counter() - t0


def align_block(s1, s2, l1, l2, sub_p, gaps, *, algo: str, Lc: int, Lk: int):
    """Score a block of pairs on the GPU (see module notes).

    s1: (B, Lc) codes of the column sequences, s2: (B, Lk) of the row
    sequences (any integer dtype, values 0..PAD); l1, l2: (B,) true lengths
    (0 marks a padding slot); sub_p: (25, 25) int32; gaps: (3,) int32.
    Returns (B,) int32 scores."""
    B = s1.shape[0]
    R = chunk_rows(Lk)
    Lkp = -(-Lk // R) * R
    Bp = max(THREADS, -(-B // THREADS) * THREADS)
    s1t = jnp.pad(
        s1.astype(jnp.int8), ((0, Bp - B), (0, 0)), constant_values=PAD
    ).T
    s2t = jnp.pad(
        s2.astype(jnp.int8), ((0, Bp - B), (0, Lkp - Lk)), constant_values=PAD
    ).T
    l1p = jnp.pad(jnp.asarray(l1, jnp.int32), (0, Bp - B))
    l2p = jnp.pad(jnp.asarray(l2, jnp.int32), (0, Bp - B))
    planes = 1 if algo == "nw" else 2
    scores, _ = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((Bp,), jnp.int32),
            jax.ShapeDtypeStruct((planes, Lc, Bp), jnp.int32),
        ),
    )(
        s1t, s2t, l1p, l2p,
        jnp.asarray(sub_p, jnp.int32), jnp.asarray(gaps, jnp.int32),
        algo=np.int32(ALGO_IDS[algo]), rows=np.int32(R),
    )
    return scores[:B]


if __name__ == "__main__":
    t0 = time.perf_counter()
    print(build(), f"{time.perf_counter() - t0:.1f}s")
