"""Host-system helpers: memory probe, temp-file-backed arrays, thread config.

Equivalents of the reference's system layer
(/root/reference/src/system/os.c): available_memory from /proc/meminfo
MemAvailable (os.c:269-284), temp-file-backed mmap for beyond-RAM result
matrices (os.c:110-139), and the -T thread-count knob (os.c:462-495).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

THREAD_MAX = 1024
#: 0 = auto (all cores), set by the -T flag.
THREAD_NUM = 0


def set_threads(n: int) -> int:
    """Configure host worker thread count (parsing / writeback / native
    OpenMP ops); 0 = auto.  The -T equivalent of omp_set_num_threads
    (reference src/system/os.c:466-473) — exported via OMP_NUM_THREADS so
    the ctypes-loaded native libraries (native/hostops.c) honor it."""
    global THREAD_NUM
    THREAD_NUM = n if n > 0 else (os.cpu_count() or 1)
    if n > 0:
        os.environ["OMP_NUM_THREADS"] = str(THREAD_NUM)
        # The env var is only read at libgomp INITIALIZATION — if a native
        # lib already ran a parallel region before -T was processed, it would
        # be silently ignored.  Call omp_set_num_threads on any loaded
        # OpenMP-linked library as well.
        try:
            from .io import native

            lib = native.hostops()
            if lib is not None:
                lib.omp_set_num_threads(THREAD_NUM)
        except Exception:
            pass
    return THREAD_NUM


def get_threads() -> int:
    return THREAD_NUM if THREAD_NUM > 0 else (os.cpu_count() or 1)


def available_memory() -> int:
    """Bytes of available RAM (MemAvailable, fallback total/2)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2
    except (ValueError, OSError):
        return 4 << 30


def alloc_array(n_elems: int, dtype, spill_to_disk: bool):
    """Zeroed int array, RAM-backed or an unlinked temp-file memmap (the
    disk-spill analogue of alloc_mmap(bytes, tmpfile=true), os.c:110-139)."""
    if not spill_to_disk:
        return np.zeros(n_elems, dtype=dtype)
    f = tempfile.TemporaryFile(dir=os.environ.get("TMPDIR", "/tmp"))
    f.truncate(int(n_elems) * np.dtype(dtype).itemsize)
    mm = np.memmap(f, dtype=dtype, mode="r+", shape=(int(n_elems),))
    mm._tmpfile_ref = f  # keep the fd alive as long as the array
    return mm
