"""Multi-host distribution of the pair space.

The reference is strictly single-process / single-GPU (SURVEY.md §2.7:
``cudaSetDevice(0)`` hardcoded, seqalign_cuda.c:65).  This module is the
scale-out it never had, per the SURVEY plan: the schedule's
superblock stream is deterministically striped across hosts (pairs are
sharded, never one DP matrix), each host scores its stripe on its local
devices, and score triplets are merged with ``process_allgather`` over
the network so every host ends with the complete result.  No sequence data moves:
inputs are replicated (every host parses the same file), only final scores
(20 B/pair, packed — see pack_triplets) cross the network.

Design notes:
- Striping is by global superblock index (round-robin), which balances load
  because blocks within a bucket-combo have uniform cell cost and combos are
  interleaved across hosts.
- Merge points must be globally deterministic: the engine counts *all* blocks
  (owned or not) toward its flush threshold, so every host reaches each merge
  point after the same block sequence, keeping the collective aligned.
- ``jax.distributed.initialize`` is driven by env vars so the same CLI works
  single-host (no-op) and under a pod launcher.
"""

from __future__ import annotations

import os

import numpy as np


def init_from_env() -> tuple[int, int]:
    """Initialize the JAX distributed runtime when the environment asks for
    it; returns (process_index, process_count).

    Env contract (same triple the standard launchers provide):
      SEQALIGN_TPU_COORDINATOR=host:port  SEQALIGN_TPU_NUM_PROCESSES=N
      SEQALIGN_TPU_PROCESS_ID=K — or rely on jax.distributed's own
      auto-detection (a cluster launcher's environment) by setting
      SEQALIGN_TPU_DISTRIBUTED=1.
    """
    import jax

    coord = os.environ.get("SEQALIGN_TPU_COORDINATOR")
    auto = os.environ.get("SEQALIGN_TPU_DISTRIBUTED") == "1"
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["SEQALIGN_TPU_NUM_PROCESSES"]),
            process_id=int(os.environ["SEQALIGN_TPU_PROCESS_ID"]),
        )
    elif auto:
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()


def default_gather():
    """The real collective (lazy import; only touched multi-process)."""
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather


#: Quantum (int32 words, 4 MiB) the packed payload is padded to: the
#: underlying collective compiles per shape, so quantizing bounds a whole
#: run's compile set to ~max-flush/4MiB executables instead of one per
#: flush, at <= one quantum of padding (a power-of-two scheme measured up
#: to 67% padded bytes at large flushes).
PAD_QUANTUM = 1 << 20


def pack_triplets(i, j, s, cap: int) -> np.ndarray:
    """One host's (i, j, score) triplets as a single padded int32 payload:
    [i as little-endian int64 word pairs | j likewise | s], zero-padded to
    ``cap`` words.  5 words (20 B) per pair — one collective moves the whole
    flush, where the previous layout cost four (sizes + three dtype-split
    gathers, each a fresh executable whenever the flush size changed)."""
    n = len(s)
    buf = np.zeros(cap, np.int32)
    buf[: 2 * n] = np.ascontiguousarray(np.asarray(i, np.int64)).view(np.int32)
    buf[2 * n : 4 * n] = np.ascontiguousarray(
        np.asarray(j, np.int64)
    ).view(np.int32)
    buf[4 * n : 5 * n] = np.asarray(s, np.int32)
    return buf


class TripletMerger:
    """Exchange (i, j, score) triplets between hosts; every host returns the
    union, so each host's OutputStore converges to the full matrix.

    ``gather`` maps a host-local ndarray to a stacked (nhosts, ...) ndarray
    (injected in tests; defaults to jax.experimental.multihost_utils
    process_allgather over the network).  Two collectives per merge: a fixed-shape
    word-count exchange, then ONE packed payload gather (pack_triplets).
    """

    def __init__(self, nhosts: int, gather=None):
        self.nhosts = nhosts
        self._gather = gather

    def __call__(
        self, i: np.ndarray, j: np.ndarray, s: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.nhosts == 1:
            return i, j, s
        gather = self._gather or default_gather()
        words = np.asarray([5 * len(s)], dtype=np.int64)
        sizes = np.asarray(gather(words)).reshape(-1)
        m = int(sizes.max())
        if m == 0:
            # Every host is empty at this flush point (common in striped runs:
            # the engine flushes on a global cadence whether or not this host
            # owned blocks since the last one) — skip the >= 4 MiB-per-host
            # padded payload gather entirely; the word-count exchange above
            # already kept the collective aligned.
            return i, j, s
        cap = max(PAD_QUANTUM, -(-m // PAD_QUANTUM) * PAD_QUANTUM)
        g = np.asarray(gather(pack_triplets(i, j, s, cap)))  # (nhosts, cap)
        ii, jj, ss = [], [], []
        for h in range(len(sizes)):
            nh = int(sizes[h]) // 5
            row = g[h]
            ii.append(np.ascontiguousarray(row[: 2 * nh]).view(np.int64))
            jj.append(np.ascontiguousarray(row[2 * nh : 4 * nh]).view(np.int64))
            ss.append(row[4 * nh : 5 * nh])
        return np.concatenate(ii), np.concatenate(jj), np.concatenate(ss)


def barrier(name: str = "seqalign") -> None:
    """Cross-host sync point (e.g. before host 0 writes the output file)."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)
