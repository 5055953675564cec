"""Alignment engine: orchestrates bucketed pair blocks onto the device mesh.

The orchestration layer of the reference (/root/reference/src/interface/
seqalign_cuda.c) is a CUDA batch loop with two streams (:151-290).  Here,
superblocks of pairs are dispatched asynchronously under jit and resolved
lazily: JAX's async dispatch overlaps device compute with host-side
scatter, and results are concatenated on-device so a whole flush costs ONE
host synchronization.

One scorer per platform (ops/scorer.py): on a GPU mesh the Hopper DP kernel
(ops/gpu_dp.py), on the CPU the XLA lax.scan wavefront (ops/xla_dp.py).
The block batch dimension is sharded over a 1-D ``pairs`` mesh axis (data
parallelism over the pair space — the only parallelism the problem has,
SURVEY.md §2.7); sequence data is replicated so scoring needs no
cross-device communication at all.

Device memory never holds the N^2 matrix: scores stream back per flush
(hence no analogue of the reference's cuda_memory() planner is needed).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
import zlib
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import ui
from .io.input import SequenceSet
from .io.output import OutputStore
from .ops import gpu_dp, scorer
from .ops.xla_dp import PAD, padded_submatrix
from .scheduler import Schedule

ALGOS = ("nw", "ga", "sw")

#: Pairs in flight before a flush (bounds host memory for block metadata).
#: Flushes run on a background thread (see align_all.do_flush), so a smaller
#: value trades a little per-dispatch overhead for D2H-fetch/scatter overlap
#: with the next wave's device compute.
FLUSH_PAIRS = int(os.environ.get("SEQALIGN_TPU_FLUSH_PAIRS", 1 << 22))

#: Seconds between checkpoint sync points (journal runs only).  Each sync
#: msyncs the persistent score store and then commits the journaled block
#: ids accumulated since the last sync.  Syncing EVERY flush is ruinous for
#: large full-matrix stores: one flush's random scatter dirties nearly every
#: page of the file (e.g. ~10 GB at n=50k), so per-flush msync rewrites the
#: whole store to disk at flush cadence and saturates the disk.  Interval batching bounds the machine-crash
#: durability window to this many seconds (process crashes lose nothing
#: extra: page cache survives SIGKILL; uncommitted blocks are recomputed on
#: resume either way).  0 = sync at every flush (the old behavior).
SYNC_INTERVAL = float(os.environ.get("SEQALIGN_TPU_SYNC_INTERVAL", 300.0))

#: Pairs per kernel launch on each GPU: 256 blocks of 128 threads, several
#: warps on each of an H100's 132 SMs.
GPU_PAIRS = 1 << 15

#: Cap on Lc x pairs per GPU launch, bounding the kernel's chunk-crossing
#: scratch (two int32 planes) at 1 GiB for long pairs.
GPU_SCRATCH_CELLS = 1 << 27

#: Persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is not
#: set: a fixed path inside the checkout (the path is part of the key, so a
#: moving directory would never hit).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


@functools.cache
def enable_compile_cache() -> str:
    """Keep compiled executables across runs: the bucketed schedule compiles
    one executable per (algo, Lc, Lk, width) shape.  JAX itself honours
    JAX_COMPILATION_CACHE_DIR; only without it is the checkout's own
    directory configured.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return str(DEFAULT_CACHE_DIR)


def make_mesh(device_kind: str = "auto", n_devices: int | None = None) -> Mesh:
    """1-D mesh over the pair axis, LOCAL devices only: in multi-host runs
    each host's engine scores its own block stripe on its own devices and
    cross-host merging is explicit (parallel/multihost.py) — a global-device
    mesh would instead require all hosts in lockstep for every dispatch.
    device_kind 'cpu' is the -C path (seqalign_cuda.c:318-328); it asks for
    the CPU backend alone, so it never initializes an accelerator."""
    if device_kind == "cpu":
        devs = jax.devices("cpu")
    else:
        devs = [
            d for d in jax.local_devices()
            if device_kind == "auto" or d.platform == device_kind
        ]
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("pairs",))


def _int32_ids_ok(npairs: int, same: bool, rows: int) -> bool:
    """Whether _gather_pairs may run its int32 fast path for a combo: all
    linear ids must fit int32 AND, for triangle (same-bucket) combos, the
    j*(j-1) intermediate of the inversion must too — j reaches the bucket
    row count, so rows above 46340 (~sqrt(2^31)) overflow int32 even though
    npairs itself still fits (46342..65536-row buckets hit exactly this
    window; int64 arithmetic is exact there, merely slower)."""
    return npairs < (1 << 31) and (not same or rows <= 46340)


def _tri_invert(lin, it):
    """Closed-form triangle inversion lin -> (j, i), i < j (the vectorized
    d_find_j, reference src/bio/kernels.cu:17-30): float32 sqrt + two
    integer corrections — exact for row counts up to ~16M."""
    j = ((1.0 + jnp.sqrt(1.0 + 8.0 * lin.astype(jnp.float32))) * 0.5
         ).astype(it)
    for _ in range(2):
        j = jnp.where(j * (j - 1) // 2 > lin, j - 1, j)
        j = jnp.where((j + 1) * j // 2 <= lin, j + 1, j)
    return j, lin - j * (j - 1) // 2


def _pair_rows(lens_k, t0, npairs, *, Wloc, mode, small, shard_offset=None):
    """Per-pair combo-local row indices (rc, rk) and the valid-slot mask,
    derived ON DEVICE from a superblock's first linear id — the host ships
    8 bytes per superblock instead of 16 bytes per pair.  ``mode``:

    - 'rect': cross-bucket rectangle, id = rc * count_k + rk.
    - 'tri': within-bucket triangle, id = rc*(rc-1)/2 + rk (closed-form
      inversion; int64 arithmetic is avoided when the combo's pair count
      fits int32: ``small``, a static flag).

    Slots past ``npairs`` are padding: they map to the dummy pair (0, 0).
    ``shard_offset`` (set under shard_map) positions this device's
    Wloc-wide slice."""
    lin = t0 + jnp.arange(Wloc, dtype=jnp.int64)
    if shard_offset is not None:
        lin = lin + shard_offset
    valid = lin < npairs
    lin = jnp.where(valid, lin, 0)
    it = jnp.int32 if small else jnp.int64
    lin = lin.astype(it)
    if mode == "tri":
        j, i = _tri_invert(lin, it)
        rc = j.astype(jnp.int32)
        rk = i.astype(jnp.int32)
    else:
        rows = lens_k.shape[0]  # static bucket row count
        rk = (lin % rows).astype(jnp.int32)  # constant-divisor division
        rc = (lin // rows).astype(jnp.int32)
    return rc, rk, valid


def _gather_pairs(
    bucket_c, bucket_k, lens_c, lens_k, t0, npairs,
    *, Wloc, mode, small, shard_offset=None,
):
    """Gathered per-pair code rows (the buckets' int8 codes) and lengths for
    one superblock; padding slots get length 0, which the GPU kernel skips
    and the XLA scan scores as an empty pair."""
    rc, rk, valid = _pair_rows(
        lens_k, t0, npairs, Wloc=Wloc, mode=mode, small=small,
        shard_offset=shard_offset,
    )
    l1 = jnp.where(valid, lens_c[rc], 0)
    l2 = jnp.where(valid, lens_k[rk], 0)
    return bucket_c[rc], bucket_k[rk], l1, l2


def _stack_body(
    bucket_c, bucket_k, lens_c, lens_k, starts, sub_p, gaps,
    *, kind, algo, Lc, Lk, Wloc, mode, small, int16_ok, shard_offset=None,
):
    """Score a stack of superblocks in a single dispatch: lax.map over the
    (nblk,) superblock start ids compiles the per-superblock body once and
    the device runs the whole stack without host round trips (the reference's
    CUDA batch loop, seqalign_cuda.c:183-290, needs host code per batch; here
    the 'loop' is compiled in).

    starts[0] is the combo's pair count, starts[1:] the superblock start
    ids — folding npairs into the one per-dispatch transfer instead of a
    separate 8-byte put per combo."""
    npairs = starts[0]
    starts = starts[1:]

    def body(t0):
        s1, s2, l1b, l2b = _gather_pairs(
            bucket_c, bucket_k, lens_c, lens_k, t0, npairs,
            Wloc=Wloc, mode=mode, small=small, shard_offset=shard_offset,
        )
        out = scorer.score_block(
            kind, s1, s2, l1b, l2b, sub_p, gaps, algo=algo, Lc=Lc, Lk=Lk
        )
        if int16_ok:
            # Scores provably fit int16 (bound computed by the engine from
            # the actual gap penalties and substitution range): halve the
            # device->host transfer; scores upcast right after the fetch.
            out = out.astype(jnp.int16)
        return out

    return _map1(body, starts)


def _map1(body, xs):
    """lax.map that skips the loop machinery for single-element stacks
    (common: mid-shape segments are often one superblock; the while-loop
    wrapper measurably costs on such dispatches)."""
    leaves = jax.tree_util.tree_leaves(xs)
    if leaves and leaves[0].shape[0] == 1:
        one = jax.tree_util.tree_map(lambda a: a[0], xs)
        out = body(one)
        return jax.tree_util.tree_map(lambda a: a[None], out)
    return jax.lax.map(body, xs)


@partial(
    jax.jit,
    static_argnames=(
        "kind", "algo", "Lc", "Lk", "Wloc", "mode", "small", "int16_ok",
    ),
)
def _score_stack(
    bucket_c, bucket_k, lens_c, lens_k, starts, sub_p, gaps,
    *, kind, algo, Lc, Lk, Wloc, mode, small, int16_ok,
):
    return _stack_body(
        bucket_c, bucket_k, lens_c, lens_k, starts, sub_p, gaps,
        kind=kind, algo=algo, Lc=Lc, Lk=Lk, Wloc=Wloc, mode=mode,
        small=small, int16_ok=int16_ok,
    )


@functools.lru_cache(maxsize=None)
def _sharded_scorer(
    mesh, kind: str, algo: str, Lc: int, Lk: int, Wloc: int, mode: str,
    small: bool, int16_ok: bool,
):
    """SPMD scorer over a >1-device mesh: each superblock is split on the
    pair axis with shard_map — sequences/LUT replicated, zero collectives
    (data parallelism over the pair space is the workload's whole parallel
    structure, SURVEY.md §2.7).  Explicit shard_map (rather than GSPMD
    inference) runs the GPU kernel's FFI call once per device."""

    def body(bucket_c, bucket_k, lens_c, lens_k, starts, sub_p, gaps):
        off = jax.lax.axis_index("pairs").astype(jnp.int64) * Wloc
        return _stack_body(
            bucket_c, bucket_k, lens_c, lens_k, starts, sub_p, gaps,
            kind=kind, algo=algo, Lc=Lc, Lk=Lk, Wloc=Wloc, mode=mode,
            small=small, int16_ok=int16_ok, shard_offset=off,
        )

    rep = P()
    f = shard_map(
        body, mesh=mesh,
        in_specs=(rep,) * 7,
        out_specs=P(None, "pairs"),
        check_vma=False,
    )
    return jax.jit(f)


@dataclasses.dataclass
class AlignStats:
    pairs: int = 0
    cells: int = 0
    seconds: float = 0.0
    pairs_resumed: int = 0  # skipped via checkpoint journal

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0


class Engine:
    """All-vs-all scorer over a device mesh; its scorer follows the mesh's
    platform (ops/scorer.py)."""

    def __init__(
        self,
        algo: str,
        sub: np.ndarray,
        gaps: tuple[int, int, int],
        *,
        mesh: Mesh | None = None,
        device_kind: str = "auto",
        target_cells: int | None = None,
    ):
        if algo not in ALGOS:
            raise ValueError(f"unknown algorithm {algo!r}")
        enable_compile_cache()
        self.algo = algo
        self.mesh = mesh if mesh is not None else make_mesh(device_kind)
        self.ndev = self.mesh.devices.size
        self.platform = self.mesh.devices.flat[0].platform
        self.scorer = scorer.kind_for(self.platform)
        if self.scorer == "kernel":
            gpu_dp.ensure_registered()
        self.sub_p = padded_submatrix(sub)
        self.sub_max = int(np.abs(np.asarray(sub, np.int64)).max())
        self.gaps = np.asarray(gaps, dtype=np.int32)
        self.target_cells = target_cells
        self._rep = NamedSharding(self.mesh, P())
        self._plock = threading.Lock()  # guards the pending list (poller)
        # One-entry cache of per-bucket device arrays, keyed by SequenceSet
        # identity: repeated align_all calls on the same set (benchmarks,
        # library use) skip the per-bucket uploads entirely — the reference
        # uploads sequences once per process too (seqalign_cuda.c:129-132).
        # Holding the strong reference keeps the identity check sound.
        self._bucket_cache: tuple | None = None

    def schedule_token(self, lengths) -> str:
        """Identifier of the block-schedule geometry this engine will use
        for ``lengths`` — bound into checkpoint fingerprints, because journal
        entries are global block indices and only mean the same pairs under
        the same schedule.  The suffix hashes the bucket boundaries, so ANY
        change to the bucketing policy (across engine versions) invalidates
        old journals instead of silently mis-mapping their block indices."""
        sched = Schedule.build(np.asarray(lengths))
        geo = zlib.crc32(np.asarray(
            [(b.edge, b.start, b.end) for b in sched.buckets], np.int64
        ).tobytes())
        return f"linear-v1.{geo:08x}"

    def _put_rep(self, x):
        return jax.device_put(x, self._rep)

    def _put_i64(self, x):
        # Explicit int64 transfer: with jax_explicit_x64_dtypes=allow only a
        # jnp array constructed with dtype=jnp.int64 keeps 64 bits (plain
        # device_put of an np.int64 array silently downcasts to int32).  The
        # construction is pinned to the MESH's backend: a bare jnp.asarray
        # would commit to the DEFAULT device, which for a CPU mesh in a
        # process with an accelerator is the wrong backend.
        with jax.default_device(self.mesh.devices.flat[0]):
            arr = jnp.asarray(np.asarray(x, np.int64), dtype=jnp.int64)
        return jax.device_put(arr, self._rep)

    def _bucket_arrays(self, ss: SequenceSet, sched: Schedule):
        """Per-bucket device-resident data: (count, edge) int8 code matrices
        (PAD beyond each length) and (count,) int32 lengths."""
        from .io import native

        lut = ss.lut
        arrays, lens = [], []
        for b in sched.buckets:
            rows = sched.order[b.start : b.end]
            mat = native.pack_rows(ss.data, ss.offsets, rows, b.edge, lut, PAD)
            if mat is None:
                mat = np.full((b.count, b.edge), PAD, dtype=np.int8)
                for local, orig in enumerate(rows):
                    s = ss.data[ss.offsets[orig] : ss.offsets[orig + 1]]
                    mat[local, : len(s)] = lut[s]
            blens = sched.lengths_sorted[b.start : b.end].astype(np.int32)
            arrays.append(self._put_rep(mat))
            lens.append(self._put_rep(blens))
        return arrays, lens

    def _superblock_width(self, Lc: int, Lk: int, npairs: int) -> int:
        """Pairs per superblock (a multiple of the mesh size)."""
        if self.scorer == "kernel":
            # Enough pairs per launch to give every SM several warps, shrunk
            # to the combo (padding slots cost no kernel work, only
            # transfer) and capped by the chunk-crossing scratch.
            per_dev = -(-npairs // self.ndev)
            w = 1 << max(0, per_dev - 1).bit_length()
            cap = max(gpu_dp.THREADS, GPU_SCRATCH_CELLS // Lc)
            cap = 1 << (cap.bit_length() - 1)
            w = max(gpu_dp.THREADS, min(w, GPU_PAIRS, cap))
            return w * self.ndev
        target = self.target_cells or (1 << 24)
        b = max(8, min(4096, target // (Lc * Lk)))
        b = 1 << (int(b).bit_length() - 1)
        while b // 2 >= max(self.ndev, 8) and b // 2 >= npairs:
            b //= 2
        b = max(b, self.ndev)
        if b % self.ndev:  # non-power-of-two meshes
            b = -(-b // self.ndev) * self.ndev
        return b

    def _int16_ok(self, Lc: int, Lk: int) -> bool:
        """Whether every score of an (Lc, Lk)-bucket pair provably fits
        int16: any alignment path has at most Lc + Lk steps, each changing
        the score by at most max(|sub|, |gap|, |open|, |extend|)."""
        step = max(self.sub_max, *(abs(int(g)) for g in np.asarray(self.gaps)))
        return (Lc + Lk) * step < 32767

    def _dispatch(self, blks, ctx, pending) -> None:
        """Ship one int64 start id per superblock and score per power-of-two
        segment (lax.map recompiles per stack length, so lengths are kept to
        powers of two — a bounded compile set); results stay on device until
        flush."""
        (bc, bk, lens_c, lens_k, npairs, sub_dev, gaps_dev,
         Lc, Lk, W, mode, small) = ctx
        int16_ok = self._int16_ok(Lc, Lk)
        off = 0
        while off < len(blks):
            seg = 1 << (len(blks) - off).bit_length() - 1
            part = blks[off : off + seg]
            off += seg
            # One transfer per dispatch: [npairs, start ids...].
            starts = self._put_i64([npairs] + [x.start for _, x in part])
            args = (bc, bk, lens_c, lens_k, starts, sub_dev, gaps_dev)
            if self.ndev > 1:
                dev = _sharded_scorer(
                    self.mesh, self.scorer, self.algo, Lc, Lk, W // self.ndev,
                    mode, small, int16_ok,
                )(*args)
            else:
                dev = _score_stack(
                    *args, kind=self.scorer, algo=self.algo, Lc=Lc, Lk=Lk,
                    Wloc=W, mode=mode, small=small, int16_ok=int16_ok,
                )
            with self._plock:
                flat = dev.reshape(-1)
                # Start the D2H copy the moment this dispatch's compute
                # finishes on device (the runtime queues it behind the
                # producer): score transfer overlaps later superblocks'
                # compute, and the flush-side wait only pays for the LAST
                # group's copy — the analogue of the reference's copy/compute
                # stream overlap (src/interface/seqalign_cuda.c:267-273).
                flat.copy_to_host_async()
                pending.append([flat, part, False])

    def align_all(
        self,
        ss: SequenceSet,
        store: OutputStore | None,
        *,
        progress: bool = True,
        partition: tuple[int, int] | None = None,
        merger=None,
        journal=None,
        limit_pairs: int | None = None,
    ) -> AlignStats:
        """Score the whole pair space into ``store``.

        limit_pairs: stop scheduling after ~this many pairs (rounded up to a
          whole superblock) — a benchmarking truncation for sustained-rate
          measurement on pair spaces too large to finish.

        partition: (host_id, nhosts) stripes the global superblock stream
          across hosts (multi-host data parallelism over pairs); flush points
          count *all* blocks so every host reaches each merge point together.
        merger: callable (i, j, scores) -> (i, j, scores) applied at flush —
          the multi-host all-gather (parallel.multihost.TripletMerger).
        journal: checkpoint.Journal; completed global block indices are
          skipped on resume and committed after each flush.
        """
        host_id, nhosts = partition if partition else (0, 1)
        phase_dbg = os.environ.get("SEQALIGN_TPU_DEBUG_PHASES")
        phases: dict = {}

        def mark(name, t_start):
            if phase_dbg:
                phases[name] = phases.get(name, 0.0) + (
                    time.perf_counter() - t_start
                )

        sched = Schedule.build(ss.lengths)
        total_pairs = sched.total_pairs()
        ui.pinfo("Performing %d pairwise alignments", total_pairs)
        bar = ui.Progress(total_pairs, "Aligning sequences") if progress else None

        t0 = time.perf_counter()
        if self._bucket_cache is not None and self._bucket_cache[0] is ss:
            buckets_dev, lens_dev, sub_dev, gaps_dev = self._bucket_cache[1]
        else:
            buckets_dev, lens_dev = self._bucket_arrays(ss, sched)
            sub_dev = self._put_rep(self.sub_p)
            gaps_dev = self._put_rep(self.gaps)
            self._bucket_cache = (
                ss, (buckets_dev, lens_dev, sub_dev, gaps_dev)
            )

        stats = AlignStats()
        commit_backlog: list = []  # journaled blocks awaiting a sync point
        last_sync = [time.perf_counter()]
        pending: list = []  # (dev_scores_flat, [(gidx, blk), ...])
        resumed_triplets: list = []  # journaled blocks to re-merge (multihost)
        inflight = 0
        flusher: list = []  # [thread] — at most one outstanding async flush
        flush_exc: list = []

        def do_flush(batch):
            """Drain one claimed batch: fetch device scores, scatter into the
            store, commit the journal.  Runs on the background flusher thread
            (single-host) so the D2H fetch and the numpy scatter overlap the
            next superblocks' dispatches — the analogue of the reference's
            double-buffered compute/copy stream overlap
            (src/interface/seqalign_cuda.c:151-290, two score buffers)."""
            # Fetch per dtype group: short-pair dispatches return int16 to
            # halve transfer; concatenating with int32 would upcast on device
            # and forfeit the saving.
            # Atomically claim progress credit for still-uncounted entries:
            # without the claim, the poller thread could mark-and-count an
            # entry between this loop reading the flag and adding, double
            # counting it.
            with self._plock:
                claimed = {id(e): not e[2] for e in batch}
                for e in batch:
                    e[2] = True
            if store is None and merger is None and journal is None:
                # Stats-only run (align_all(ss, None) — benchmarking, or a
                # caller that doesn't keep scores): the scores still reach
                # host memory (the fetch below is the align phase's real
                # D2H), but nobody will consume per-pair (i, j) metadata,
                # so skip materializing it.
                tc = time.perf_counter()
                for entry in batch:
                    dev, blks, _ = entry
                    np.asarray(dev)
                    for _, blk in blks:
                        stats.pairs += blk.n_valid
                        stats.cells += blk.cells
                        if bar and claimed[id(entry)]:
                            bar.add(blk.n_valid)
                mark("flush.fetch_wait", tc)
                return
            # Materialize the blocks' lazy pair metadata WHILE the device
            # finishes and the per-dispatch D2H copies (started at enqueue,
            # see _dispatch) fly — on the flusher thread this work overlaps
            # the next wave's dispatches too.
            tc = time.perf_counter()
            for _, blks, _ in batch:
                for _, blk in blks:
                    blk.pairs()
            mark("flush.materialize", tc)
            # Fetch per dispatch group, in enqueue order: group k's wait
            # overlaps groups k+1..n's still-flying copies, so the total
            # wait is bounded by the LAST group's completion, not the sum.
            tc = time.perf_counter()
            ii, jj, sc, committed = [], [], [], []
            for entry in batch:
                dev, blks, _ = entry
                buf = np.asarray(dev)
                off = 0
                for gidx, blk in blks:
                    n = blk.width
                    scores = buf[off : off + n]
                    off += n
                    oi, oj, cells = blk.pairs()
                    ii.append(oi)
                    jj.append(oj)
                    sc.append(blk.select_valid(scores).astype(np.int32))
                    committed.append(gidx)
                    stats.pairs += blk.n_valid
                    stats.cells += cells
                    if bar and claimed[id(entry)]:
                        bar.add(blk.n_valid)
            mark("flush.fetch_wait", tc)
            cat = lambda xs, dt: (
                np.concatenate(xs) if xs else np.zeros(0, dt)
            )
            if resumed_triplets:
                # Multi-host resume: re-contribute journaled blocks' scores
                # (read back from this host's persistent store) so peers that
                # crashed before their own fill converge too.  (merger path
                # only, which always flushes synchronously — no race with
                # take() appending.)
                ii.extend(t[0] for t in resumed_triplets)
                jj.extend(t[1] for t in resumed_triplets)
                sc.extend(t[2] for t in resumed_triplets)
                resumed_triplets.clear()
            oi, oj, os_ = cat(ii, np.int64), cat(jj, np.int64), cat(sc, np.int32)
            if merger is not None:
                oi, oj, os_ = merger(oi, oj, os_)
            if store is not None and len(os_):
                store.fill_pairs(oi, oj, os_)
            if journal is not None:
                # Commit through the interval batcher: scores are made
                # durable (store.sync) no later than the journal entry, but
                # only every SYNC_INTERVAL seconds — per-flush msync rewrites
                # ~the whole store for random-scatter flushes (see
                # SYNC_INTERVAL).  do_flush executions are serialized (one
                # flusher at a time, joined before the next starts), so the
                # backlog needs no lock.
                commit_backlog.extend(committed)
                if (
                    SYNC_INTERVAL <= 0
                    or time.perf_counter() - last_sync[0] >= SYNC_INTERVAL
                ):
                    if store is not None:
                        store.sync()
                    journal.commit(commit_backlog)
                    commit_backlog.clear()
                    last_sync[0] = time.perf_counter()

        def join_flusher():
            if flusher:
                flusher.pop().join()
            if flush_exc:
                raise flush_exc.pop()

        def run_flush(batch):
            try:
                do_flush(batch)
            except BaseException as e:  # re-raised on the main thread at join
                flush_exc.append(e)

        def flush(sync: bool = False):
            nonlocal inflight
            # One outstanding async flush max (double buffering): joining the
            # previous one first also keeps journal commits ordered and bounds
            # fetched-but-unscattered host memory.
            join_flusher()
            with self._plock:
                batch = list(pending)
                pending.clear()
            inflight = 0
            if merger is not None:
                # Multi-host: the merger participates in collectives, so it
                # must run on the main thread, at every flush point (even
                # with an empty batch — peers may contribute), in the same
                # deterministic order on every host.  Resumed journaled
                # blocks are re-contributed here too.
                do_flush(batch)
                return
            if not batch:
                return
            if sync:
                do_flush(batch)
            else:
                t = threading.Thread(target=run_flush, args=(batch,), daemon=True)
                flusher.append(t)
                t.start()

        def poll_progress(stop):
            # Live progress between flushes: jax.Array.is_ready() is a
            # non-blocking completion probe, the host-side analogue of the
            # reference's 4 Hz device progress-counter poll
            # (seqalign_cuda.c:286-289, progress.h:163-281).  Only the
            # OLDEST unclaimed entry is probed per tick (completion is
            # in-order per device stream, so probing more adds nothing).
            while not stop.wait(0.25):
                with self._plock:
                    e = next((x for x in pending if not x[2]), None)
                if e is None or not e[0].is_ready():
                    continue
                # Re-claim under the lock: the flusher may have claimed this
                # entry since the snapshot was taken.
                with self._plock:
                    if e[2]:
                        continue
                    e[2] = True
                bar.add(sum(blk.n_valid for _, blk in e[1]))

        poll_stop = threading.Event()
        poller = None
        if bar:
            poller = threading.Thread(
                target=poll_progress, args=(poll_stop,), daemon=True
            )
            poller.start()

        scheduled = 0  # pairs claimed so far (for limit_pairs)
        gidx = 0  # deterministic global superblock index
        # Deterministic least-loaded striping by ANALYTIC cell count: every
        # host walks the same block stream and assigns each block to the
        # host with the least cells so far (ties -> lowest id), so ownership
        # is a pure function of the stream and identical everywhere.  Plain
        # idx % nhosts can alias with a power-of-two block grid; cost-greedy
        # assignment balances cells regardless of grid/NHOSTS alignment.
        loads = np.zeros(max(nhosts, 1), dtype=np.int64)

        def take(blk):
            """Claim or skip one block: assigns the deterministic global
            index, strips other hosts' blocks, skips journaled blocks
            (re-contributing their stored scores in multi-host runs).
            Returns the index to dispatch, or None."""
            nonlocal gidx
            idx = gidx
            gidx += 1
            owner = int(np.argmin(loads))
            loads[owner] += blk.cells
            if owner != host_id:
                if bar:
                    bar.add(blk.n_valid)  # another host's work
                return None
            if journal is not None and idx in journal.done:
                stats.pairs_resumed += blk.n_valid
                if merger is not None and store is not None:
                    v = blk.valid
                    resumed_triplets.append((
                        blk.orig_i[v], blk.orig_j[v],
                        store.read_pairs(blk.orig_i[v], blk.orig_j[v]),
                    ))
                if bar:
                    bar.add(blk.n_valid)
                return None
            return idx

        for a, b in sched.combos():
            if limit_pairs is not None and scheduled >= limit_pairs:
                break
            npairs = sched.combo_pair_count(a, b)
            if npairs == 0:
                continue
            Lk = sched.buckets[a].edge
            Lc = sched.buckets[b].edge
            width = self._superblock_width(Lc, Lk, npairs)
            # Closed-form triangle inversion is exact to ~16M bucket rows;
            # Schedule.build splits larger buckets (scheduler.BUCKET_ROWS_MAX)
            # so this only guards hand-built schedules.  A real exception,
            # not an assert: under ``python -O`` an assert would vanish and
            # the inversion would silently corrupt pair ids.
            if sched.buckets[a].count > (1 << 24):
                raise RuntimeError(
                    f"bucket of {sched.buckets[a].count} rows exceeds the "
                    "f32 pair-id inversion range; build the schedule with "
                    "Schedule.build (which splits oversized buckets)"
                )
            small = _int32_ids_ok(npairs, a == b, sched.buckets[a].count)
            mode = "tri" if a == b else "rect"
            ctx = (
                buckets_dev[b], buckets_dev[a], lens_dev[b], lens_dev[a],
                npairs, sub_dev, gaps_dev, Lc, Lk, width, mode, small,
            )
            # Superblocks are stacked into chunks of <= FLUSH_PAIRS pairs and
            # scored with ONE dispatch per chunk (lax.map over the stack).
            chunk_blocks = max(1, FLUSH_PAIRS // width)
            chunk_blocks = 1 << (chunk_blocks.bit_length() - 1)
            blks: list = []

            def dispatch_group():
                nonlocal blks
                if blks:
                    self._dispatch(blks, ctx, pending)
                    blks = []

            for blk in sched.blocks(a, b, width=width):
                idx = take(blk)
                inflight += blk.width
                scheduled += blk.n_valid
                if idx is not None:
                    blks.append((idx, blk))
                if limit_pairs is not None and scheduled >= limit_pairs:
                    break
                if len(blks) >= chunk_blocks:
                    dispatch_group()
                if inflight >= FLUSH_PAIRS:
                    dispatch_group()
                    flush()
                elif merger is None and pending and (
                    not flusher or not flusher[0].is_alive()
                ):
                    # Eager overlap: the flusher is idle and dispatches are
                    # in flight — start fetching now so only the LAST
                    # dispatch's D2H wait lands after the loop (the
                    # reference hides it with its second CUDA stream,
                    # src/interface/seqalign_cuda.c:267-273).
                    flush()
            dispatch_group()
        mark("schedule+dispatch", t0)
        if poller is not None:
            poll_stop.set()
            poller.join(timeout=2.0)
        tf = time.perf_counter()
        flush(sync=True)
        join_flusher()  # nothing outstanding after a sync flush; belt-and-braces
        if journal is not None and commit_backlog:
            # Drain the interval batcher: the run's last blocks must be
            # durable + journaled before align_all returns.
            if store is not None:
                store.sync()
            journal.commit(commit_backlog)
            commit_backlog.clear()
        mark("final_flush", tf)
        if bar:
            bar.end()
        stats.seconds = time.perf_counter() - t0
        if phase_dbg:
            parts = "  ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in phases.items()
            )
            print(f"[phases] wall={stats.seconds * 1e3:.1f}ms  {parts}")
        return stats
