"""Similarity prefilter: greedy positional-identity dedup before alignment.

Semantics of the reference filter (/root/reference/src/bio/filter.c:14-89)
made *deterministic*: sequence j is dropped iff some KEPT i < j has
matches/min(len_i, len_j) >= threshold, where matches counts positionally
equal characters over the first min(len) positions (filter.c:48-54), resolved
strictly in file order (the reference's OpenMP version races on lost[] and is
only nondeterministically close to this; SURVEY.md §5 fixes keep-first-in-file-
order as the spec).  The division is performed in float32 like the C code.

Design:
- **Match counting as a matrix product.**  Positional identity over
  characters is a dot product of one-hot encodings: counts = OH_i · OH_j^T
  with OH = (rows, L x 24) (pad positions get the all-zero vector, so pad
  never matches).  One (block, L*24) x (L*24, seg) bf16 product with an f32
  accumulator replaces an elementwise eq+reduce; it is exact, because the
  inputs are 0/1 and counts <= L <= 2^14.
- **Device-reduced prior verdicts, segment batching.**  Candidates are
  processed in SEGMENTS of several blocks per dispatch; the comparison
  against every PRIOR row is reduced on-device against the current kept
  mask, so per segment only one bool per candidate plus the (seg x seg)
  local tile crosses the host link.  Host work is the O(seg^2) greedy
  resolution only (native C with a NumPy fallback).
- **Length-bucketed device residency.**  Prior rows live on device as
  per-bucket (count, edge) code matrices (the engine's Schedule buckets),
  NOT one (n, lmax) matrix: resident bytes are ~1.3x the input size (so the
  2 GiB input cap bounds HBM at ~2.7 GB even for 20M short reads + one long
  outlier, where global-lmax padding would need tens of GB).  Cross-length
  comparisons contract over the BUCKET edge only — positions past the
  shorter sequence one-hot to zero, so truncating the contraction at
  min(edge, lmax) is exact.  This is the device analogue of the reference
  filter's O(1) extra memory (filter.c:32-61).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import ui
from .io.input import SequenceSet

#: Blocks per dispatch segment: larger segments amortize host round trips.
SEG_BLOCKS = 8

#: One-hot bytes budget for a candidate segment (bounds the (S, lmax*24)
#: bf16 intermediate; segments shrink for very long sequence sets).
SEG_OH_BYTES = 1 << 30


@functools.partial(jax.jit, static_argnames=("block",))
def _filter_segment(cols, collens, kept, thr, j0, *bargs, block):
    """One candidate segment (cols: (S, lmax) int8 codes, -1 at pad) against
    every prior row and itself.

    bargs: per-bucket triples flattened — codes (cnt_pad, edge) int8, lens
    (cnt_pad,) int32 (0 on pad rows), orig (cnt_pad,) int32 (original file
    index; n on pad rows).  kept: (n + 1,) uint8 with kept[n] = 0, final
    below j0.  Returns killed_prior (S,) bool and sim_local (S, S) uint8.
    """
    f32 = jnp.float32
    S, lmax = cols.shape

    def onehot_flat(rows):
        # bf16 0/1 inputs: counts <= L <= 2^14 are exact in the f32
        # accumulator.  -1 codes (pad) one-hot to the zero vector.
        oh = jax.nn.one_hot(rows, 24, dtype=jnp.bfloat16)  # (r, L, 24)
        return oh.reshape(rows.shape[0], rows.shape[1] * 24)

    colflat = onehot_flat(cols)  # (S, lmax*24)

    def sim_of(counts, rowlens):
        minlen = jnp.minimum(rowlens[:, None], collens[None, :])
        return (minlen > 0) & (
            counts / jnp.maximum(minlen, 1).astype(f32) >= thr
        )

    killed = jnp.zeros(S, bool)
    for codes_b, lens_b, orig_b in zip(*[iter(bargs)] * 3):
        edge = codes_b.shape[1]
        w = min(edge, lmax) * 24
        colpart = colflat[:, :w]

        def body(k, i0, codes_b=codes_b, lens_b=lens_b, orig_b=orig_b,
                 colpart=colpart, w=w):
            rows = jax.lax.dynamic_slice_in_dim(codes_b, i0, block, 0)
            rowlens = jax.lax.dynamic_slice_in_dim(lens_b, i0, block, 0)
            orig = jax.lax.dynamic_slice_in_dim(orig_b, i0, block, 0)
            keptb = kept[orig] != 0
            counts = jax.lax.dot_general(
                onehot_flat(rows)[:, :w], colpart,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # (block, S)
            prior = (
                sim_of(counts, rowlens)
                & (keptb & (orig < j0))[:, None]
            )
            return k | jnp.any(prior, axis=0), None

        # Static full scan with the per-row (orig < j0) mask: a fixed-trip
        # scan rather than a loop with a dynamic bound.
        i0s = jnp.arange(codes_b.shape[0] // block, dtype=jnp.int32) * block
        killed, _ = jax.lax.scan(body, killed, i0s)

    counts_local = jax.lax.dot_general(
        colflat, colflat,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    sim_local = sim_of(counts_local, collens)
    return killed, sim_local.astype(jnp.uint8)


def _pack_codes(ss: SequenceSet, rows: np.ndarray, edge: int) -> np.ndarray:
    """(len(rows), edge) int8 compact codes (0..23; -1 at pad) for the given
    original indices — native fused pass, NumPy fallback."""
    from .io import native

    mat = native.pack_rows(ss.data, ss.offsets, rows, edge, ss.lut, -1)
    if mat is None:
        mat = np.full((len(rows), edge), -1, dtype=np.int8)
        for local, orig in enumerate(rows):
            s = ss.data[ss.offsets[orig] : ss.offsets[orig + 1]]
            mat[local, : len(s)] = ss.lut[s].astype(np.int8)
    return mat


def filter_sequences(
    ss: SequenceSet, threshold: float, *, block: int = 512, progress: bool = True
) -> tuple[SequenceSet, int]:
    """Returns (filtered set, number dropped)."""
    if threshold <= 0.0:
        return ss, 0

    from .scheduler import Schedule

    n = ss.num
    lmax = int(ss.max_len)
    seg_blocks = max(1, min(SEG_BLOCKS, SEG_OH_BYTES // (block * lmax * 48)))
    S = block * seg_blocks

    # Per-bucket device residency (see module notes).
    sched = Schedule.build(ss.lengths)
    bargs = []
    for b in sched.buckets:
        rows = sched.order[b.start : b.end]
        cnt = len(rows)
        cpad = -(-cnt // block) * block
        mat = np.full((cpad, b.edge), -1, dtype=np.int8)
        mat[:cnt] = _pack_codes(ss, rows, b.edge)
        lens = np.zeros(cpad, np.int32)
        lens[:cnt] = ss.lengths[rows]
        orig = np.full(cpad, n, np.int32)
        orig[:cnt] = rows
        bargs += [jax.device_put(mat), jax.device_put(lens),
                  jax.device_put(orig)]
    bargs = tuple(bargs)

    thr = np.float32(threshold)
    lost = np.zeros(n, dtype=np.uint8)
    kept = np.ones(n + 1, dtype=np.uint8)
    kept[n] = 0  # pad rows resolve against this slot
    bar = ui.Progress(n - 1, "Filtering sequences") if progress else None

    from .io import native

    for j0 in range(0, n, S):
        j1 = min(j0 + S, n)
        bsz = j1 - j0
        cols = np.full((S, lmax), -1, dtype=np.int8)
        cols[:bsz] = _pack_codes(ss, np.arange(j0, j1, dtype=np.int64), lmax)
        collens = np.zeros(S, np.int32)
        collens[:bsz] = ss.lengths[j0:j1]
        killed, sim_local = _filter_segment(
            jax.device_put(cols), jax.device_put(collens),
            jax.device_put(kept), thr, np.int32(j0), *bargs, block=block,
        )
        killed = np.asarray(killed)[:bsz]
        # Host greedy within the segment, with the device-reduced prior-block
        # verdict folded in as a SENTINEL row 0 (a permanently-kept pseudo
        # sequence "similar" to every prior-killed candidate), so cascading
        # works: a candidate killed by a prior block cannot itself kill.
        sim = np.asarray(sim_local)[:bsz, :bsz]
        aug = np.zeros((bsz + 1, bsz), np.uint8)
        aug[0] = killed.astype(np.uint8)
        aug[1:] = sim
        loc_lost = np.zeros(bsz + 1, np.uint8)
        if not native.filter_resolve(aug, loc_lost, 1, bsz + 1):
            lb = loc_lost.view(bool)
            augb = aug.view(bool)
            for j in range(1, bsz + 1):
                lb[j] = bool(np.any(augb[:j, j - 1] & ~lb[:j]))
        lost[j0:j1] = loc_lost[1:]
        kept[j0:j1] = 1 - lost[j0:j1]
        if bar:
            bar.add(bsz)
    if bar:
        bar.end()

    lost = lost.view(bool)[:n]
    dropped = int(lost.sum())
    if dropped == 0:
        ss.kept = np.arange(n, dtype=np.int64)
        return ss, 0
    keep = np.flatnonzero(~lost)
    seqs = [ss.data[ss.offsets[i] : ss.offsets[i + 1]] for i in keep]
    out = SequenceSet.from_list(seqs, ss.lut)
    out.kept = keep.astype(np.int64)  # original indices of the survivors
    return out, dropped
