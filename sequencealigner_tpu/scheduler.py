"""Pair-space scheduler: linear pair index, length buckets, lazy block stream.

The reference enumerates the N(N-1)/2 pair space linearly and maps ids to
(i, j) with a triangular-number bisection (d_find_j,
/root/reference/src/bio/kernels.cu:17-30; packed index alignments(j)+i,
util/macros.h:13).  We keep that bijection for storage, but *schedule* pairs
by length bucket so each compiled kernel shape runs densely padded blocks:

- sequences are sorted by length; each bucket is a contiguous range of the
  sorted order, padded to a quantized edge length
- a bucket-combo (a <= b) owns the rectangle (triangle when a == b) of sorted
  pair space {i in bucket a, j in bucket b}; blocks of B pairs are generated
  lazily by arithmetic, so nothing O(N^2) is ever materialized
- within a pair, the LONGER sequence is the DP column dimension (Lc) and the
  shorter the row/state dimension (Lk <= Lc), shrinking the wavefront state
  (scores are symmetric, verified in tests)
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def pair_count(n: int) -> int:
    return n * (n - 1) // 2


def pair_to_linear(i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """(i < j) -> linear id = alignments(j) + i."""
    j = j.astype(np.int64)
    return j * (j - 1) // 2 + i


def linear_to_pair(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse bijection (the vectorized d_find_j)."""
    ids = np.asarray(ids, dtype=np.int64)
    # j = floor((1 + sqrt(1 + 8 id)) / 2), with integer correction for fp error.
    j = ((1.0 + np.sqrt(1.0 + 8.0 * ids.astype(np.float64))) / 2.0).astype(np.int64)
    j = np.where(j * (j - 1) // 2 > ids, j - 1, j)
    j = np.where((j + 1) * j // 2 <= ids, j + 1, j)
    i = ids - j * (j - 1) // 2
    return i, j


# Length edges.  The short end stays COARSE: every extra edge multiplies bucket combos and
# hence dispatches and compiled shapes, and short-sequence runs are
# dispatch/host-bound.  The long end
# gets intermediate edges (160, 320, 640): there device time dominates and
# ~1.3x spacing cuts real padded work.
DEFAULT_EDGES = (
    16, 24, 32, 64, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768,
    1024, 1536, 2048, 3072, 4096, 6144, 8192,
)

#: Target DP cells per device per block; B is derived from this.
TARGET_CELLS = 1 << 24
B_MIN, B_MAX = 8, 4096

#: Max rows per bucket: the engine's on-device triangle inversion
#: (engine._gather_pairs) uses an f32 sqrt whose two-step integer correction
#: is exact only while bucket rows fit f32 exactly (~2^24).  Oversized
#: buckets are SPLIT into same-edge chunks at schedule build — chunk pairs
#: become ordinary rectangle combos, every path stays exact (the reference
#: instead bisects in full s64 per pair, src/bio/kernels.cu:17-30).
BUCKET_ROWS_MAX = 1 << 24


def block_width(Lc: int, Lk: int, target_cells: int = TARGET_CELLS) -> int:
    b = target_cells // (Lc * Lk)
    b = 1 << max(int(b).bit_length() - 1, 0)  # round down to a power of two
    return max(B_MIN, min(B_MAX, b))


def bucket_edges(max_len: int, edges=DEFAULT_EDGES) -> list[int]:
    out = [e for e in edges if e < max_len]
    grow = list(edges)
    while grow[-1] < max_len:  # extend ~1.5x, kept a multiple of 32
        nxt = grow[-1] + grow[-1] // 2
        grow.append((nxt + 31) // 32 * 32)
    out.append(next(x for x in grow if x >= max_len))
    return sorted(set(out))


@dataclasses.dataclass
class Bucket:
    edge: int  # padded length
    start: int  # range [start, end) in the sorted order
    end: int

    @property
    def count(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class Block:
    """One kernel invocation's worth of pairs (padded to width B).

    LAZY: only arithmetic identity (combo, start, width, n_valid) is carried;
    the per-pair arrays (original indices, lengths, validity) are materialized
    on first access — the engine ships just ``start`` to the device and needs
    the arrays only at flush time, on the background flusher thread, so the
    dispatch path never pays per-pair numpy work (~70 ms of a ~160 ms 1k-seq
    run before this)."""

    Lc: int
    Lk: int
    start: int  # first combo-local linear pair id of this block
    bucket_c: int  # bucket index of the column (longer) sequences
    bucket_k: int
    width: int  # padded pair count B
    n_valid: int  # real pairs (the rest are padding)
    sched: "Schedule" = dataclasses.field(repr=False)
    _arr: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _pairs: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def arrays(self) -> tuple:
        """(orig_i, orig_j, l1, l2, valid), materialized once."""
        if self._arr is None:
            sch = self.sched
            ba = sch.buckets[self.bucket_k]
            bb = sch.buckets[self.bucket_c]
            valid = np.arange(self.width) < self.n_valid
            lin = np.arange(self.start, self.start + self.width,
                            dtype=np.int64)
            lin = np.where(valid, lin, 0)  # pad -> dummy pair (0, 0)
            if self.bucket_k == self.bucket_c:
                rk, rc = linear_to_pair(lin)  # local triangle coords
            else:
                rk = lin % ba.count
                rc = lin // ba.count
            sk = ba.start + rk  # sorted-order indices
            sc = bb.start + rc
            ok = sch.order[sk]
            oc = sch.order[sc]
            oi = np.minimum(ok, oc).astype(np.int64)
            oj = np.maximum(ok, oc).astype(np.int64)
            l1 = sch.lengths_sorted[sc].astype(np.int32)
            l2 = sch.lengths_sorted[sk].astype(np.int32)
            self._arr = (oi, oj, l1, l2, valid)
        return self._arr

    @property
    def orig_i(self) -> np.ndarray:
        return self.arrays()[0]

    @property
    def orig_j(self) -> np.ndarray:
        return self.arrays()[1]

    @property
    def l1(self) -> np.ndarray:
        return self.arrays()[2]

    @property
    def l2(self) -> np.ndarray:
        return self.arrays()[3]

    @property
    def valid(self) -> np.ndarray:
        return self.arrays()[4]

    @property
    def cells(self) -> int:
        _, _, l1, l2, valid = self.arrays()
        return int((l1.astype(np.int64) * l2)[valid].sum())

    def select_valid(self, scores: np.ndarray) -> np.ndarray:
        """The valid-pair slice of this block's score slots (valid pairs
        come first)."""
        return scores[: self.n_valid]

    def pairs(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(orig_i, orig_j, cells) over the VALID pairs only — the flush-side
        form, via the fused C pass (io/native.py materialize_block) when
        available."""
        if self._pairs is None:
            r = None
            if self._arr is None:
                from .io import native

                sch = self.sched
                ba = sch.buckets[self.bucket_k]
                bb = sch.buckets[self.bucket_c]
                r = native.materialize_block(
                    sch.order, sch.lengths_sorted, ba.start, ba.count,
                    bb.start, self.bucket_k == self.bucket_c,
                    self.start, self.n_valid,
                )
            if r is None:
                oi, oj, _, _, valid = self.arrays()
                r = (oi[valid], oj[valid], self.cells)
            self._pairs = r
        return self._pairs


@dataclasses.dataclass
class Schedule:
    order: np.ndarray  # sorted-by-length permutation: order[s] = original index
    buckets: list[Bucket]
    lengths_sorted: np.ndarray

    @classmethod
    def build(cls, lengths: np.ndarray, edges=DEFAULT_EDGES) -> "Schedule":
        lengths = np.asarray(lengths, dtype=np.int32)
        order = np.argsort(lengths, kind="stable")
        ls = lengths[order]
        edge_list = bucket_edges(int(ls[-1]), edges)
        buckets = []
        start = 0
        for e in edge_list:
            end = int(np.searchsorted(ls, e, side="right"))
            if end > start:
                buckets.append(Bucket(edge=e, start=start, end=end))
                start = end
        # Merge tiny buckets upward: every bucket multiplies the combo count
        # (hence dispatches and compiled shapes), and a handful of sequences
        # in their own bucket cost more in per-combo overhead than their
        # extra padding in the next bucket does.  Beyond the hard floor, a
        # bucket under 256 rows merges whenever the next edge is at most 2x
        # its own: the GPU kernel sweeps each pair only to its true lengths,
        # so the merge penalty is bounded by the edge ratio, while the saved
        # combo row costs real dispatches on every run.
        min_count = max(64, len(order) // 64)
        merged: list[Bucket] = []
        for b in buckets:
            if merged and (
                merged[-1].count < min_count
                or (merged[-1].count < 256 and b.edge <= 2 * merged[-1].edge)
            ):
                prev = merged.pop()
                b = Bucket(edge=b.edge, start=prev.start, end=b.end)
            merged.append(b)
        if len(merged) > 1 and merged[-1].count < min_count:
            last = merged.pop()
            prev = merged.pop()
            merged.append(Bucket(edge=last.edge, start=prev.start, end=last.end))
        split: list[Bucket] = []
        for b in merged:
            while b.count > BUCKET_ROWS_MAX:
                split.append(
                    Bucket(edge=b.edge, start=b.start, end=b.start + BUCKET_ROWS_MAX)
                )
                b = Bucket(edge=b.edge, start=b.start + BUCKET_ROWS_MAX, end=b.end)
            split.append(b)
        return cls(order=order, buckets=split, lengths_sorted=ls)

    def combos(self) -> list[tuple[int, int]]:
        """(k_bucket, c_bucket) combos with k <= c, in ascending-cost order."""
        nb = len(self.buckets)
        return [(a, b) for b in range(nb) for a in range(b + 1)]

    def combo_pair_count(self, a: int, b: int) -> int:
        if a == b:
            return pair_count(self.buckets[a].count)
        return self.buckets[a].count * self.buckets[b].count

    def total_pairs(self) -> int:
        n = len(self.order)
        return pair_count(n)

    def total_cells(self) -> int:
        ls = self.lengths_sorted.astype(np.int64)
        s1, s2 = ls.sum(), (ls * ls).sum()
        return int((s1 * s1 - s2) // 2)

    def blocks(
        self, a: int, b: int, width: int | None = None,
        target_cells: int = TARGET_CELLS,
    ) -> Iterator[Block]:
        """Lazy blocks for combo (a <= b), all of one width (one compiled
        shape per combo; the last block is padded).  Pairs are (i_sorted
        from bucket a, j_sorted from bucket b); within-bucket (a == b) uses
        the triangle."""
        ba, bb = self.buckets[a], self.buckets[b]
        Lk, Lc = ba.edge, bb.edge
        w = width or block_width(Lc, Lk, target_cells)
        npairs = self.combo_pair_count(a, b)
        for s0 in range(0, npairs, w):
            yield Block(
                Lc=Lc,
                Lk=Lk,
                start=s0,
                bucket_c=b,
                bucket_k=a,
                width=w,
                n_valid=min(w, npairs - s0),
                sched=self,
            )
