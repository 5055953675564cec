"""Batched anti-diagonal wavefront DP in pure XLA (jax.numpy + lax.scan).

The plain reference scorer: the CPU engine's scorer and the GPU kernel's
reference (ops/gpu_dp.py is compared against it for equality).  Instead of
the reference's one-scalar-DP-per-thread scheme (CPU:
/root/reference/src/bio/align.c:44-60, CUDA thread-per-pair:
src/bio/kernels.cu:32-221), a whole *block* of B sequence pairs is aligned at
once.  The DP table of every pair is swept along anti-diagonals d = r + c; all
cells on a diagonal are independent, so each scan step updates a dense
(B, K) array with no horizontal-dependency stalls.

Key ideas:

- **Uniform recurrence.**  With state vectors indexed by k = r (row in seq2)
  and sentinel values SCORE_MIN shifted in at k = -1 / out-of-range slots, the
  *border* initialisations of all three algorithms (nw.c:13-18, ga.c:26-41,
  sw.c:21-31) emerge automatically from the same interior recurrence, so the
  scan body has no special cases.

- **Integer substitution lookup.**  The substitution-score grid of each pair
  is gathered from the padded table with integer indices (exact by
  construction, no floating point), then pre-skewed so that scan step d
  reads its diagonal as a contiguous (B, K) slice.

- **Masked length handling.**  Pairs inside a block may have different true
  lengths (l1, l2) below the padded (Lc, Lk).  Pad positions use index PAD
  whose substitution score is BIG_NEG, which provably never influences valid
  cells (pad cells only ever feed pad cells — the DP moves right/down).  The
  final score is captured per pair: NW/GA read cell (l2, l1) when its diagonal
  d = l1 + l2 is produced; SW takes a running max, which pad cells cannot
  exceed.

Scores are bit-exact vs the reference recurrences (verified against
ops.oracle and hence parasail semantics, README.md:217-226).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..matrices import SCORE_MIN

#: Padding index appended to the 24-letter alphabet.
PAD = 24
#: Substitution score for any pad-involving cell.  Large enough to dominate,
#: small enough that SCORE_MIN + BIG_NEG stays far from int32 wraparound.
BIG_NEG = -(2**28)


def padded_submatrix(sub: np.ndarray) -> np.ndarray:
    """(24,24) -> (25,25) with pad row/col = BIG_NEG."""
    out = np.full((PAD + 1, PAD + 1), BIG_NEG, dtype=np.int32)
    out[:24, :24] = np.asarray(sub, dtype=np.int32)
    return out


def _skewed_score_grid(s1, s2, sub_p, Lc, Lk):
    """Build SK of shape (D, B, K):  SK[d-1, b, k] = sub[s2[b,k-1], s1[b,d-k-1]]
    for the valid cells of diagonal d (1-based), 0 elsewhere.

    D = Lc + Lk scan steps, K = Lk + 1 state lanes.
    """
    B = s1.shape[0]
    K = Lk + 1
    D = Lc + Lk

    # Substitution grid by an integer table gather: exact by construction.
    sub0 = sub_p[s2[:, :, None], s1[:, None, :]]  # (B, Lk, Lc)

    # G[b, k, c0] = sub0[b, k-1, c0] for k>=1; extra zero column at c0 = Lc
    # gives invalid diagonal slots a harmless 0.
    g = jnp.zeros((B, K, Lc + 1), dtype=jnp.int32)
    g = g.at[:, 1:, :Lc].set(sub0)

    ds = jnp.arange(1, D + 1)[None, :]  # (1, D)
    ks = jnp.arange(K)[:, None]  # (K, 1)
    c0 = ds - ks - 1  # column index of (k, d) cell
    idx = jnp.where((c0 >= 0) & (c0 < Lc) & (ks >= 1), c0, Lc)  # (K, D)
    sk = jnp.take_along_axis(g, idx[None], axis=2)  # (B, K, D)
    return jnp.transpose(sk, (2, 0, 1))  # (D, B, K)


def _shift_k(x, fill):
    """Shift +1 along the k axis (axis 1 of a (B, K) array), filling with
    ``fill``:  out[:, k] = x[:, k-1], out[:, 0] = fill."""
    return jnp.concatenate([jnp.full_like(x[:, :1], fill), x[:, :-1]], axis=1)


@functools.partial(jax.jit, static_argnames=("algo", "Lc", "Lk"))
def align_block(s1, s2, l1, l2, sub_p, gaps, *, algo: str, Lc: int, Lk: int):
    """Score a block of pairs.

    Args:
      s1: (B, Lc) int32 indices of the column sequences (0..23, PAD beyond l1).
      s2: (B, Lk) int32 indices of the row sequences.
      l1, l2: (B,) int32 true lengths, 1 <= l2 <= Lk, 1 <= l1 <= Lc.
      sub_p: (25, 25) int32 padded substitution matrix.
      gaps: (3,) int32 [gap_pen, gap_open, gap_extend], all <= 0 (negated
        penalties, reference convention src/bio/align.c:127-128).
      algo: "nw" | "ga" | "sw".

    Returns: (B,) int32 alignment scores.
    """
    B = s1.shape[0]
    K = Lk + 1
    sm = jnp.int32(SCORE_MIN)
    gap, opn, ext = gaps[0], gaps[1], gaps[2]

    sk = _skewed_score_grid(s1, s2, sub_p, Lc, Lk)  # (D, B, K)

    # Initial state: diagonal 0 holds only cell (0,0) = 0; everything else is
    # the sentinel, which reproduces all border recurrences.
    h0 = jnp.full((B, K), sm, jnp.int32).at[:, 0].set(0)
    hm1 = jnp.full((B, K), sm, jnp.int32)
    xy0 = jnp.full((B, K), sm, jnp.int32)

    khot = jnp.arange(K)[None, :] == l2[:, None]  # capture row (B, K)
    dstar = l1 + l2  # capture diagonal per pair
    init, step = _dp_steps(algo, gap, opn, ext, sm, khot, dstar, h0, hm1, xy0, B)
    carry, _ = jax.lax.scan(step, init, sk)
    return carry[-2] if algo != "sw" else carry[-1]


def _dp_steps(algo, gap, opn, ext, sm, khot, dstar, h0, hm1, xy0, B):
    """(init_carry, step) shared by the materialized and streamed scans.
    The capture accumulator is the last carry slot for sw, second-to-last
    (before the diagonal counter) for nw/ga."""
    if algo == "nw":

        def step(carry, sd):
            hd1, hd2, acc, d = carry
            h = jnp.maximum(
                jnp.maximum(_shift_k(hd2, sm) + sd, hd1 + gap),
                _shift_k(hd1, sm) + gap,
            )
            h = jnp.maximum(h, sm)
            contrib = jnp.sum(jnp.where(khot, h, 0), axis=1, dtype=jnp.int32)
            acc = jnp.where(d == dstar, contrib, acc)
            return (h, hd1, acc, d + 1), None

        return (h0, hm1, jnp.zeros((B,), jnp.int32), jnp.int32(1)), step

    if algo == "ga":

        def step(carry, sd):
            hd1, hd2, x1, y1, acc, d = carry
            x = jnp.maximum(jnp.maximum(hd1 + opn, x1 + ext), sm)
            y = jnp.maximum(
                jnp.maximum(_shift_k(hd1, sm) + opn, _shift_k(y1, sm) + ext), sm
            )
            h = jnp.maximum(jnp.maximum(_shift_k(hd2, sm) + sd, x), y)
            h = jnp.maximum(h, sm)
            contrib = jnp.sum(jnp.where(khot, h, 0), axis=1, dtype=jnp.int32)
            acc = jnp.where(d == dstar, contrib, acc)
            return (h, hd1, x, y, acc, d + 1), None

        init = (h0, hm1, xy0, xy0, jnp.zeros((B,), jnp.int32), jnp.int32(1))
        return init, step

    if algo == "sw":

        def step(carry, sd):
            hd1, hd2, x1, y1, best = carry
            x = jnp.maximum(jnp.maximum(hd1 + opn, x1 + ext), sm)
            y = jnp.maximum(
                jnp.maximum(_shift_k(hd1, sm) + opn, _shift_k(y1, sm) + ext), sm
            )
            h = jnp.maximum(jnp.maximum(_shift_k(hd2, sm) + sd, x), y)
            h = jnp.maximum(h, 0)
            best = jnp.maximum(best, jnp.max(h, axis=1))
            return (h, hd1, x, y, best), None

        return (h0, hm1, xy0, xy0, jnp.zeros((B,), jnp.int32)), step

    raise ValueError(f"unknown algorithm {algo!r}")


@functools.partial(jax.jit, static_argnames=("algo", "Lc", "Lk", "CD"))
def align_block_streamed(
    s1, s2, l1, l2, sub_p, gaps, *, algo: str, Lc: int, Lk: int, CD: int = 128
):
    """align_block for LONG sequences: the skewed score grid is never
    materialized (O(Lc*Lk) memory per pair); instead each scan step over
    diagonal chunks gathers its (CD, B, K) slab from an s1 window and the
    pair's row profiles.  This removes any practical sequence-length cap —
    the reference's GPU path gives up at 1023 chars
    (/root/reference/src/bio/kernels.cuh:10); here memory is O(B*(Lc+Lk)).
    """
    B = s1.shape[0]
    K = Lk + 1
    sm = jnp.int32(SCORE_MIN)
    gap, opn, ext = gaps[0], gaps[1], gaps[2]

    # Row profiles, reversed so row rk = K-1-k skews by exactly rk (flat
    # trick): prof_rev[b, rk, a] = sub_p[s2[b, K-2-rk], a]; rk = K-1 (k=0)
    # is the PAD profile (all BIG_NEG).
    s2e = jnp.pad(s2, ((0, 0), (1, 0)), constant_values=PAD)  # adds k=0 slot
    prof_rev = sub_p[s2e[:, ::-1]]  # (B, K, 25)

    # s1 padded so every window index is in range: window for chunk c0 covers
    # original columns [c0 - Lk, c0 + CD - 1).
    nchunks = -(-(Lc + Lk) // CD)
    s1e = jnp.pad(
        s1, ((0, 0), (Lk, nchunks * CD - Lc)), constant_values=PAD
    )  # (B, Lk + nchunks*CD)

    W = CD + Lk  # window width
    khot = jnp.arange(K)[None, :] == l2[:, None]
    dstar = l1 + l2
    h0 = jnp.full((B, K), sm, jnp.int32).at[:, 0].set(0)
    hm1 = jnp.full((B, K), sm, jnp.int32)
    xy0 = jnp.full((B, K), sm, jnp.int32)
    init, step = _dp_steps(algo, gap, opn, ext, sm, khot, dstar, h0, hm1, xy0, B)

    def chunk(carry, c0):
        win = jax.lax.dynamic_slice_in_dim(s1e, c0, W, axis=1)  # (B, W)
        slab = jnp.take_along_axis(
            prof_rev, jnp.broadcast_to(win[:, None, :], (B, K, W)), axis=2
        )  # (B, K, W): row rk, window col w
        # Diagonal extraction: sk[j, b, k] = slab[b, rk, j + rk] (rk = K-1-k)
        # via pad + flat-reshape (left-shift row rk by rk), then reverse k.
        a = jnp.pad(slab.reshape(B, K * W), ((0, 0), (0, K)))
        a = a.reshape(B, K, W + 1)[:, :, :CD]  # (B, K, CD), rows rk
        sk = jnp.transpose(a[:, ::-1, :], (2, 0, 1))  # (CD, B, K), rows k
        return jax.lax.scan(step, carry, sk)[0], None

    c0s = jnp.arange(nchunks, dtype=jnp.int32) * CD
    carry, _ = jax.lax.scan(chunk, init, c0s)
    return carry[-2] if algo != "sw" else carry[-1]
