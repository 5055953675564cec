"""The platform scorer seam (ops/scorer.py) vs the NumPy oracle.

On the CPU the seam runs the XLA scan; the same cases run through the GPU
kernel in tests/test_gpu_dp.py.  Shapes cover a single partially padded
block, several of the kernel's register chunks (16/24/32 rows) and the
boundaries between them, and the streamed long-pair path."""

import zlib

import numpy as np
import pytest

from sequencealigner_tpu import matrices
from sequencealigner_tpu.ops import oracle, scorer, xla_dp
from sequencealigner_tpu.ops.xla_dp import PAD, padded_submatrix

M = matrices.get("blosum62")
SUB_P = padded_submatrix(M.matrix)

GAP_CASES = [
    ("nw", (-4, 0, 0)),
    ("ga", (0, -10, -1)),
    ("sw", (0, -8, -2)),
    # extend WORSE than open: a border gap may re-open every step.
    ("ga", (0, -1, -5)),
    ("sw", (0, -2, -7)),
    ("ga", (0, -3, -3)),
]

#: (Lc, Lk): single block; rows at and around the 16/24/32-row chunk
#: instantiations; several 32-row chunks with a ragged last one.
SHAPES = [(21, 13), (16, 16), (30, 17), (40, 24), (40, 25), (33, 32),
          (70, 33), (80, 70), (100, 64), (100, 65)]


def random_block(rng, n, Lc, Lk, nsym=20):
    l1 = rng.integers(1, Lc + 1, n).astype(np.int32)
    l2 = rng.integers(1, Lk + 1, n).astype(np.int32)
    # Full-length pairs exercise the last row/column of the padded shape.
    l1[0], l2[0] = Lc, Lk
    s1 = np.full((n, Lc), PAD, np.int8)
    s2 = np.full((n, Lk), PAD, np.int8)
    for b in range(n):
        s1[b, : l1[b]] = rng.integers(0, nsym, l1[b])
        s2[b, : l2[b]] = rng.integers(0, nsym, l2[b])
    return s1, s2, l1, l2


def oracle_scores(algo, gaps, s1, s2, l1, l2, sub=M.matrix):
    kw = {"gap": gaps[0], "opn": gaps[1], "ext": gaps[2]}
    return np.array([
        oracle.align_score(algo, s1[b, : l1[b]], s2[b, : l2[b]], sub, **kw)
        for b in range(len(l1))
    ], np.int32)


def score(s1, s2, l1, l2, gaps, *, algo, Lc, Lk, sub_p=SUB_P, kind="xla"):
    return np.asarray(scorer.score_block(
        kind, s1, s2, l1, l2, sub_p, np.array(gaps, np.int32),
        algo=algo, Lc=Lc, Lk=Lk,
    ))


@pytest.mark.parametrize("Lc,Lk", SHAPES)
@pytest.mark.parametrize("algo,gaps", GAP_CASES)
def test_scorer_matches_oracle(algo, gaps, Lc, Lk):
    rng = np.random.default_rng(zlib.crc32(f"{algo}{gaps}{Lc}{Lk}".encode()))
    s1, s2, l1, l2 = random_block(rng, 12, Lc, Lk)
    got = score(s1, s2, l1, l2, gaps, algo=algo, Lc=Lc, Lk=Lk)
    np.testing.assert_array_equal(got, oracle_scores(algo, gaps, s1, s2, l1, l2))


def test_scorer_padding_slots_score_zero():
    """Engine padding slots carry length 0: they score 0 and leave the
    real pairs of the block untouched."""
    rng = np.random.default_rng(4)
    s1, s2, l1, l2 = random_block(rng, 8, 30, 20)
    want = oracle_scores("ga", (0, -10, -1), s1, s2, l1, l2)
    l1[5:] = 0
    l2[5:] = 0
    got = score(s1, s2, l1, l2, (0, -10, -1), algo="ga", Lc=30, Lk=20)
    np.testing.assert_array_equal(got[:5], want[:5])
    np.testing.assert_array_equal(got[5:], 0)


def test_scorer_randomized_shapes():
    """Randomized shape/matrix/gap fuzz (fixed seed) across edge-unaligned
    shapes, protein and nucleotide matrices."""
    mats = ["blosum62", "pam250", "nuc44"]
    rng = np.random.default_rng(99)
    for _ in range(4):
        mname = mats[rng.integers(0, len(mats))]
        mx = matrices.get(mname)
        algo = ["nw", "ga", "sw"][rng.integers(0, 3)]
        if algo == "nw":
            gaps = (-int(rng.integers(1, 13)), 0, 0)
        else:
            gaps = (0, -int(rng.integers(1, 15)), -int(rng.integers(1, 15)))
        Lc = int(rng.integers(2, 120))
        Lk = int(rng.integers(1, Lc + 1))
        nsym = 16 if mname == "nuc44" else 20
        s1, s2, l1, l2 = random_block(rng, 8, Lc, Lk, nsym)
        got = score(s1, s2, l1, l2, gaps, algo=algo, Lc=Lc, Lk=Lk,
                    sub_p=padded_submatrix(mx.matrix))
        want = oracle_scores(algo, gaps, s1, s2, l1, l2, mx.matrix)
        np.testing.assert_array_equal(got, want, err_msg=f"{algo} {mname} {gaps}")


def test_sw_zero_cell_no_gap_reopen():
    """SW local alignments that start right after a cell clamped to zero,
    with open >> extend: a gap must not 're-open' from the zero cell
    (reference src/bio/method/sw.c:38-58) — a strong mismatch prefix, then
    a gap that would only pay off if it could."""
    rng = np.random.default_rng(11)
    n, Lc, Lk = 32, 16, 16
    s1 = np.full((n, Lc), PAD, np.int8)
    s2 = np.full((n, Lk), PAD, np.int8)
    l1 = np.zeros(n, np.int32)
    l2 = np.zeros(n, np.int32)
    for b in range(n):
        pre = int(rng.integers(1, 5))
        run = int(rng.integers(2, 6))
        gap_len = int(rng.integers(1, 4))
        a = list(rng.integers(0, 20, pre)) + [17] * run
        c = list(rng.integers(0, 20, pre)) + [0] * gap_len + [17] * run
        l1[b] = min(len(a), Lc)
        l2[b] = min(len(c), Lk)
        s1[b, : l1[b]] = a[: l1[b]]
        s2[b, : l2[b]] = c[: l2[b]]
    got = score(s1, s2, l1, l2, (0, -12, -1), algo="sw", Lc=Lc, Lk=Lk)
    np.testing.assert_array_equal(
        got, oracle_scores("sw", (0, -12, -1), s1, s2, l1, l2)
    )


@pytest.mark.parametrize("platform,kind", [
    ("gpu", "kernel"), ("cpu", "xla"), ("rocm", "xla"), ("METAL", "xla"),
])
def test_scorer_choice_by_platform(platform, kind):
    """Only a GPU runs the kernel; every other platform gets the XLA scan
    (no option can force the kernel where it cannot run)."""
    assert scorer.kind_for(platform) == kind


@pytest.mark.parametrize("kind,Lc,Lk,want", [
    ("xla", 64, 64, "align_block"),
    ("xla", 1024, 1023, "align_block_streamed"),  # grid over 4 MiB/pair
    ("kernel", 64, 64, "gpu"),
    ("kernel", 6144, 6144, "gpu"),  # no length cap: no XLA fallback
])
def test_scorer_routes_by_static_shape(monkeypatch, kind, Lc, Lk, want):
    from sequencealigner_tpu.ops import gpu_dp

    calls = []
    for mod, name in ((xla_dp, "align_block"), (xla_dp, "align_block_streamed"),
                      (gpu_dp, "align_block")):
        tag = "gpu" if mod is gpu_dp else name
        monkeypatch.setattr(
            mod, name, lambda *a, _t=tag, **k: calls.append(_t) or a[2]
        )
    scorer.score_block(kind, None, None, np.ones(2), np.ones(2), None, None,
                       algo="ga", Lc=Lc, Lk=Lk)
    assert calls == [want]


def test_streamed_threshold_matches_materialized():
    """Just past STREAM_GRID_BYTES the scorer switches implementation; both
    sides of the switch agree on the same pairs."""
    rng = np.random.default_rng(8)
    Lc, Lk = 1100, 700  # (Lc + Lk) * (Lk + 1) * 4 > 4 MiB
    assert (Lc + Lk) * (Lk + 1) * 4 > scorer.STREAM_GRID_BYTES
    s1, s2, l1, l2 = random_block(rng, 2, Lc, Lk)
    g = np.array((0, -10, -1), np.int32)
    got = score(s1, s2, l1, l2, g, algo="ga", Lc=Lc, Lk=Lk)
    want = np.asarray(xla_dp.align_block(
        s1, s2, l1, l2, SUB_P, g, algo="ga", Lc=Lc, Lk=Lk
    ))
    np.testing.assert_array_equal(got, want)
