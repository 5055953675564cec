"""Verify a kill/resume soak output (see benchmarks/soak_resume.sh).

Checks <dir>/out.h5 against <dir>/in.csv using an INDEPENDENT pure-Python
Gotoh written here (not the package oracle), so an engine-wide bug cannot
self-certify:
  1. /sequences round-trips the input CSV (count + sampled exact).
  2. Sampled matrix entries match the independent Gotoh score — samples
     span both the resumed (pre-kill, low pair-block) range and the
     post-resume range.
  3. Matrix is symmetric at samples, zero diagonal.

Score model matches the reference CLI `-m nuc44 -a ga -s 10 -e 1`
(penalties negated, src/bio/align.c:127-128; Gotoh borders re-open from H,
src/bio/method/ga.c:26-67).  The base-pair table here is the public
match=5 / mismatch=-4 core of NUC4.4 — exact only for unambiguous ATGC,
which is all the soak generator emits.
"""
import csv
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # host-side checks only

import h5py  # noqa: E402
import numpy as np  # noqa: E402

OPN, EXT = 10, 1
TAB = {(a, b): (5 if a == b else -4) for a in "ATGC" for b in "ATGC"}


def gotoh(s1, s2):
    """Global affine alignment, reference border semantics (leading gap of
    length k costs OPN + (k-1)*EXT when EXT <= OPN, re-opening allowed)."""
    n, m = len(s1), len(s2)
    NEG = -(10**9)
    H = np.zeros(m + 1, np.int64)
    E = np.full(m + 1, NEG, np.int64)
    for j in range(1, m + 1):
        H[j] = -(OPN + (j - 1) * EXT)
    for i in range(1, n + 1):
        Hp = H.copy()
        H = np.empty(m + 1, np.int64)
        H[0] = -(OPN + (i - 1) * EXT)
        F = NEG
        row = s1[i - 1]
        for j in range(1, m + 1):
            E[j] = max(E[j] - EXT, Hp[j] - OPN)
            F = max(F - EXT, H[j - 1] - OPN)
            H[j] = max(Hp[j - 1] + TAB[(row, s2[j - 1])], E[j], F)
    return int(H[m])


def main(d):
    rows = list(csv.reader(open(os.path.join(d, "in.csv"))))[1:]
    seqs = [r[1] for r in rows]
    n = len(seqs)
    bad = 0
    with h5py.File(os.path.join(d, "out.h5"), "r") as f:
        hseqs = f["/sequences"][:]
        M = f["/similarity_matrix"]
        assert len(hseqs) == n, (len(hseqs), n)
        for k in (0, 1, 2, n // 40, n // 2, n - 1):
            got = hseqs[k].decode() if isinstance(hseqs[k], bytes) else str(hseqs[k])
            if got != seqs[k]:
                print("SEQ MISMATCH", k, got[:40], seqs[k][:40])
                bad += 1
        assert bad == 0, "sequence round-trip failed"
        print(f"sequences OK ({n} round-trip, 6 sampled exact)")

        rng = np.random.default_rng(7)
        picks = [(int(i), int(j)) for i, j in
                 zip(rng.integers(0, max(2, n // 500), 6),
                     rng.integers(n // 500, n // 100 + 2, 6))]
        picks += [(int(i), int(j)) for i, j in
                  zip(rng.integers(n // 2, n - 1, 6), rng.integers(0, n, 6))]
        # Length-asymmetric pairs: shortest x longest deciles cross BUCKET
        # combos with different band geometries — the class that exposed the
        # round-3 cross-band packing bug (a symmetric random sample has few).
        order = np.argsort([len(s) for s in seqs])
        lo, hi = order[: max(4, n // 10)], order[-max(4, n // 10):]
        picks += [(int(rng.choice(lo)), int(rng.choice(hi))) for _ in range(8)]
        for i, j in [(min(i, j), max(i, j)) for i, j in picks if i != j]:
            want = gotoh(seqs[i], seqs[j])
            got, gotT = int(M[i, j]), int(M[j, i])
            ok = got == want == gotT
            print(f"pair ({i:5d},{j:5d}) len({len(seqs[i])},{len(seqs[j])})"
                  f" h5={got} h5.T={gotT} gotoh={want} {'OK' if ok else 'MISMATCH'}")
            bad += 0 if ok else 1
        assert [int(M[k, k]) for k in (0, n // 3, n - 1)] == [0, 0, 0]
        print("diagonal OK")
    if bad:
        sys.exit(f"{bad} mismatches")
    print("SOAK VERIFY: ALL OK")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/soak")
